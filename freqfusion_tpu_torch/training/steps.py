"""The optimizer and the train and eval steps of fusion-head training. Twin of
``freqfusion_tpu/training/steps.py``.

``OptaxAdamW`` is the JAX package's optimizer chain, written out for torch tensors so that
one gradient gives the same update: ``optax.MultiSteps`` (the running mean of
``accum_steps`` mini-step gradients, then one update) around ``clip_by_global_norm``
(g kept where ||g|| < clip, else g / ||g|| * clip) and ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay on every parameter, biases and BatchNorm affines included). The
learning rate of update n is ``schedule(n)``: the schedule counts optimizer updates, not
mini-steps, from 0.

The cached step trains the ``FusionHead`` from cached expert outputs and features; the live
step runs the whole ``FreqFusionSR``, whose experts stay in eval mode, frozen and outside
the optimizer (they run under ``torch.no_grad()`` inside ``FreqFusionSR.forward``, so their
kernels launch and no gradient reaches them). In train mode the head runs plain torch ops;
the eval steps run it in eval mode under ``torch.no_grad()``, where its band attention and
LKA gate launch kernels B11 and B12 on the card.

Every step takes a ``parallel.mesh.Mesh`` (None: one process). On a mesh of several ranks
each rank steps on its rows of the global batch, with the batch-coupled ops over the global
batch (``parallel.mesh.active``: BatchNorm statistics, dropout masks, the adaptive-band
mean); the trained module's gradients are averaged over the ranks before the optimizer
(whose clip then sees the global batch's gradient, as XLA's psum comes before optax's
clip), and the loss components are averaged too, so that every rank reports and applies
what one process would at the same global batch. Live mode averages the head's gradients
only: the experts stay frozen and replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..losses import CombinedLoss
from ..models.layers import dropout_generator
from ..parallel.mesh import Mesh, active, all_reduce_mean

# optax.adamw's moments and epsilon, as the JAX package's make_optimizer leaves them
B1, B2, EPS = 0.9, 0.999, 1e-8


class OptaxAdamW(torch.optim.Optimizer):
    """clip_by_global_norm -> adamw, inside MultiSteps(every_k = accum_steps), as optax.

    Counters live in the (single) parameter group, so that ``state_dict`` holds them:
    ``mini_step`` (0 .. accum_steps - 1) and ``count`` (updates made; the schedule's
    argument). The per-parameter state holds ``mu``, ``nu`` and the accumulated gradient."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, clip_norm: float = 1.0, accum_steps: int = 1):
        defaults = dict(weight_decay=weight_decay, clip_norm=clip_norm, accum_steps=accum_steps,
                        mini_step=0, count=0)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("OptaxAdamW takes one parameter group")
        self.schedule = schedule

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        k, mini = group["accum_steps"], group["mini_step"]
        accs = []
        for p in params:
            st = self.state[p]
            if not st:
                st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
                st["acc"] = torch.zeros_like(p)
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st["acc"].add_((g - st["acc"]) / (mini + 1))   # Welford mean, as MultiSteps
            accs.append(st["acc"])
        if mini < k - 1:
            group["mini_step"] = mini + 1
            return None
        gnorm = torch.sqrt(sum((a * a).sum() for a in accs))
        clip = group["clip_norm"]
        scale = None if gnorm < clip else clip / gnorm
        count = group["count"] + 1
        wd = group["weight_decay"]
        c1, c2 = 1 - B1 ** count, 1 - B2 ** count
        lr = self.schedule(group["count"])
        for p, acc in zip(params, accs):
            st = self.state[p]
            g = acc if scale is None else acc / gnorm * clip
            st["mu"].mul_(B1).add_(g, alpha=1 - B1)
            st["nu"].mul_(B2).add_(g * g, alpha=1 - B2)
            u = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + EPS)
            p.add_(u + wd * p, alpha=-lr)
            acc.zero_()
        group["mini_step"], group["count"] = 0, count
        return None


def make_optimizer(module: nn.Module, lr_schedule: Callable[[int], float],
                   weight_decay: float = 1e-4, clip_norm: float = 1.0,
                   accum_steps: int = 1) -> OptaxAdamW:
    """The optimizer over every parameter of `module` (the fusion head)."""
    return OptaxAdamW(module.parameters(), lr_schedule, weight_decay, clip_norm, accum_steps)


def make_frozen_expert_optimizer(model: nn.Module, lr_schedule: Callable[[int], float],
                                 weight_decay: float = 1e-4, clip_norm: float = 1.0,
                                 accum_steps: int = 1) -> OptaxAdamW:
    """Live mode: the experts are frozen (``requires_grad_(False)``, outside the optimizer,
    so that no update and no weight decay ever reaches them); the head trains."""
    model.experts.requires_grad_(False)
    return make_optimizer(model.fusion, lr_schedule, weight_decay, clip_norm, accum_steps)


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm of the parameters' gradients."""
    return torch.sqrt(sum((p.grad * p.grad).sum() for p in params if p.grad is not None))


def _train_mode(model: nn.Module) -> None:
    model.train()
    experts = getattr(model, "experts", None)
    if experts is not None:   # frozen: BatchNorm statistics, dropout and kernels as served
        experts.eval()


def _step(model, trained: nn.Module, criterion, optimizer, forward, batch,
          generator: Optional[torch.Generator], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    _train_mode(model)
    with active(mesh), dropout_generator(generator):
        sr = forward(batch).clamp(0.0, 1.0)
    total, components = criterion(sr, batch["hr"])
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    metrics = {k: v.detach() for k, v in components.items()}
    if mesh is not None and mesh.size > 1:
        all_reduce_mean([p.grad for p in trained.parameters() if p.grad is not None], mesh)
        metrics = all_reduce_mean(metrics, mesh)
    metrics["grad_norm"] = global_norm(trained.parameters()).detach()
    optimizer.step()
    return metrics


def make_train_step(model: nn.Module, criterion: CombinedLoss, optimizer: OptaxAdamW,
                    mesh: Optional[Mesh] = None):
    """Cached mode: step(batch, generator=None) -> metrics (the loss components, ``total``
    and ``grad_norm`` of the unclipped gradients). `batch` holds lr, hr, expert_outputs and,
    optionally, expert_features, on the model's device (on a mesh: this rank's rows);
    `generator` draws the dropout."""
    def forward(batch):
        return model(batch["lr"], batch["expert_outputs"], batch.get("expert_features"))

    def step(batch, generator: Optional[torch.Generator] = None):
        return _step(model, model, criterion, optimizer, forward, batch, generator, mesh)

    return step


def make_live_train_step(model: nn.Module, criterion: CombinedLoss, optimizer: OptaxAdamW,
                         mesh: Optional[Mesh] = None):
    """Live mode, model a ``FreqFusionSR``: step(batch {lr, hr}, generator=None) -> metrics.
    The experts run in eval mode under ``torch.no_grad()``; their features feed the head's
    collaborative branch."""
    def forward(batch):
        return model(batch["lr"], with_features=True)

    def step(batch, generator: Optional[torch.Generator] = None):
        return _step(model, model.fusion, criterion, optimizer, forward, batch, generator,
                     mesh)

    return step


def make_eval_step(model: nn.Module, mesh: Optional[Mesh] = None):
    """Cached mode: step(batch) -> clamp(head(lr, outputs, features)) in eval mode (on a
    mesh, this rank's rows; a batch mean is the global batch's)."""
    @torch.no_grad()
    def step(batch):
        model.eval()
        with active(mesh):
            return model(batch["lr"], batch["expert_outputs"],
                         batch.get("expert_features")).clamp(0.0, 1.0)

    return step


def make_live_eval_step(model: nn.Module, mesh: Optional[Mesh] = None):
    """Live mode: step(batch) -> clamp(FreqFusionSR(lr)) in eval mode, without features, as
    served."""
    @torch.no_grad()
    def step(batch):
        model.eval()
        with active(mesh):
            return model(batch["lr"]).clamp(0.0, 1.0)

    return step
