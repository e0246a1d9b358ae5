"""Rank functions of ``tests/test_torch_parallel.py`` and ``tests/test_torch_kernels_cuda.py``,
in a module of their own so that the spawned ranks import them without JAX. Each runs over
``gloo`` (``n`` ranks; on one card, sharing it) or, called with ``n = 1``, in the calling
process: the one-process reference."""

import contextlib

import numpy as np
import torch

from freqfusion_tpu_torch.losses import CombinedLoss
from freqfusion_tpu_torch.models import layers
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig, FusionHead
from freqfusion_tpu_torch.parallel.mesh import make_mesh, shard_batch
from freqfusion_tpu_torch.training.steps import (make_frozen_expert_optimizer,
                                                 make_live_train_step, make_optimizer,
                                                 make_train_step)

WEIGHTS = {"l1": 0.6, "swt": 0.25, "fft": 0.1, "edge": 0.05, "ssim": 0.05}
TINY = dict(fusion_dim=16, num_heads=2, refine_depth=2, refine_channels=16)
# the live step's tiny experts (one stage each)
LIVE_EXPERTS = dict(
    hat_kwargs=dict(embed_dim=24, depths=(1,), num_heads=(4,), window=8, compress=3,
                    squeeze=6, conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16),
    dat_kwargs=dict(embed_dim=32, depths=(1,), num_heads=(4,), split_size=(4, 16),
                    expansion=2.0),
    nafnet_kwargs=dict(width=8, middle_blk_num=1, enc_blk_nums=(1,), dec_blk_nums=(1,)))


@contextlib.contextmanager
def recorded_dropout(on: bool, masks: list):
    """``layers.dropout`` recording each call's kept elements (`on`), or the identity."""
    real = layers.dropout

    def recording(x, p, training):
        y = real(x, p, training)
        if training and p:
            masks.append(y != 0)
        return y

    layers.dropout = recording if on else (lambda x, p, training: x)
    try:
        yield
    finally:
        layers.dropout = real


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}


def _mesh(n, device):
    torch.set_num_threads(2)
    return make_mesh(n, device, "gloo" if n > 1 else None, timeout_s=60)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def cached_steps(rank, n, cfg, state, batches, lr, dropout_on, seed=0, dtype=torch.float64,
                 device="cpu"):
    """Cached steps of a FusionHead(FusionConfig(**cfg)) from `state` in `dtype`, one a
    global batch of `batches`: [(metrics, gradients)], the state after, the dropout masks
    (on the CPU)."""
    mesh = _mesh(n, device)
    head = FusionHead(FusionConfig(**cfg)).to(mesh.device, dtype)
    head.load_state_dict(state)
    opt = make_optimizer(head, lambda count: lr, 1e-4, 1.0, 1)
    step = make_train_step(head, CombinedLoss(WEIGHTS), opt, mesh)
    gen = torch.Generator(mesh.device).manual_seed(seed)
    out, masks = [], []
    with recorded_dropout(dropout_on, masks):
        for batch in batches:
            m = step(_cast(shard_batch(batch, mesh), dtype), gen)
            out.append(({k: float(v) for k, v in m.items()}, _grads(head)))
    return _cpu((out, head.state_dict(), masks))


def live_steps(rank, n, cfg, state, batches, lr, seed=0, dtype=torch.float64):
    """Live steps of a tiny FreqFusionSR from `state` in `dtype`: [(metrics, head
    gradients)], the state after, the dropout masks."""
    mesh = _mesh(n, "cpu")
    model = FreqFusionSR(FusionConfig(**cfg), **LIVE_EXPERTS).to(dtype)
    model.load_state_dict(state)
    opt = make_frozen_expert_optimizer(model, lambda count: lr, 1e-4, 1.0, 1)
    step = make_live_train_step(model, CombinedLoss(WEIGHTS), opt, mesh)
    gen = torch.Generator().manual_seed(seed)
    out, masks = [], []
    with recorded_dropout(True, masks):
        for batch in batches:
            m = step(_cast(shard_batch(batch, mesh), dtype), gen)
            out.append(({k: float(v) for k, v in m.items()}, _grads(model.fusion)))
    return out, model.state_dict(), masks


def head_batch(h, w, seed, b=4):
    """A global batch of b for the head (numpy): lr, the experts' outputs (lr upsampled
    with noise) and features, hr."""
    rng = np.random.default_rng(seed)
    lr = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    up = np.kron(lr, np.ones((1, 4, 4, 1), np.float32))
    outs = {n: np.clip(up + 0.1 * rng.standard_normal(up.shape), 0, 1).astype(np.float32)
            for n in ("hat", "dat", "nafnet")}
    feats = {n: rng.standard_normal((b, h, w, c)).astype(np.float32)
             for n, c in (("hat", 180), ("dat", 180), ("nafnet", 64))}
    hr = np.clip(outs["hat"] + 0.05 * rng.standard_normal(up.shape), 0, 1).astype(np.float32)
    return {"lr": lr, "expert_outputs": outs, "expert_features": feats, "hr": hr}


def double(state):
    return {k: v.double() if v.is_floating_point() else v for k, v in state.items()}


def hold(one, two, n=2):
    """Each rank's steps, state and masks (`two`) against one process's (`one`): loss and
    grad_norm within 1e-5 relative, each leaf's gradient within 1e-5 x its max|g|, the
    parameters and BatchNorm statistics within 1e-6, the dropout masks equal (each rank's
    the rows of one process's)."""
    (steps1, state1, masks1) = one
    for rank, (steps2, state2, masks2) in enumerate(two):
        for (m1, g1), (m2, g2) in zip(steps1, steps2):
            assert sorted(m1) == sorted(m2)
            for k in ("total", "grad_norm"):
                assert abs(m2[k] - m1[k]) <= 1e-5 * abs(m1[k]), (rank, k, m1[k], m2[k])
            assert sorted(g1) == sorted(g2)
            for k, g in g1.items():
                assert float((g2[k] - g).abs().max()) <= 1e-5 * float(g.abs().max()), (rank, k)
        assert sorted(state1) == sorted(state2)
        for k, v in state1.items():   # parameters and BatchNorm statistics
            bound = 1e-6 if v.is_floating_point() else 0
            assert float((state2[k].double() - v.double()).abs().max()) <= bound, (rank, k)
        assert any(k.endswith("running_var") for k in state1)
        assert len(masks1) == len(masks2)
        for a, b in zip(masks1, masks2):
            per = a.shape[0] // n
            assert torch.equal(a[rank * per:(rank + 1) * per], b)
