"""Seeded weights: one uniform draw on the device for every parameter and BatchNorm statistic.

Each leaf gets ``center + half * u`` with u uniform in [-1, 1) from one ``torch.Generator``
call: biases center 0, half 0.1; a leaf its constructor fills with one value c (norm weights,
residual scales, temperatures) center c, half 0.1 |c| (0.1 for c = 0); any other leaf
center 0 and half the largest magnitude of its constructor's draw (the layer's own init
bound); running means center 0, half 0.1; running variances center 1, half 0.5. The plan of
centers and halves comes from the model as constructed, so the same seed gives the same
weights, and the reference gets them from ``make`` again after the program is freed.
"""

from __future__ import annotations

import math

import torch


def plan(model: torch.nn.Module):
    """[(name, shape, center, half)] for every float parameter and BatchNorm statistic, in
    state-dict order, from the model as its constructor left it."""
    params = dict(model.named_parameters())
    names, ranges = [], []
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        names.append((name, tuple(t.shape)))
        ranges.append(torch.stack([t.detach().amin(), t.detach().amax()]).float())
    lo_hi = torch.stack(ranges).cpu().tolist()
    out = []
    for (name, shape), (lo, hi) in zip(names, lo_hi):
        leaf = name.rsplit(".", 1)[-1]
        if name not in params:
            center, half = (1.0, 0.5) if leaf == "running_var" else (0.0, 0.1)
        elif leaf.endswith("bias"):
            center, half = 0.0, 0.1
        elif lo == hi:
            center, half = lo, (0.1 * abs(lo) if lo else 0.1)
        else:
            center, half = 0.0, max(abs(lo), abs(hi))
        out.append((name, shape, center, half))
    return out


def make(leaves, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} on `device` from `seed`: float32 values, rounded to `dtype` (the dtype
    they are served in) and held as float32 views of one buffer."""
    sizes = [math.prod(s) for _, s, _, _ in leaves]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    views = list(flat.split(sizes))
    torch._foreach_mul_(views, [h for _, _, _, h in leaves])
    torch._foreach_add_(views, [c for _, _, c, _ in leaves])
    if dtype != torch.float32:
        flat.copy_(flat.to(dtype))
    return {name: v.view(shape) for (name, shape, _, _), v in zip(leaves, views)}


def load(model: torch.nn.Module, weights: dict) -> None:
    """Copies `weights` into the model's parameters and statistics (in their dtype)."""
    sd = model.state_dict()
    dst = [sd[k] for k in weights]
    torch._foreach_copy_(dst, [weights[k].to(d.dtype) for k, d in zip(weights, dst)])

