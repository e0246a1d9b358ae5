"""Model summary: parameter counts and FLOPs. Twin of ``freqfusion_tpu/utils/summary.py``.

The JAX twin asks XLA for the cost of the compiled program; eager PyTorch compiles
nothing, so the count here comes from ``torch.utils.flop_counter.FlopCounterMode`` over one
call (see ``flop_cost`` for what it counts where XLA counts otherwise).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def params_breakdown(module: nn.Module, depth: int = 1) -> Dict[str, int]:
    """Parameter count by the first `depth` components of each parameter's name
    (``layers.0`` at depth 2), largest first."""
    out: Dict[str, int] = {}
    for name, p in module.named_parameters():
        key = ".".join(name.split(".")[:depth])
        out[key] = out.get(key, 0) + p.numel()
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


def flop_cost(fn: Callable, *example_args) -> Dict[str, float]:
    """One call of ``fn(*example_args)`` without autograd -> {"flops", "bytes accessed"}.

    "flops" is FlopCounterMode's count: 2 x the multiply-adds of every matrix product,
    convolution and attention product, and nothing for elementwise work, normalisation,
    reductions or bias additions, which XLA's cost analysis counts one FLOP an element.
    "bytes accessed" is the bytes of the tensors among the arguments (parameters of a
    module the call closes over are not seen) and of the result, each once; XLA counts
    every operand and result of the compiled program after fusion."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": float(_tensor_bytes(example_args) + _tensor_bytes(out))}


def summarize(fn: Callable, module: nn.Module, *example_args) -> Tuple[str, Dict]:
    n = count_params(module)
    cost = flop_cost(fn, *example_args)
    lines = [f"params: {n / 1e6:.2f}M", f"flops/step: {cost['flops'] / 1e9:.2f} GFLOP",
             f"bytes/step: {cost['bytes accessed'] / 1e6:.1f} MB"]
    return "\n".join(lines), {"params": n, **cost}
