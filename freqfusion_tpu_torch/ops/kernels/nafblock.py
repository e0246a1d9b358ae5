"""The fused NAFBlock: kernels B1 (stage A) and B2 (stage B), with their plain versions.

Twin of ``freqfusion_tpu/ops/pallas/nafblock.py``. On a CUDA tensor each wrapper launches
its kernel from ``csrc/nafblock.cu`` or raises; on a CPU tensor it runs the plain PyTorch
version, which computes the same math. There is no fallback from one to the other.

Layouts (NHWC, f32): x, g [B,H,W,C]; w1, w4 [C,2C]; w3, w5 [C,C]; wdw [9,2C] (the 3x3
depthwise taps, row dy*3+dx); every other parameter a vector.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import channel_layernorm
from . import _build

#: Kernel launches since the last reset, by kernel. Plain runs are not counted.
launches = {"naf_block_stage_a": 0, "naf_block_stage_b": 0}


def _gate(t: torch.Tensor) -> torch.Tensor:
    a, b = t.chunk(2, dim=-1)
    return a * b


def naf_block_stage_a_plain(x, ln_w, ln_b, w1, b1, wdw, bdw):
    """x [B,H,W,C] → (g [B,H,W,C], sums [B,C] = Σ_{H,W} g)."""
    t = channel_layernorm(x, ln_w, ln_b) @ w1 + b1
    dw = t.shape[-1]
    # SAME padding zeroes t, the depthwise conv's input, not x
    t = F.conv2d(t.permute(0, 3, 1, 2), wdw.t().reshape(dw, 1, 3, 3), bdw,
                 padding=1, groups=dw).permute(0, 2, 3, 1)
    g = _gate(t).contiguous()
    return g, g.sum(dim=(1, 2))


def naf_block_stage_b_plain(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5,
                            gamma):
    """Pointwise second half; att [B,C]. Returns the block output [B,H,W,C]."""
    y = x + ((g * att[:, None, None, :]) @ w3 + b3) * beta
    h = _gate(channel_layernorm(y, ln2_w, ln2_b) @ w4 + b4)
    return y + (h @ w5 + b5) * gamma


def naf_block_stage_a(x, ln_w, ln_b, w1, b1, wdw, bdw):
    """Kernel B1 on CUDA, its plain version on the CPU. Returns (g, sums [B,C])."""
    _build.require_no_grad("naf_block_stage_a", x, ln_w, ln_b, w1, b1, wdw, bdw)
    if x.device.type == "cpu":
        return naf_block_stage_a_plain(x, ln_w, ln_b, w1, b1, wdw, bdw)
    b, h, w, c = x.shape
    if c % 64:
        raise ValueError(f"naf_block_stage_a: C={c} is not a multiple of 64")
    _build.require(x, "x")
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)),
                           ("w1", w1, (c, 2 * c)), ("b1", b1, (2 * c,)),
                           ("wdw", wdw, (9, 2 * c)), ("bdw", bdw, (2 * c,))):
        _build.require(t, name, shape)
    lib = _build.library()
    g = torch.empty_like(x)
    part = torch.empty((b, lib.naf_stage_a_blocks(h, w), c), device=x.device,
                       dtype=torch.float32)
    sums = torch.empty((b, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.naf_stage_a(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                              w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(),
                              bdw.data_ptr(), g.data_ptr(), part.data_ptr(),
                              sums.data_ptr(), b, h, w, c,
                              _build.stream_ptr(x.device))
    _build.check(err, "naf_stage_a")
    launches["naf_block_stage_a"] += 1
    return g, sums


def naf_block_stage_b(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5, gamma):
    """Kernel B2 on CUDA, its plain version on the CPU."""
    _build.require_no_grad("naf_block_stage_b", g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4,
                           w5, b5, gamma)
    if g.device.type == "cpu":
        return naf_block_stage_b_plain(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4,
                                       w5, b5, gamma)
    b, h, w, c = g.shape
    if c % 64:
        raise ValueError(f"naf_block_stage_b: C={c} is not a multiple of 64")
    _build.require(g, "g")
    _build.require(x, "x", g.shape)
    _build.require(att, "att", (b, c))
    for name, t, shape in (("w3", w3, (c, c)), ("b3", b3, (c,)), ("beta", beta, (c,)),
                           ("ln2_w", ln2_w, (c,)), ("ln2_b", ln2_b, (c,)),
                           ("w4", w4, (c, 2 * c)), ("b4", b4, (2 * c,)),
                           ("w5", w5, (c, c)), ("b5", b5, (c,)),
                           ("gamma", gamma, (c,))):
        _build.require(t, name, shape)
    lib = _build.library()
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = lib.naf_stage_b(g.data_ptr(), x.data_ptr(), att.data_ptr(), w3.data_ptr(),
                              b3.data_ptr(), beta.data_ptr(), ln2_w.data_ptr(),
                              ln2_b.data_ptr(), w4.data_ptr(), b4.data_ptr(),
                              w5.data_ptr(), b5.data_ptr(), gamma.data_ptr(),
                              out.data_ptr(), b, h, w, c, _build.stream_ptr(g.device))
    _build.check(err, "naf_stage_b")
    launches["naf_block_stage_b"] += 1
    return out


def _att(sums, hw, sca_w, sca_b):
    # the [B,C]x[C,C] SCA product between the stages stays torch, as it stays XLA in JAX
    return (sums / hw) @ sca_w + sca_b


def fused_naf_block(x, p):
    """The whole NAFBlock: stage A, the SCA product, stage B.

    `p` holds ln1_w, ln1_b, w1, b1, wdw, bdw, sca_w [C,C], sca_b, w3, b3, beta, ln2_w,
    ln2_b, w4, b4, w5, b5, gamma in the layouts of the module docstring."""
    g, sums = naf_block_stage_a(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"], p["wdw"],
                                p["bdw"])
    att = _att(sums, x.shape[1] * x.shape[2], p["sca_w"], p["sca_b"])
    return naf_block_stage_b(g, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"],
                             p["ln2_b"], p["w4"], p["b4"], p["w5"], p["b5"], p["gamma"])


def fused_naf_block_plain(x, p):
    """fused_naf_block through the plain versions on any device."""
    g, sums = naf_block_stage_a_plain(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"],
                                      p["wdw"], p["bdw"])
    att = _att(sums, x.shape[1] * x.shape[2], p["sca_w"], p["sca_b"])
    return naf_block_stage_b_plain(g, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"],
                                   p["ln2_b"], p["w4"], p["b4"], p["w5"], p["b5"],
                                   p["gamma"])
