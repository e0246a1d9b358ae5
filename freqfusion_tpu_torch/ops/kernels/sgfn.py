"""The fused DAT block tail, residual + LayerNorm + Spatial-Gate FFN: kernel B6 and its
plain version.

Twin of ``freqfusion_tpu/ops/pallas/sgfn.py:fused_sgfn_tail``:

    y = a + shortcut
    [x1, x2] = split(GELU(LN(y) @ w1 + b1))          hidden -> two halves
    out = y + (x1 * dwconv3x3(LN_sg(x2))) @ w2 + b2

On a CUDA tensor the wrapper launches its kernels (``csrc/hat_rows.cu``'s fc1 and
``csrc/sgfn.cu``'s gate + fc2, both f32-exact on the tensor cores in 3xTF32) or raises; on a
CPU tensor it runs the plain PyTorch version. Parameters come in the JAX package's layouts:
w1 [C,hidden], w2 [hidden/2,C] as [in,out]; wdw (3,3,1,hidden/2) HWIO. Both LayerNorms
use eps 1e-5. Every tensor of a call float32, or every one bfloat16: then LN(y) and the
gate, the products' operands, are rounded to bf16 as the TPU kernel casts them, and y, the
hidden and the accumulation stay f32 (the kernel parks y in an f32 scratch at bf16). At
float32 with bf16 operands (``mxu_dtype``, or precision "default": ``_mma.operand_dtype``)
the same operands and the weights are rounded to bf16, and every tensor stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import layernorm
from . import _build, _mma
from .aim import depthwise3x3_plain

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_sgfn_tail": 0}


def fused_sgfn_tail_plain(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2,
                          mxu_dtype=None):
    dt = a.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2 = map(
        _mma.up, (a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2))
    y = a + shortcut
    x1, x2 = F.gelu(_mma.rnd(layernorm(y, ln_w, ln_b), mdt) @ _mma.rnd(w1, mdt)
                    + b1).chunk(2, dim=-1)
    # SAME padding zeroes LN_sg(x2), the depthwise conv's input, not x2 or y
    x2 = depthwise3x3_plain(layernorm(x2, sg_w, sg_b), wdw, bdw)
    return (y + _mma.rnd(x1 * x2, mdt) @ _mma.rnd(w2, mdt) + b2).to(dt)


def _widths(c: int, hid: int) -> tuple[int, int, int]:
    """(kp, k2p, npad): fc1's K, fc2's K and N. The tensor-core products take K and N in
    multiples of 8, so the weights are zero-padded (C = 180 -> 184; hid/2 = 360 stays)."""
    return -(-c // 8) * 8, -(-(hid // 2) // 8) * 8, -(-c // 8) * 8


def fused_sgfn_tail(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2,
                    mxu_dtype=None):
    """Kernel B6 on CUDA, its plain version on the CPU. Returns [B,H,W,C]. Two launches:
    fc1 with both LayerNorms (csrc/hat_rows.cu's row product), then the gate and fc2
    (csrc/sgfn.cu); the hidden passes through device memory once. `mxu_dtype`: the matmul
    operand dtype (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("fused_sgfn_tail", a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw,
                           bdw, w2, b2)
    _build.require_dtypes("fused_sgfn_tail", a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw,
                          bdw, w2, b2)
    if a.device.type == "cpu":
        return fused_sgfn_tail_plain(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw,
                                     w2, b2, mxu_dtype)
    fc1, gate_fc2, out = _sgfn_launchers(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw,
                                         bdw, w2, b2, mxu_dtype)
    fc1()
    gate_fc2()
    _build.count(launches, "fused_sgfn_tail", (*a.shape, w1.shape[-1]))
    return out


def _sgfn_launchers(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2,
                    mxu_dtype=None):
    """Checks B6's CUDA arguments and lays out its weights; returns (fc1, gate_fc2, out): two
    functions that each launch one half on the current stream (the second reads the hidden
    and the parked y that the first wrote) and the output they fill. ``fused_sgfn_tail``
    calls both; a caller may time them apart."""
    b, h, w, c = a.shape
    hid = w1.shape[-1]
    half = hid // 2
    if c % 4 or half % 4 or 2 * half != hid:
        raise ValueError(f"fused_sgfn_tail: C={c} and hidden/2={hid / 2} must be multiples "
                         "of 4")
    io = _build.io_code(a, "a", mxu_dtype)
    _build.require(a, "a")
    _build.require(shortcut, "shortcut", a.shape)
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)),
                           ("b1", b1, (hid,)), ("sg_w", sg_w, (half,)), ("sg_b", sg_b, (half,)),
                           ("wdw", wdw, (3, 3, 1, half)), ("bdw", bdw, (half,)),
                           ("b2", b2, (c,))):
        _build.require(t, name, shape)
    # w1 and w2 are re-laid out once (_mma.planes): a view will do
    _build.require(w1, "w1", (c, hid), contiguous=False)
    _build.require(w2, "w2", (half, c), contiguous=False)
    kp, k2p, npad = _widths(c, hid)
    w1p, w2p = _mma.planes(w1, kp, hid, io == 2), _mma.planes(w2, k2p, npad, io == 2)
    ln_w, ln_b, b1, sg_w, sg_b, wdw, bdw, b2 = map(
        _mma.f32, (ln_w, ln_b, b1, sg_w, sg_b, wdw, bdw, b2))
    lib = _build.library()
    hidden = torch.empty((b, h, w, hid), device=a.device, dtype=torch.float32)
    out = torch.empty_like(a)
    # y between the launches: f32 scratch at bf16 (out holds it at f32)
    y = torch.empty(a.shape, device=a.device, dtype=torch.float32) if io == 1 else None
    yp = None if y is None else y.data_ptr()

    grid = _mma.row_grid(b * h * w, _mma.sm_count(a.device))

    def fc1():
        with torch.cuda.device(a.device):
            err = lib.rows_ln_fc1(a.data_ptr(), shortcut.data_ptr(), ln_w.data_ptr(),
                                  ln_b.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                                  sg_w.data_ptr(), sg_b.data_ptr(), hidden.data_ptr(),
                                  out.data_ptr(), yp, b * h * w, c, hid, kp, hid, grid, io,
                                  _build.stream_ptr(a.device))
        _build.check(err, "rows_ln_fc1")

    def gate_fc2():
        with torch.cuda.device(a.device):
            err = lib.sgfn_gate_fc2(hidden.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
                                    w2p.data_ptr(), b2.data_ptr(), out.data_ptr(), yp, b, h,
                                    w, c, half, k2p, npad, io, _build.stream_ptr(a.device))
        _build.check(err, "sgfn_gate_fc2")

    return fc1, gate_fc2, out
