"""HAT's CAB conv chain with the channel-attention pool's sums: kernel B7 and its plain
version.

Twin of ``freqfusion_tpu/ops/pallas/cab.py:cab_chain``:

    u = conv3x3(GELU(conv3x3(LN1(x)) + b1)) + b2        both dense, SAME
    sums = sum of u over the image, [B,1,1,C]

and with ``out_shift = s`` the returned image is ``roll(u, (-s, -s), (1, 2))``, the roll
folded into the store; the sums are those of u either way. On a CUDA tensor the wrapper
launches the kernels from ``csrc/cab.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version. x [B,H,W,C] NHWC; w1 [3,3,C,mid], w2 [3,3,mid,C] HWIO; LayerNorm eps
1e-5. Every tensor float32, or every one bfloat16: then LN1(x) and GELU's output, the
convolutions' operands, are rounded to bf16 as the TPU kernel casts them (the weights are
bf16), the products accumulate in f32, u is stored in bf16 and its sums are f32. At float32
with bf16 operands (``mxu_dtype``, or precision "default": ``_mma.operand_dtype``) the same
operands and the weights are rounded to bf16 and u is stored in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import layernorm
from . import _build, _mma
from .conv3x3 import conv3x3_f32, padded_conv_weights

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"cab_chain": 0}


def cab_chain_plain(x, ln_w, ln_b, w1, b1, w2, b2, out_shift: int = 0, mxu_dtype=None):
    # SAME padding zeroes LN1(x), and again GELU(conv1 + b1): F.conv2d pads its own input
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    z = _mma.rnd(layernorm(*map(_mma.up, (x, ln_w, ln_b))), mdt)
    g = _mma.rnd(F.gelu(conv3x3_f32(z, _mma.rnd(w1, mdt), b1)), mdt)
    u = conv3x3_f32(g, _mma.rnd(w2, mdt), b2)
    sums = u.sum(dim=(1, 2), keepdim=True)
    u = u.to(dt)
    if out_shift:
        u = torch.roll(u, (-out_shift, -out_shift), dims=(1, 2))
    return u, sums


def _padded_weights(w1, b1, w2, b2):
    """(cinp, np1, mp, np2, w1p [9,cinp,np1], b1p [np1], w2p [9,mp,np2], b2p [np2]): the
    implicit-GEMM kernel takes channels in and out in multiples of 8, so the weights and
    biases are zero-padded; the intermediate is mp = np1 channels wide."""
    cinp, np1, w1p, b1p = padded_conv_weights(w1, b1)
    mp, np2, w2p, b2p = padded_conv_weights(w2, b2)
    return cinp, np1, mp, np2, w1p, b1p, w2p, b2p


def cab_chain(x, ln_w, ln_b, w1, b1, w2, b2, out_shift: int = 0, mxu_dtype=None):
    """Kernel B7 on CUDA, its plain version on the CPU. Returns (u [B,H,W,C] rolled by
    (-out_shift, -out_shift), sums [B,1,1,C]). `mxu_dtype`: the matmul operand dtype
    (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("cab_chain", x, ln_w, ln_b, w1, b1, w2, b2)
    _build.require_dtypes("cab_chain", x, ln_w, ln_b, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return cab_chain_plain(x, ln_w, ln_b, w1, b1, w2, b2, out_shift, mxu_dtype)
    b, h, w, c = x.shape
    mid = w1.shape[-1]
    if c % 4:
        raise ValueError(f"cab_chain: C={c} is not a multiple of 4")
    if not 0 <= out_shift < min(h, w):
        raise ValueError(f"cab_chain: out_shift={out_shift} outside [0, min(H, W)) at {h}x{w}")
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    _build.require(x, "x")
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)),
                           ("w1", w1, (3, 3, c, mid)), ("b1", b1, (mid,)),
                           ("w2", w2, (3, 3, mid, c)), ("b2", b2, (c,))):
        _build.require(t, name, shape)
    cinp, np1, mp, np2, w1p, b1p, w2p, b2p = _padded_weights(w1, b1, w2, b2)
    ln_w, ln_b = _mma.f32(ln_w), _mma.f32(ln_b)
    lib = _build.library()
    # GELU's output between the convolutions, in x's dtype (rounded to bf16 as an operand at
    # bf16 operands: the TPU kernel's cast)
    g = torch.empty((b, h, w, mp), device=x.device, dtype=x.dtype)
    u = torch.empty_like(x)
    part = torch.empty((b, lib.cab_chain_blocks(h, w), c), device=x.device,
                       dtype=torch.float32)
    sums = torch.empty((b, 1, 1, c), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.cab_chain(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1p.data_ptr(),
                            b1p.data_ptr(), w2p.data_ptr(), b2p.data_ptr(), g.data_ptr(),
                            u.data_ptr(), part.data_ptr(), sums.data_ptr(), b, h, w, c, cinp,
                            np1, mp, np2, out_shift, io, _build.stream_ptr(x.device))
    _build.check(err, "cab_chain")
    _build.count(launches, "cab_chain", (b, h, w, c, mid))
    return u, sums
