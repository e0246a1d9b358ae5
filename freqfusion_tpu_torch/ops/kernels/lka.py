"""The Large-Kernel-Attention gate: kernel B12 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/lka.py:lka_gate``:

    a   = dw21x1(dw1x21(dw5x5(x)))         depthwise, each stage SAME with zero padding
    out = x * sigmoid((a @ wp) * scale + shift)

Each stage pads its own input, so a stage's output counts as zero outside the image before
the next stage runs (three ``padding=`` convs in torch). x [B,H,W,C] NHWC f32; w5 [5,5,C];
wh [21,C] taps along W; wv [21,C] taps along H; wp [C,C] applied as ``a @ wp``; scale and
shift [C], the eval-mode BatchNorm folded into an affine.

On a CUDA tensor the wrapper launches the two kernels of ``csrc/lka.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version. The first kernel runs the three depthwise convs in
one pass and writes `a` once; the second runs the 1x1 product f32-exact on the tensor cores
(3xTF32, wp split once for each weight by ``_mma.planes``) with the BatchNorm, the sigmoid
and the gate in its epilogue. They take any batch and any C: above STAGED_MAX_C the product
reads `a` from device memory instead of staging it, with K in chunks whose partial sums stay
in registers.

x and every weight are float32, or all bfloat16: then the depthwise chain runs in f32 on the
bf16 values, `a` stays f32 until the product rounds it to bf16 (its operand dtype, as the
TPU kernel's on the TPU), the product accumulates in f32 and the output is rounded to bf16
once, at any C. At float32 with bf16 operands (``mxu_dtype``, or precision "default":
``_mma.operand_dtype``) the product's two operands, `a` and wp, are rounded to bf16 and the
rest stays f32: the TPU kernel casts only them (``lka.py:87``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, _mma

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"lka_gate": 0}

K = 21
#: Widest C whose 1x1 product stages `a` in shared memory (16 rows in each of two buffers,
#: csrc/lka.cu); wider rows take lka_mix_wide_kernel.
STAGED_MAX_C = 1808


def lka_gate_plain(x, w5, wh, wv, wp, scale, shift, mxu_dtype=None):
    c = x.shape[-1]
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    x, w5, wh, wv, wp, scale, shift = map(_mma.up, (x, w5, wh, wv, wp, scale, shift))
    a = x.permute(0, 3, 1, 2)
    a = F.conv2d(a, w5.permute(2, 0, 1).reshape(c, 1, 5, 5), padding=(2, 2), groups=c)
    a = F.conv2d(a, wh.t().reshape(c, 1, 1, K), padding=(0, K // 2), groups=c)
    a = F.conv2d(a, wv.t().reshape(c, 1, K, 1), padding=(K // 2, 0), groups=c)
    mixed = _mma.rnd(a.permute(0, 2, 3, 1), mdt) @ _mma.rnd(wp, mdt)
    return (x * torch.sigmoid(mixed * scale + shift)).to(dt)


def lka_gate(x, w5, wh, wv, wp, scale, shift, mxu_dtype=None):
    """Kernel B12 on CUDA, its plain version on the CPU. Returns [B,H,W,C]. `mxu_dtype`: the
    1x1 product's operand dtype (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("lka_gate", x, w5, wh, wv, wp, scale, shift)
    _build.require_dtypes("lka_gate", x, w5, wh, wv, wp, scale, shift)
    if x.device.type == "cpu":
        return lka_gate_plain(x, w5, wh, wv, wp, scale, shift, mxu_dtype)
    if x.dim() != 4:
        raise ValueError(f"lka_gate: expected [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    _build.require(x, "x")
    for name, t, shape in (("w5", w5, (5, 5, c)), ("wh", wh, (K, c)), ("wv", wv, (K, c)),
                           ("scale", scale, (c,)), ("shift", shift, (c,))):
        _build.require(t, name, shape)
    # laid out anew: a view will do
    _build.require(wp, "wp", (c, c), contiguous=False)
    # the product takes K in steps of 8 and N in a warp's tasks of 32 columns
    kp, npad = -(-c // 8) * 8, -(-c // 32) * 32
    wpp = _mma.planes(wp, kp, npad, io == 2)
    w5, wh, wv, scale, shift = map(_mma.f32, (w5, wh, wv, scale, shift))
    lib = _build.library()
    a = torch.empty(x.shape, device=x.device, dtype=torch.float32)   # the chain's output
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.lka_gate(x.data_ptr(), w5.data_ptr(), wh.data_ptr(), wv.data_ptr(),
                           wpp.data_ptr(), scale.data_ptr(), shift.data_ptr(), a.data_ptr(),
                           out.data_ptr(), b, h, w, c, kp, npad, io,
                           _build.stream_ptr(x.device))
    _build.check(err, "lka_gate")
    _build.count(launches, "lka_gate", (b, h, w, c))
    return out
