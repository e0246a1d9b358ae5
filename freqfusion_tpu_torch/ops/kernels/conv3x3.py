"""Dense 3x3 SAME convolution: kernel B3 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/cab.py:conv3x3_dense``. On a CUDA tensor the wrapper
launches the kernel from ``csrc/conv3x3.cu`` or raises; on a CPU tensor it runs the plain
version (``F.conv2d``). x [B,H,W,Cin] NHWC, w [3,3,Cin,Cout] HWIO, b [Cout]; f32. With both
widths at 32 or more the source's implicit-GEMM kernel runs (HAT's and DAT's 180 -> 180,
f32-exact 3xTF32 on the tensor cores), on weights that the wrapper zero-pads to multiples
of 8 channels in and out, the MMA's k and n (``padded_conv_weights``). x, w and b are all
float32 or all bfloat16; at bfloat16 the products take the bf16 values, accumulate in f32 and
the output is rounded to bf16 once (the TPU kernel's bf16 operands). At float32 with bf16
operands (``mxu_dtype``, or precision "default": ``_mma.operand_dtype``) x and w are rounded
to bf16 as operands, in every case (the narrow CUDA-core ones too, as ``cab.py:276`` casts
them), and the output stays f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build, _mma

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"conv3x3_dense": 0}


def conv3x3_f32(x, w, b):
    """The convolution on the values of x, w and b, bf16 taken to f32, unrounded."""
    x, w, b = map(_mma.up, (x, w, b))
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_dense_plain(x, w, b, mxu_dtype=None):
    mdt = _mma.operand_dtype(x.dtype, mxu_dtype)
    return conv3x3_f32(_mma.rnd(x, mdt), _mma.rnd(w, mdt), b).to(x.dtype)


def padded_conv_weights(w, b):
    """(cinp, npad, w [9,cinp,npad], b [npad]): HWIO weights [3,3,Cin,Cout] and their bias
    zero-padded to multiples of 8 in and out for the implicit-GEMM kernel, in float32 (a bf16
    weight's values exactly); padded zeros change nothing."""
    cin, cout = w.shape[2], w.shape[3]
    cinp, npad = -(-cin // 8) * 8, -(-cout // 8) * 8
    return (cinp, npad,
            F.pad(_mma.up(w).reshape(9, cin, cout), (0, npad - cout, 0, cinp - cin)),
            F.pad(_mma.up(b), (0, npad - cout)))


def conv3x3_dense(x, w, b, mxu_dtype=None):
    """Kernel B3 on CUDA, its plain version on the CPU. `mxu_dtype`: the matmul operand
    dtype (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("conv3x3_dense", x, w, b)
    _build.require_dtypes("conv3x3_dense", x, w, b)
    if x.device.type == "cpu":
        return conv3x3_dense_plain(x, w, b, mxu_dtype)
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    _build.require(x, "x")
    _build.require(w, "w", (3, 3, cin, cout))
    _build.require(b, "b", (cout,))
    lib = _build.library()
    wpad, bpad, cinp, npad = None, None, 0, 0
    if lib.conv3x3_dense_is_wide(cin, cout):
        cinp, npad, wpad, bpad = padded_conv_weights(w, b)
    w, b = _mma.f32(w), _mma.f32(b)
    out = torch.empty((bsz, h, wd, cout), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_dense(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                bsz, h, wd, cin, cout,
                                0 if wpad is None else wpad.data_ptr(),
                                0 if bpad is None else bpad.data_ptr(), cinp, npad, io,
                                _build.stream_ptr(x.device))
    _build.check(err, "conv3x3_dense")
    _build.count(launches, "conv3x3_dense", (bsz, h, wd, cin, cout))
    return out
