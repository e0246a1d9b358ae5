"""The Large-Kernel-Attention gate: kernel B12 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/lka.py:lka_gate``:

    a   = dw21x1(dw1x21(dw5x5(x)))         depthwise, each stage SAME with zero padding
    out = x * sigmoid((a @ wp) * scale + shift)

Each stage pads its own input, so a stage's output counts as zero outside the image before
the next stage runs (three ``padding=`` convs in torch). x [B,H,W,C] NHWC f32; w5 [5,5,C];
wh [21,C] taps along W; wv [21,C] taps along H; wp [C,C] applied as ``a @ wp``; scale and
shift [C], the eval-mode BatchNorm folded into an affine.

On a CUDA tensor the wrapper launches the kernels from ``csrc/lka.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version. The kernels take any batch and any C % 4 == 0 up
to 384. They are split at the two intermediates (after the 5x5, after the 1x21), which go
through device memory: 16 bytes an element more than one read of x and one write of out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"lka_gate": 0}

K = 21


def lka_gate_plain(x, w5, wh, wv, wp, scale, shift):
    c = x.shape[-1]
    a = x.permute(0, 3, 1, 2)
    a = F.conv2d(a, w5.permute(2, 0, 1).reshape(c, 1, 5, 5), padding=(2, 2), groups=c)
    a = F.conv2d(a, wh.t().reshape(c, 1, 1, K), padding=(0, K // 2), groups=c)
    a = F.conv2d(a, wv.t().reshape(c, 1, K, 1), padding=(K // 2, 0), groups=c)
    mixed = a.permute(0, 2, 3, 1) @ wp
    return x * torch.sigmoid(mixed * scale + shift)


def lka_gate(x, w5, wh, wv, wp, scale, shift):
    """Kernel B12 on CUDA, its plain version on the CPU. Returns [B,H,W,C]."""
    _build.require_no_grad("lka_gate", x, w5, wh, wv, wp, scale, shift)
    if x.device.type == "cpu":
        return lka_gate_plain(x, w5, wh, wv, wp, scale, shift)
    if x.dim() != 4:
        raise ValueError(f"lka_gate: expected [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % 4 or c > 384:
        raise ValueError(f"lka_gate: C={c} must be a multiple of 4 up to 384")
    _build.require(x, "x")
    for name, t, shape in (("w5", w5, (5, 5, c)), ("wh", wh, (K, c)), ("wv", wv, (K, c)),
                           ("wp", wp, (c, c)), ("scale", scale, (c,)), ("shift", shift, (c,))):
        _build.require(t, name, shape)
    # the streamed product takes K in steps of 16 and N in steps of 64
    kp, npad = -(-c // 16) * 16, -(-c // 64) * 64
    wpp = F.pad(wp, (0, npad - c, 0, kp - c)).contiguous()
    lib = _build.library()
    t2 = torch.empty_like(x)
    out = torch.empty_like(x)   # holds the 5x5's output until the 1x21 has read it
    with torch.cuda.device(x.device):
        err = lib.lka_gate(x.data_ptr(), w5.data_ptr(), wh.data_ptr(), wv.data_ptr(),
                           wpp.data_ptr(), scale.data_ptr(), shift.data_ptr(), t2.data_ptr(),
                           out.data_ptr(), b, h, w, c, kp, npad, _build.stream_ptr(x.device))
    _build.check(err, "lka_gate")
    launches["lka_gate"] += 1
    return out
