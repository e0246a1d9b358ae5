"""The fused DAT block tail, residual + LayerNorm + Spatial-Gate FFN: kernel B6 and its
plain version.

Twin of ``freqfusion_tpu/ops/pallas/sgfn.py:fused_sgfn_tail``:

    y = a + shortcut
    [x1, x2] = split(GELU(LN(y) @ w1 + b1))          hidden -> two halves
    out = y + (x1 * dwconv3x3(LN_sg(x2))) @ w2 + b2

On a CUDA tensor the wrapper launches the kernels from ``csrc/sgfn.cu`` or raises; on a CPU
tensor it runs the plain PyTorch version. Parameters come in the JAX package's layouts:
w1 [C,hidden], w2 [hidden/2,C] as [in,out]; wdw (3,3,1,hidden/2) HWIO. Both LayerNorms
use eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import layernorm
from . import _build
from .aim import depthwise3x3_plain

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_sgfn_tail": 0}


def fused_sgfn_tail_plain(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2):
    y = a + shortcut
    x1, x2 = F.gelu(layernorm(y, ln_w, ln_b) @ w1 + b1).chunk(2, dim=-1)
    # SAME padding zeroes LN_sg(x2), the depthwise conv's input, not x2 or y
    x2 = depthwise3x3_plain(layernorm(x2, sg_w, sg_b), wdw, bdw)
    return y + (x1 * x2) @ w2 + b2


def _padded_weights(w1, b1, w2):
    """(kp, hp, k2p, npad, w1p [kp,2*hp], b1p [2*hp], w2p [k2p,npad]): the streamed
    products take K in steps of 16 and N in steps of 64, so the weights are zero-padded,
    each half of fc1 on its own so that x1 and x2 start on a 64-column pass."""
    c, hid = w1.shape
    half = hid // 2
    kp, hp = -(-c // 16) * 16, -(-half // 64) * 64
    k2p, npad = -(-half // 16) * 16, -(-c // 64) * 64
    w1p = F.pad(w1.reshape(c, 2, half), (0, hp - half, 0, 0, 0, kp - c)).reshape(kp, 2 * hp)
    b1p = F.pad(b1.reshape(2, half), (0, hp - half)).reshape(2 * hp)
    return kp, hp, k2p, npad, w1p, b1p, F.pad(w2, (0, npad - c, 0, k2p - half))


def fused_sgfn_tail(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw, w2, b2):
    """Kernel B6 on CUDA, its plain version on the CPU. Returns [B,H,W,C]."""
    _build.require_no_grad("fused_sgfn_tail", a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw,
                           bdw, w2, b2)
    if a.device.type == "cpu":
        return fused_sgfn_tail_plain(a, shortcut, ln_w, ln_b, w1, b1, sg_w, sg_b, wdw, bdw,
                                     w2, b2)
    b, h, w, c = a.shape
    hid = w1.shape[-1]
    half = hid // 2
    if c % 4 or half % 4 or 2 * half != hid:
        raise ValueError(f"fused_sgfn_tail: C={c} and hidden/2={hid / 2} must be multiples "
                         "of 4")
    _build.require(a, "a")
    _build.require(shortcut, "shortcut", a.shape)
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)),
                           ("w1", w1, (c, hid)), ("b1", b1, (hid,)),
                           ("sg_w", sg_w, (half,)), ("sg_b", sg_b, (half,)),
                           ("wdw", wdw, (3, 3, 1, half)), ("bdw", bdw, (half,)),
                           ("w2", w2, (half, c)), ("b2", b2, (c,))):
        _build.require(t, name, shape)
    kp, hp, k2p, npad, w1p, b1p, w2p = _padded_weights(w1, b1, w2)
    lib = _build.library()
    x1 = torch.empty((b, h, w, half), device=a.device, dtype=torch.float32)
    x2n = torch.empty_like(x1)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = lib.sgfn_tail(a.data_ptr(), shortcut.data_ptr(), ln_w.data_ptr(),
                            ln_b.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), sg_w.data_ptr(),
                            sg_b.data_ptr(), wdw.data_ptr(), bdw.data_ptr(), w2p.data_ptr(),
                            b2.data_ptr(), x1.data_ptr(), x2n.data_ptr(), out.data_ptr(),
                            b, h, w, c, half, kp, hp, k2p, npad,
                            _build.stream_ptr(a.device))
    _build.check(err, "sgfn_tail")
    launches["fused_sgfn_tail"] += 1
    return out
