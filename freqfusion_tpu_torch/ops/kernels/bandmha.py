"""The fusion head's per-pixel band attention: kernel B11 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/bandmha.py:fused_band_mha``. On ``stacked``
[B,H,W,T,D], whose T band tokens of one pixel attend to each other:

    n = LN(stacked)                                   eps 1e-5, over D
    q, k, v = split(n @ wqkv + bqkv)                  the packed in_proj, [D,3D]
    a = softmax(q k^T * (D/heads)^-1/2) v             per pixel and head, T x T scores
    out = stacked + a @ wproj + bproj

On a CUDA tensor the wrapper launches the kernel from ``csrc/bandmha.cu`` or raises; on a
CPU tensor it runs the plain PyTorch version. Weights come as ``x @ w`` matrices ([in,out]),
as the JAX package's ``TorchMHA`` stores them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import layernorm
from . import _build

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_band_mha": 0}

MAX_D = 64   # the kernel's widest token; its products run in 64-column passes


def fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int):
    *lead, t, d = stacked.shape
    hd = d // num_heads
    qkv = layernorm(stacked, ln_w, ln_b) @ wqkv + bqkv
    # [..., T, 3, heads, hd] -> three [..., heads, T, hd]
    q, k, v = qkv.reshape(*lead, t, 3, num_heads, hd).movedim(-3, 0).transpose(-2, -3)
    attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
    a = (attn @ v).transpose(-2, -3).reshape(*lead, t, d)
    return stacked + a @ wproj + bproj


def _padded_weights(wqkv, bqkv, wproj, d: int):
    """(wq [D,64], bq [64], wkv [D,128], bkv [128], wproj [D,64]): q, then k in columns
    0..D and v in columns 64..64+D, zero-padded to the kernel's 64-column passes."""
    pad = MAX_D - d
    wq, wk, wv = (F.pad(wqkv[:, i * d:(i + 1) * d], (0, pad)) for i in range(3))
    bq, bk, bv = (F.pad(bqkv[i * d:(i + 1) * d], (0, pad)) for i in range(3))
    return (wq.contiguous(), bq, torch.cat([wk, wv], 1).contiguous(), torch.cat([bk, bv]),
            F.pad(wproj, (0, pad)).contiguous())


def fused_band_mha(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int):
    """Kernel B11 on CUDA, its plain version on the CPU. Returns [B,H,W,T,D]."""
    _build.require_no_grad("fused_band_mha", stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b)
    if stacked.device.type == "cpu":
        return fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads)
    if stacked.dim() != 5:
        raise ValueError(f"fused_band_mha: expected [B,H,W,T,D], got {tuple(stacked.shape)}")
    b, h, w, t, d = stacked.shape
    if d % 16 or d > MAX_D or d % num_heads or d // num_heads not in (8, 16, 32):
        raise ValueError(f"fused_band_mha: D={d} must be a multiple of 16 up to {MAX_D} and "
                         f"D/heads one of 8, 16, 32 (heads={num_heads})")
    if not 1 <= t <= 128:
        raise ValueError(f"fused_band_mha: T={t} outside [1, 128]")
    _build.require(stacked, "stacked")
    for name, p, shape in (("wqkv", wqkv, (d, 3 * d)), ("bqkv", bqkv, (3 * d,)),
                           ("wproj", wproj, (d, d)), ("bproj", bproj, (d,)),
                           ("ln_w", ln_w, (d,)), ("ln_b", ln_b, (d,))):
        _build.require(p, name, shape)
    wq, bq, wkv, bkv, wpp = _padded_weights(wqkv, bqkv, wproj, d)
    lib = _build.library()
    out = torch.empty_like(stacked)
    with torch.cuda.device(stacked.device):
        err = lib.band_mha(stacked.data_ptr(), wq.data_ptr(), bq.data_ptr(), wkv.data_ptr(),
                           bkv.data_ptr(), wpp.data_ptr(), bproj.data_ptr(), ln_w.data_ptr(),
                           ln_b.data_ptr(), out.data_ptr(), b * h * w, t, d, num_heads,
                           _build.stream_ptr(stacked.device))
    _build.check(err, "band_mha")
    launches["fused_band_mha"] += 1
    return out
