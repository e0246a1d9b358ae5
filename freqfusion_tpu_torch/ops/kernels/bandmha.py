"""The fusion head's per-pixel band attention: kernel B11 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/bandmha.py:fused_band_mha``. On ``stacked``
[B,H,W,T,D], whose T band tokens of one pixel attend to each other:

    n = LN(stacked)                                   eps 1e-5, over D
    q, k, v = split(n @ wqkv + bqkv)                  the packed in_proj, [D,3D]
    a = softmax(q k^T * (D/heads)^-1/2) v             per pixel and head, T x T scores
    out = stacked + a @ wproj + bproj

On a CUDA tensor the wrapper launches the kernel from ``csrc/bandmha.cu`` or raises; on a
CPU tensor it runs the plain PyTorch version. Weights come as ``x @ w`` matrices ([in,out]),
as the JAX package's ``TorchMHA`` stores them; they may be views (the head passes
``in_proj_weight.t()``). The kernel's products run f32-exact on the tensor cores (3xTF32)
on the weights laid out as B fragments once for each weight (``band_weights``).
"""

from __future__ import annotations

import torch

from ..common import layernorm
from . import _build, _mma

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_band_mha": 0}

#: What csrc/bandmha.cu takes: D a multiple of 16 up to MAX_D (its weights resident in shared
#: memory up to RESIDENT_D, 128-row groups there, 64-row groups above), a head width that is
#: a multiple of 4 up to MAX_HEAD, and T band tokens up to the rows of a group.
MAX_D = 128
RESIDENT_D = 64
MAX_HEAD = 64


def max_tokens(d: int) -> int:
    """The most band tokens a pixel may have at token width d: one group's rows."""
    return 128 if d <= RESIDENT_D else 64


def fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int):
    *lead, t, d = stacked.shape
    hd = d // num_heads
    qkv = layernorm(stacked, ln_w, ln_b) @ wqkv + bqkv
    # [..., T, 3, heads, hd] -> three [..., heads, T, hd]
    q, k, v = qkv.reshape(*lead, t, 3, num_heads, hd).movedim(-3, 0).transpose(-2, -3)
    attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
    a = (attn @ v).transpose(-2, -3).reshape(*lead, t, d)
    return stacked + a @ wproj + bproj


def band_weights(wqkv: torch.Tensor, wproj: torch.Tensor):
    """(wqkv [D,3D], wproj [D,D]) as the kernel's B fragments, unsplit (``_mma.fragments``),
    made once for each weight, so that the views the head passes will do."""
    return _mma.fragments(wqkv), _mma.fragments(wproj)


def fused_band_mha(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int):
    """Kernel B11 on CUDA, its plain version on the CPU. Returns [B,H,W,T,D]."""
    _build.require_no_grad("fused_band_mha", stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b)
    if stacked.device.type == "cpu":
        return fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads)
    if stacked.dim() != 5:
        raise ValueError(f"fused_band_mha: expected [B,H,W,T,D], got {tuple(stacked.shape)}")
    b, h, w, t, d = stacked.shape
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"fused_band_mha: D={d} must be a multiple of 16 up to {MAX_D}")
    if num_heads < 1 or d % num_heads or d // num_heads % 4 or d // num_heads > MAX_HEAD:
        raise ValueError(f"fused_band_mha: D/heads = {d}/{num_heads} must be a whole multiple "
                         f"of 4 up to {MAX_HEAD}")
    if not 1 <= t <= max_tokens(d):
        raise ValueError(f"fused_band_mha: T={t} outside [1, {max_tokens(d)}] at D={d}")
    _build.require(stacked, "stacked")
    # wqkv and wproj are laid out anew (band_weights): views will do
    for name, p, shape, contiguous in (("wqkv", wqkv, (d, 3 * d), False),
                                       ("bqkv", bqkv, (3 * d,), True),
                                       ("wproj", wproj, (d, d), False),
                                       ("bproj", bproj, (d,), True), ("ln_w", ln_w, (d,), True),
                                       ("ln_b", ln_b, (d,), True)):
        _build.require(p, name, shape, contiguous=contiguous)
    wqkv_f, wproj_f = band_weights(wqkv, wproj)
    lib = _build.library()
    out = torch.empty_like(stacked)
    with torch.cuda.device(stacked.device):
        err = lib.band_mha(stacked.data_ptr(), wqkv_f.data_ptr(), bqkv.data_ptr(),
                           wproj_f.data_ptr(), bproj.data_ptr(), ln_w.data_ptr(),
                           ln_b.data_ptr(), out.data_ptr(), b * h * w, t, d, num_heads,
                           _build.stream_ptr(stacked.device))
    _build.check(err, "band_mha")
    launches["fused_band_mha"] += 1
    return out
