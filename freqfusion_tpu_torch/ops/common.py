"""Layout and normalisation ops on NHWC tensors.

Twin of ``freqfusion_tpu/ops/common.py``: the port keeps the JAX package's channels-last
layout at its public functions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def channel_layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last (channel) axis with biased variance: the reference's
    LayerNorm2d on NHWC (F.layer_norm computes the same in one pass)."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """nn.LayerNorm over the last axis with its default eps 1e-5: DAT's norms and the LN
    inside its kernels (the JAX package's ``apply_ln``). NAF's LayerNorm2d above is the
    same function at eps 1e-6; the two must not be mixed up."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """PixelShuffle on NHWC with torch's channel order: C is viewed as (C_out, r, r)."""
    *lead, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(*lead, h, w, co, r, r)
    n = len(lead)
    x = x.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return x.reshape(*lead, h * r, w * r, co)


def pad_to_multiple(x: torch.Tensor, mult: int, mode: str = "reflect"):
    """Pad H/W of an NHWC batch at the bottom/right up to a multiple of `mult`.

    `mode` is "reflect" or "zero". Returns (padded, (orig_h, orig_w))."""
    h, w = x.shape[-3], x.shape[-2]
    ph = (mult - h % mult) % mult
    pw = (mult - w % mult) % mult
    if ph or pw:
        nchw = x.permute(0, 3, 1, 2)
        if mode == "zero":
            nchw = F.pad(nchw, (0, pw, 0, ph))
        else:
            nchw = F.pad(nchw, (0, pw, 0, ph), mode=mode)
        x = nchw.permute(0, 2, 3, 1).contiguous()
    return x, (h, w)


def gaussian_1d(size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D gaussian taps, float32: the construction every gaussian window of the
    port derives from (the SSIM loss, the SSIM metric)."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Gaussian blur of an NHWC batch: the depthwise conv of the outer-product window, zero
    padded to the same size (border pixels lose mass, as ``F.conv2d(padding=size // 2)``)."""
    g = torch.from_numpy(gaussian_1d(size, sigma)).to(x)
    c = x.shape[-1]
    win = (g[:, None] * g[None, :]).expand(c, 1, size, size)
    y = F.conv2d(x.permute(0, 3, 1, 2), win, padding=size // 2, groups=c)
    return y.permute(0, 2, 3, 1)
