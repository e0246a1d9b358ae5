"""Image resize on NHWC tensors with torch ``F.interpolate`` semantics.

Twin of ``freqfusion_tpu/ops/resize.py``, which re-implements torch's kernels
(align_corners=False, antialias=False, bicubic A=-0.75) for the TPU. Here the library
call is the faithful counterpart; it is not a TPU kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, out_h: int, out_w: int, method: str = "bicubic") -> torch.Tensor:
    """Resize an NHWC batch to (out_h, out_w); method is bicubic or bilinear."""
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize method: {method}")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode=method,
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample(x: torch.Tensor, scale: int, method: str = "bicubic") -> torch.Tensor:
    """Integer-factor upsample of an NHWC batch."""
    return resize(x, x.shape[-3] * scale, x.shape[-2] * scale, method)


def downsample(x: torch.Tensor, scale: int, method: str = "bilinear") -> torch.Tensor:
    """Integer-factor downsample of an NHWC batch (torch's antialias=False)."""
    return resize(x, x.shape[-3] // scale, x.shape[-2] // scale, method)
