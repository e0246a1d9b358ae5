"""Laplacian pyramid edge enhancement on NHWC tensors. Twin of
``freqfusion_tpu/models/edge.py``: a 3-level Laplacian pyramid (fixed 5x5 sigma = 1.5
Gaussian blur + 2x2 average pool), per-level EdgeRefineBlocks, softmax level weights, a
fusion conv to an edge map, a per-pixel gate on [image | edges], and a learnable edge
strength: out = clamp(sr + gate * strength * edge, 0, 1). Module names follow the
reference's state-dict keys; the convs are library convs, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from .layers import conv_nhwc


def gaussian_1d(size: int, sigma: float) -> np.ndarray:
    """Normalised 1-D Gaussian window (the JAX package's ``ops.common.gaussian_1d``)."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, size: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Fixed Gaussian blur of an NHWC tensor with zero SAME padding: the depthwise conv."""
    c = x.shape[-1]
    g = gaussian_1d(size, sigma)
    k = torch.from_numpy(np.outer(g, g).astype(np.float32)).to(device=x.device, dtype=x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, size, size), padding=size // 2,
                 groups=c)
    return y.permute(0, 2, 3, 1)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of an NHWC tensor (H, W even)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


class SpatialEdgeAttention(nn.Module):
    """1x1 (C -> C/4) -> GELU -> 3x3 (-> 1) -> sigmoid gate."""

    def __init__(self, channels: int):
        super().__init__()
        self.attn = nn.Sequential(nn.Conv2d(channels, channels // 4, 1), nn.GELU(),
                                  nn.Conv2d(channels // 4, 1, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(conv_nhwc(self.attn, x))


class EdgeRefineBlock(nn.Module):
    """proj-residual 3-conv refiner + spatial gate."""

    def __init__(self, in_ch: int = 3, feat_ch: int = 32):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, feat_ch, 1)
        self.conv1 = nn.Conv2d(in_ch, feat_ch, 3, padding=1)
        self.conv2 = nn.Conv2d(feat_ch, feat_ch, 3, padding=1)
        self.conv3 = nn.Conv2d(feat_ch, feat_ch, 3, padding=1)
        self.attn = SpatialEdgeAttention(feat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        h = F.gelu(self.conv2(F.gelu(self.conv1(xc))))
        h = self.conv3(h) + self.proj(xc)
        return self.attn(h.permute(0, 2, 3, 1))


class LaplacianEdgeRefinement(nn.Module):
    def __init__(self, num_levels: int = 3, channels: int = 32,
                 edge_strength_init: float = 0.15):
        super().__init__()
        self.num_levels = num_levels
        self.edge_refiners = nn.ModuleList(EdgeRefineBlock(3, channels)
                                           for _ in range(num_levels))
        self.level_weights = nn.Parameter(torch.full((num_levels,), 1.0 / num_levels))
        self.fusion = nn.Sequential(nn.Conv2d(num_levels * channels, channels, 3, padding=1),
                                    nn.GELU(), nn.Conv2d(channels, 3, 3, padding=1))
        self.edge_gate = nn.Sequential(nn.Conv2d(6, 16, 3, padding=1), nn.GELU(),
                                       nn.Conv2d(16, 1, 3, padding=1))
        self.edge_strength = nn.Parameter(torch.tensor(float(edge_strength_init)))

    def _pyramid(self, img: torch.Tensor) -> List[torch.Tensor]:
        pyramid, current = [], img
        for level in range(self.num_levels):
            if level < self.num_levels - 1:
                down = avg_pool2(gaussian_blur(current))
                up = resize(down, current.shape[1], current.shape[2], "bilinear")
                pyramid.append(current - up)
                current = down
            else:
                pyramid.append(current)
        return pyramid

    def forward(self, sr_img: torch.Tensor) -> torch.Tensor:
        h, w = sr_img.shape[1], sr_img.shape[2]
        level_w = torch.softmax(self.level_weights, dim=0)
        feats = []
        for level, lap in enumerate(self._pyramid(sr_img)):
            f = self.edge_refiners[level](lap)
            if f.shape[1] != h or f.shape[2] != w:
                f = resize(f, h, w, "bilinear")
            feats.append(f * level_w[level])
        edge_map = conv_nhwc(self.fusion, torch.cat(feats, dim=-1))
        gate = torch.sigmoid(conv_nhwc(self.edge_gate, torch.cat([sr_img, edge_map], dim=-1)))
        return (sr_img + gate * self.edge_strength * edge_map).clamp(0.0, 1.0)
