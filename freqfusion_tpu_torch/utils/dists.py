"""DISTS: a VGG16 trunk with L2 pooling and learned alpha / beta. Twin of
``freqfusion_tpu/utils/dists.py``.

DISTS (Ding et al. 2020): VGG16 features with every max-pool replaced by an L2 (energy)
pool, six stages (the raw input + relu1_2 .. relu5_3), per-channel weights alpha (the
structure / mean term) and beta (the texture / correlation term), an SSIM-like similarity
per stage.

Weights: ``FREQFUSION_DISTS_WEIGHTS`` names the official DISTS checkpoint (``stageK.N.*``
trunk keys in torchvision indices + ``alpha`` / ``beta`` [1,sum C,1,1]) or a torchvision
VGG16 ``features.N.*`` dict merged with alpha / beta. The modules keep the torchvision keys.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from .convert import load_torch_checkpoint, load_tower_state

# torchvision vgg16().features conv layout
VGG16_CONV_CHANNELS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 17: 512,
                       19: 512, 21: 512, 24: 512, 26: 512, 28: 512}
_POOL_INDICES = (4, 9, 16, 23)     # L2 pools; 30 is unused
_STAGE_ENDS = (3, 8, 15, 22, 29)   # last relu of each DISTS stage
DISTS_STAGE_CHANNELS = (3, 64, 128, 256, 512, 512)   # raw input + 5 stages

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# L2 pooling taps: hanning(5)[1:-1], normalised -> [0.25, 0.5, 0.25], separable
_L2_TAPS = np.hanning(5)[1:-1] / np.hanning(5)[1:-1].sum()


class L2Pool(nn.Module):
    """sqrt(depthwise 3x3 Hann blur of x^2, stride 2, zero padding 1, + 1e-12)."""

    def __init__(self):
        super().__init__()
        k = np.outer(_L2_TAPS, _L2_TAPS).astype(np.float32)
        self.register_buffer("taps", torch.from_numpy(k)[None, None], persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        out = F.conv2d(x.square(), self.taps.expand(c, 1, 3, 3), stride=2, padding=1,
                       groups=c)
        return (out + 1e-12).sqrt()


class VGG16L2Stages(nn.Module):
    """``forward(x [B,H,W,3] in [0, 1])`` -> the 6 stage features, NCHW (raw x, relu1_2,
    relu2_2, relu3_3, relu4_3, relu5_3)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for idx in range(max(_STAGE_ENDS) + 1):
            if idx in VGG16_CONV_CHANNELS:
                layers.append(nn.Conv2d(cin, VGG16_CONV_CHANNELS[idx], 3, padding=1))
                cin = VGG16_CONV_CHANNELS[idx]
            elif idx in _POOL_INDICES:
                layers.append(L2Pool())
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        feats, h = [x], (x - self.mean) / self.std
        for idx, layer in enumerate(self.features):
            h = layer(h)
            if idx in _STAGE_ENDS:
                feats.append(h)
        return feats


class DISTS(VGG16L2Stages):
    """``forward(x, y)``, both [B,H,W,3] in [0, 1] -> [B] distances (lower is better)."""

    def __init__(self):
        super().__init__()
        total = sum(DISTS_STAGE_CHANNELS)
        self.alpha = nn.Parameter(torch.full((1, total, 1, 1), 0.1))
        self.beta = nn.Parameter(torch.full((1, total, 1, 1), 0.1))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        feats = super().forward(torch.cat([x, y]))
        a, bt = self.alpha.flatten(), self.beta.flatten()
        w_sum = a.sum() + bt.sum()
        c1 = c2 = 1e-6
        off, d1, d2 = 0, 0.0, 0.0
        for f, c in zip(feats, DISTS_STAGE_CHANNELS):
            ak, bk = a[off:off + c] / w_sum, bt[off:off + c] / w_sum
            off += c
            fx, fy = f[:b], f[b:]
            xm, ym = fx.mean(dim=(2, 3)), fy.mean(dim=(2, 3))
            s1 = (2 * xm * ym + c1) / (xm ** 2 + ym ** 2 + c1)
            d1 = d1 + (ak * s1).sum(dim=-1)
            xv = (fx - xm[..., None, None]).square().mean(dim=(2, 3))
            yv = (fy - ym[..., None, None]).square().mean(dim=(2, 3))
            cov = (fx * fy).mean(dim=(2, 3)) - xm * ym
            s2 = (2 * cov + c2) / (xv + yv + c2)
            d2 = d2 + (bk * s2).sum(dim=-1)
        return 1.0 - (d1 + d2)


def load_dists(weights_path: str) -> DISTS:
    """The official DISTS checkpoint (``stageK.N.*`` in torchvision indices + alpha / beta)
    or a torchvision VGG16 ``features.N.*`` dict merged with alpha / beta -> the loaded
    ``DISTS``."""
    sd = {}
    for k, v in load_torch_checkpoint(weights_path).items():
        if k.split(".")[0].startswith("stage") and k.count(".") == 2:
            _, idx, leaf = k.split(".")
            k = f"features.{idx}.{leaf}"
        sd[k] = v
    if "alpha" not in sd or "beta" not in sd:
        raise RuntimeError(f"{weights_path} lacks DISTS alpha/beta weights")
    return load_tower_state(DISTS(), sd).eval()


class NativeDISTS:
    """DISTS distance on uint8 HWC RGB pairs (lower is better), on `device` (the card
    unless the caller names another; without a card the default raises).

    Weights: `weights_path`, else
    ``FREQFUSION_DISTS_WEIGHTS``; without any the constructor raises and the dists column
    stays NaN. `dtype` is the one the tower computes in (float64: a reference)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.device, self.dtype = require_device(device), dtype
        weights_path = weights_path or os.environ.get("FREQFUSION_DISTS_WEIGHTS")
        if not (weights_path and os.path.exists(weights_path)):
            raise RuntimeError("DISTS pretrained weights unavailable (set "
                               "FREQFUSION_DISTS_WEIGHTS or pass weights_path)")
        self.model = load_dists(weights_path).to(self.device, dtype)

    def __call__(self, output: np.ndarray, target: np.ndarray) -> float:
        def to_t(im):
            t = torch.from_numpy(np.asarray(im, np.float32)[None]).to(self.device, self.dtype)
            return t / 255.0

        with torch.inference_mode(), pinned_precision("highest"):
            return float(self.model(to_t(output), to_t(target))[0])
