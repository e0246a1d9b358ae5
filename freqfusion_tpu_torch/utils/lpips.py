"""LPIPS ('alex'): the AlexNet trunk, the five learned 1x1 heads and the checkpoint loader.
Twin of ``freqfusion_tpu/utils/lpips.py``.

Recipe (Zhang et al. 2018, as the lpips package ships it): inputs in [-1, 1] -> fixed
per-channel scaling -> AlexNet relu1 .. relu5 -> each tap unit-normalised over channels
(eps 1e-10) -> squared difference -> learned 1x1 no-bias head per tap -> spatial mean ->
sum over taps.

Weights: ``FREQFUSION_LPIPS_WEIGHTS`` names a torch state dict holding torchvision's
AlexNet trunk (``features.N.weight/bias``, optionally under ``net.``) merged with the
lpips heads (``lin{K}.model.1.weight`` [1,C,1,1]). The modules keep those keys.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from .convert import load_torch_checkpoint, load_tower_state

# torchvision alexnet().features layout: index -> (out_ch, kernel, stride, pad)
ALEX_CONVS = {0: (64, 11, 4, 2), 3: (192, 5, 1, 2), 6: (384, 3, 1, 1), 8: (256, 3, 1, 1),
              10: (256, 3, 1, 1)}
_ALEX_POOLS = (2, 5)               # MaxPool2d(3, stride=2), no padding
_ALEX_TAPS = (1, 4, 7, 9, 11)      # relu1 .. relu5
ALEX_TAP_CHANNELS = (64, 192, 384, 256, 256)

# lpips ScalingLayer constants (RGB, inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _NetLin(nn.Module):
    """lpips' NetLinLayer: dropout (inactive in eval) then a 1x1 no-bias conv to 1 channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class AlexLPIPS(nn.Module):
    """``forward(x0, x1)``, both [B,H,W,3] in [-1, 1] -> [B] distances."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for idx in range(max(_ALEX_TAPS) + 1):
            if idx in ALEX_CONVS:
                c, k, s, p = ALEX_CONVS[idx]
                layers.append(nn.Conv2d(cin, c, k, stride=s, padding=p))
                cin = c
            elif idx in _ALEX_POOLS:
                layers.append(nn.MaxPool2d(3, stride=2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        for k, c in enumerate(ALEX_TAP_CHANNELS):
            self.add_module(f"lin{k}", _NetLin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        b = x0.shape[0]
        x = (torch.cat([x0, x1]).permute(0, 3, 1, 2) - self.shift) / self.scale
        total = x.new_zeros(b)
        k = 0
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in _ALEX_TAPS:
                feat = x / (x.square().sum(dim=1, keepdim=True).sqrt() + 1e-10)
                d = (feat[:b] - feat[b:]).square().mean(dim=(2, 3))          # [B, C]
                w = getattr(self, f"lin{k}").model[1].weight.flatten()
                total = total + (d * w).sum(dim=-1)
                k += 1
        return total


def load_lpips(weights_path: str) -> AlexLPIPS:
    """A merged torch state dict (torchvision ``features.N.*``, optionally under ``net.``,
    plus the lpips ``linK.model.1.weight`` heads) -> the loaded ``AlexLPIPS``."""
    sd = {(k[len("net."):] if k.startswith("net.") else k): v
          for k, v in load_torch_checkpoint(weights_path).items()}
    return load_tower_state(AlexLPIPS(), sd).eval()


class NativeLPIPS:
    """LPIPS('alex') distance on uint8 HWC RGB pairs, on `device` (the card unless the
    caller names another; without a card the default raises).

    Weights: `weights_path`, else
    ``FREQFUSION_LPIPS_WEIGHTS``; without any the constructor raises and the lpips column
    stays NaN. `dtype` is the one the tower computes in (float64: a reference)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.device, self.dtype = require_device(device), dtype
        weights_path = weights_path or os.environ.get("FREQFUSION_LPIPS_WEIGHTS")
        if not (weights_path and os.path.exists(weights_path)):
            raise RuntimeError("LPIPS pretrained weights unavailable (set "
                               "FREQFUSION_LPIPS_WEIGHTS or pass weights_path)")
        self.model = load_lpips(weights_path).to(self.device, dtype)

    def __call__(self, output: np.ndarray, target: np.ndarray) -> float:
        """uint8 (or [0, 255] float) HWC RGB images -> LPIPS distance."""
        def to_t(a):
            t = torch.from_numpy(np.asarray(a, np.float32)[None]).to(self.device, self.dtype)
            return t / 127.5 - 1.0

        with torch.inference_mode(), pinned_precision("highest"):
            return float(self.model(to_t(output), to_t(target))[0])
