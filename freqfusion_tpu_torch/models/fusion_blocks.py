"""Fusion-head building blocks on NHWC tensors. Twin of
``freqfusion_tpu/models/fusion_blocks.py``: dynamic expert selection, multi-scale routing
features, the frequency router, the standard (non-LKA) cross-band / collaborative attention
variants, and the adaptive frequency-band predictor. Module names follow the reference's
state-dict keys (Sequential indices included); BatchNorm runs on its running statistics in
eval mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from . import layers
from .layers import (BatchNorm2d, CBAMSpatialAttention, ChannelSpatialAttention, TorchMHA,
                     conv1x1_nhwc, conv_nhwc)
from .lka import bn_nhwc


class DynamicExpertSelector(nn.Module):
    """Per-pixel expert gates from a difficulty CNN.

    threshold = 0.7 - 0.4 * difficulty; soft gate sigmoid(10 * (gate - threshold)); the
    near-max gate of a pixel is floored at 0.9 so that at least one expert always fires."""

    def __init__(self, hidden_dim: int = 64, num_experts: int = 3):
        super().__init__()
        hd = hidden_dim
        self.difficulty_estimator = nn.Sequential(
            nn.Conv2d(3, hd, 3, padding=1), nn.ReLU(), nn.Conv2d(hd, hd // 2, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hd // 2, 1, 3, padding=1))
        self.expert_gate = nn.Sequential(nn.Conv2d(hd, hd, 3, padding=1), nn.ReLU(),
                                         nn.Conv2d(hd, num_experts, 1))

    def forward(self, lr_input: torch.Tensor,
                routing_features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        difficulty = torch.sigmoid(
            self.difficulty_estimator(lr_input.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        gates = torch.sigmoid(
            self.expert_gate(routing_features.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        threshold = 0.7 - 0.4 * difficulty
        gates = torch.sigmoid(10.0 * (gates - threshold))
        max_gate = gates.amax(dim=-1, keepdim=True)
        gate_mask = (gates >= max_gate * 0.99).to(gates.dtype)
        return torch.maximum(gates, gate_mask * 0.9), difficulty


def _conv_relu_bn(seq: nn.Sequential, x: torch.Tensor, at: int = 0) -> torch.Tensor:
    """Sequential(.., conv, ReLU, BN, ..) from index `at` on an NHWC tensor."""
    return bn_nhwc(seq[at + 2], F.relu(conv_nhwc(seq[at], x)))


class MultiScaleFeatureExtractor(nn.Module):
    """1x / 2x / 4x conv pyramid -> 1x1 fusion."""

    def __init__(self, out_channels: int = 64):
        super().__init__()
        def branch():
            return nn.Sequential(nn.Conv2d(3, out_channels, 3, padding=1, bias=False),
                                 nn.ReLU(), BatchNorm2d(out_channels))
        self.conv_1x, self.conv_2x, self.conv_4x = branch(), branch(), branch()
        self.fusion = nn.Conv2d(3 * out_channels, out_channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        f1 = _conv_relu_bn(self.conv_1x, x)
        f2 = _conv_relu_bn(self.conv_2x, resize(x, h // 2, w // 2, "bilinear"))
        f4 = _conv_relu_bn(self.conv_4x, resize(x, h // 4, w // 4, "bilinear"))
        return conv1x1_nhwc(self.fusion, torch.cat(
            [f1, resize(f2, h, w, "bilinear"), resize(f4, h, w, "bilinear")], dim=-1))


class FrequencyRouter(nn.Module):
    """5-conv CNN + CBAM attention -> softmax routing [B,H,W,E,bands], over the experts."""

    def __init__(self, num_experts: int = 3, num_bands: int = 3,
                 hidden: Sequence[int] = (32, 64, 64, 32)):
        super().__init__()
        self.num_experts, self.num_bands = num_experts, num_bands

        def block(cin, c1, c2):
            return nn.Sequential(nn.Conv2d(cin, c1, 3, padding=1, bias=False), nn.ReLU(),
                                 BatchNorm2d(c1), nn.Conv2d(c1, c2, 3, padding=1, bias=False),
                                 nn.ReLU(), BatchNorm2d(c2))
        self.conv_block1 = block(3, hidden[0], hidden[1])
        self.attention1 = ChannelSpatialAttention(hidden[1])
        self.conv_block2 = block(hidden[1], hidden[2], hidden[3])
        self.attention2 = CBAMSpatialAttention(5)
        self.output_conv = nn.Conv2d(hidden[3], num_experts * num_bands, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_relu_bn(self.conv_block1, _conv_relu_bn(self.conv_block1, x), 3)
        x = self.attention1(x)
        x = _conv_relu_bn(self.conv_block2, _conv_relu_bn(self.conv_block2, x), 3)
        logits = conv1x1_nhwc(self.output_conv, self.attention2(x))
        b, h, w, _ = logits.shape
        return torch.softmax(logits.reshape(b, h, w, self.num_experts, self.num_bands), dim=-2)


class AdaptiveFrequencyBandPredictor(nn.Module):
    """Global-pool MLP -> per-image (low_split, high_split), each [B,1], clamped to
    [0.15, 0.4] / [0.6, 0.9] with high >= low + 0.2."""

    def __init__(self):
        super().__init__()
        self.predictor = nn.Sequential(nn.Conv2d(3, 16, 1), nn.ReLU(), nn.Conv2d(16, 2, 1))
        self.base_low_split = nn.Parameter(torch.tensor(0.25))
        self.base_high_split = nn.Parameter(torch.tensor(0.75))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        pooled = x.mean(dim=(1, 2), keepdim=True)
        h = F.relu(conv1x1_nhwc(self.predictor[0], pooled))
        offsets = torch.sigmoid(conv1x1_nhwc(self.predictor[2], h))
        offsets = (offsets.reshape(x.shape[0], 2) - 0.5) * 0.2
        low = (self.base_low_split + offsets[:, 0:1]).clamp(0.15, 0.4)
        high = (self.base_high_split + offsets[:, 1:2]).clamp(0.6, 0.9)
        return low, torch.maximum(high, low + 0.2)


class CrossBandAttention(nn.Module):
    """Standard (non-LKA) per-pixel cross-band MHA."""

    def __init__(self, dim: int = 64, num_heads: int = 4):
        super().__init__()
        self.band_proj = nn.Conv2d(3, dim, 1)
        self.norm = nn.LayerNorm(dim)
        self.band_attention = TorchMHA(dim, num_heads)
        self.out_proj = nn.Conv2d(dim, 3, 1)

    def forward(self, bands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        projected = torch.stack([conv1x1_nhwc(self.band_proj, b) for b in bands], dim=-2)
        attn = self.band_attention(self.norm(projected)) + projected
        return [conv1x1_nhwc(self.out_proj, attn[..., i, :]) + b for i, b in enumerate(bands)]


class CollaborativeFeatureLearning(nn.Module):
    """Standard (non-LKA) cross-expert collaboration."""

    NAMES = ("hat", "dat", "nafnet")

    def __init__(self, num_experts: int = 3, feature_dim: int = 128, num_heads: int = 8,
                 expert_channels: Optional[Dict[str, int]] = None):
        super().__init__()
        self.names = self.NAMES[:num_experts]
        chans = expert_channels or {"hat": 180, "dat": 180, "nafnet": 64}
        fd = feature_dim
        self.align_layers = nn.ModuleDict({n: nn.Conv2d(chans[n], fd, 1) for n in self.names})
        self.norm1 = nn.LayerNorm(fd)
        self.cross_attn = TorchMHA(fd, num_heads)
        self.norm2 = nn.LayerNorm(fd)
        self.ffn = nn.Sequential(nn.Linear(fd, fd * 4), nn.GELU(), nn.Linear(fd * 4, fd))
        # Sequential(pool, conv, Sigmoid) in the reference: key `.1`
        self.modulation = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(fd, 3, 1))
            for _ in range(num_experts))

    def forward(self, expert_features: Dict[str, torch.Tensor],
                expert_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        min_h = min(expert_features[n].shape[1] for n in self.names)
        min_w = min(expert_features[n].shape[2] for n in self.names)
        aligned = []
        for n in self.names:
            a = conv1x1_nhwc(self.align_layers[n], expert_features[n])
            if a.shape[1] != min_h or a.shape[2] != min_w:
                a = resize(a, min_h, min_w, "bilinear")
            aligned.append(a)
        stacked = torch.stack(aligned, dim=-2)   # [B,H,W,E,C]
        stacked = stacked + self.cross_attn(self.norm1(stacked))
        h = layers.dropout(F.gelu(self.ffn[0](self.norm2(stacked))), 0.1, self.training)
        stacked = stacked + self.ffn[2](h)

        h_sr, w_sr = expert_outputs[0].shape[1], expert_outputs[0].shape[2]
        outs = []
        for i, out in enumerate(expert_outputs):
            feat = resize(stacked[..., i, :], h_sr, w_sr, "bilinear")
            m = torch.sigmoid(conv1x1_nhwc(self.modulation[i][1],
                                           feat.mean(dim=(1, 2), keepdim=True)))
            outs.append((out * (1.0 + 0.2 * (m - 0.5))).clamp(0.0, 1.0))
        return outs
