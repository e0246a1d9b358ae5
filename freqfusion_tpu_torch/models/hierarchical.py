"""Hierarchical multi-resolution fusion on NHWC tensors. Twin of
``freqfusion_tpu/models/hierarchical.py``: the expert RGB stack (E*3 channels) is fused at
1/4 -> 1/2 -> full resolution with per-stage conv + GELU, a spatial gate, 0.1-scaled
ResBlocks, learnable cross-stage residual weights (0.2) and a channel-split residual into
stage 3; output through to_rgb + sigmoid. Module names follow the reference's flat
state-dict keys (``stage1_conv.0``, ``stage1_gate.gate.0``, ``stage1_res.block.0``). The
3x3 convs are library convs, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops.resize import resize
from .layers import conv1x1_nhwc, conv_nhwc, gelu


class SpatialGate(nn.Module):
    """Per-pixel gate: 1x1 (C -> C/4) -> GELU -> 1x1 (-> 1) -> sigmoid."""

    def __init__(self, channels: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Conv2d(channels, channels // 4, 1), nn.GELU(),
                                  nn.Conv2d(channels // 4, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = conv1x1_nhwc(self.gate[2], gelu(conv1x1_nhwc(self.gate[0], x)))
        return x * torch.sigmoid(g)


class ResBlock(nn.Module):
    """Two bias-free 3x3 convs with GELU, 0.1-init learnable residual scale."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1, bias=False),
                                   nn.GELU(),
                                   nn.Conv2d(channels, channels, 3, padding=1, bias=False))
        self.scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.scale * conv_nhwc(self.block, x)


def _stage(conv: nn.Sequential, gate: SpatialGate, res: ResBlock, x: torch.Tensor):
    """(conv + GELU) x 2 -> SpatialGate -> ResBlock."""
    return res(gate(gelu(conv_nhwc(conv, x))))


class HierarchicalFusion(nn.Module):
    """Progressive 3-stage fusion of the stacked expert outputs -> RGB in [0,1]."""

    def __init__(self, num_experts: int = 3, base_channels: int = 64):
        super().__init__()
        bc, cin = base_channels, 3 * num_experts
        self.base_channels = bc

        def conv(c0, c1, c2):   # the trailing GELU is applied by _stage
            return nn.Sequential(nn.Conv2d(c0, c1, 3, padding=1), nn.GELU(),
                                 nn.Conv2d(c1, c2, 3, padding=1))
        self.stage1_conv, self.stage1_gate, self.stage1_res = (
            conv(cin, bc, bc), SpatialGate(bc), ResBlock(bc))
        self.stage2_conv, self.stage2_gate, self.stage2_res = (
            conv(bc + cin, bc, bc), SpatialGate(bc), ResBlock(bc))
        self.stage3_conv, self.stage3_gate, self.stage3_res = (
            conv(bc + cin, bc, bc // 2), SpatialGate(bc // 2), ResBlock(bc // 2))
        self.residual_weight_1_2 = nn.Parameter(torch.tensor(0.2))
        self.residual_weight_2_3 = nn.Parameter(torch.tensor(0.2))
        self.to_rgb = nn.Sequential(nn.Conv2d(bc // 2, bc // 4, 3, padding=1), nn.GELU(),
                                    nn.Conv2d(bc // 4, 3, 3, padding=1))

    def forward(self, expert_outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        stack = torch.cat(list(expert_outputs.values()), dim=-1)
        h, w = stack.shape[1], stack.shape[2]
        h1, w1 = max(h // 4, 1), max(w // 4, 1)
        h2, w2 = max(h // 2, 1), max(w // 2, 1)

        f1 = _stage(self.stage1_conv, self.stage1_gate, self.stage1_res,
                    resize(stack, h1, w1, "bilinear"))
        f1_up = resize(f1, h2, w2, "bilinear")
        f2 = _stage(self.stage2_conv, self.stage2_gate, self.stage2_res,
                    torch.cat([f1_up, resize(stack, h2, w2, "bilinear")], dim=-1))
        f2 = f2 + self.residual_weight_1_2 * f1_up
        f2_up = resize(f2, h, w, "bilinear")
        f3 = _stage(self.stage3_conv, self.stage3_gate, self.stage3_res,
                    torch.cat([f2_up, stack], dim=-1))
        f3 = f3 + self.residual_weight_2_3 * f2_up[..., : self.base_channels // 2]
        return torch.sigmoid(conv_nhwc(self.to_rgb, f3))
