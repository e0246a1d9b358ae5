"""Alternative and baseline fusion pipelines on NHWC tensors. Twin of
``freqfusion_tpu/models/fusion_variants.py``:

- ``FrequencyAwareFusion``: flat fusion. FrequencyRouter softmax routing x learnable
  expert_weights [E,bands] x softmax band_importance, summed over bands, normalised over
  experts, refined by a small conv stack (0.1 residual) plus a learnable bilinear LR
  residual.
- ``MultiFusionSR``: experts (run elsewhere) + FrequencyAwareFusion.
- ``MultiResolutionFusion``: the flat 64 -> 128 -> 256 softmax fusion with 0.3 progressive
  blends; the head builds it at ``FusionConfig(enable_hierarchical=False,
  enable_multi_resolution=True)``.
- ``EnhancedMultiFusionSR``: the legacy wrapper, multi-resolution fusion when enabled, else
  the flat frequency-aware fusion.

Every module takes the expert outputs explicitly. Module names are the state-dict keys that
``utils/convert.py:fusion_key`` gives the JAX modules' parameters. No kernel runs here:
every conv is a library conv, as the JAX package leaves these convs to XLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize
from .fusion_blocks import FrequencyRouter, MultiScaleFeatureExtractor
from .layers import conv1x1_nhwc, conv_nhwc


class FrequencyAwareFusion(nn.Module):
    """``forward(lr, expert_outputs)`` -> fused [B, Hr, Wr, 3] in [0, 1]."""

    def __init__(self, num_experts: int = 3, num_bands: int = 3, use_residual: bool = True,
                 use_multiscale: bool = True, upscale: int = 4):
        super().__init__()
        self.num_bands, self.use_residual, self.use_multiscale = (num_bands, use_residual,
                                                                  use_multiscale)
        if use_multiscale:
            self.multiscale = MultiScaleFeatureExtractor(32)
        self.freq_router = FrequencyRouter(num_experts, num_bands,
                                           in_channels=32 if use_multiscale else 3)
        self.expert_weights = nn.Parameter(torch.ones(num_experts, num_bands))
        self.band_importance = nn.Parameter(torch.ones(num_bands))
        self.refine_conv1 = nn.Conv2d(3, 32, 3, padding=1, bias=False)
        self.refine_conv2 = nn.Conv2d(32, 3, 3, padding=1, bias=False)
        if use_residual:
            self.residual_weight = nn.Parameter(torch.tensor(0.1))

    def forward(self, lr: torch.Tensor,
                expert_outputs: Union[Sequence[torch.Tensor], Dict[str, torch.Tensor]]
                ) -> torch.Tensor:
        if isinstance(expert_outputs, dict):
            expert_outputs = list(expert_outputs.values())
        stack = torch.stack(list(expert_outputs), dim=-2)        # [B,Hr,Wr,E,3]
        h_hr, w_hr, e = stack.shape[1], stack.shape[2], len(expert_outputs)
        router_in = self.multiscale(lr) if self.use_multiscale else lr
        routing = self.freq_router(router_in)[..., :e, :]         # [B,H,W,E,bands]
        b, h, w = routing.shape[:3]
        routing_hr = resize(routing.reshape(b, h, w, e * self.num_bands), h_hr, w_hr,
                            "bilinear").reshape(b, h_hr, w_hr, e, self.num_bands)
        weighted = (routing_hr * self.expert_weights[:e]
                    * torch.softmax(self.band_importance, 0))
        agg = weighted.sum(dim=-1)                                 # [B,Hr,Wr,E]
        agg = agg / (agg.sum(dim=-1, keepdim=True) + 1e-8)
        fused = (stack * agg[..., None]).sum(dim=-2)
        r = conv_nhwc(self.refine_conv2, F.relu(conv_nhwc(self.refine_conv1, fused)))
        fused = fused + r * 0.1
        if self.use_residual:
            fused = fused + self.residual_weight * resize(lr, h_hr, w_hr, "bilinear")
        return fused.clamp(0.0, 1.0)


def _router(base_channels: int, num_experts: int) -> nn.Sequential:
    """conv3x3 -> ReLU -> conv1x1: the reference's Sequential (its softmax over the experts
    is applied by the caller)."""
    return nn.Sequential(nn.Conv2d(3, base_channels, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(base_channels, num_experts, 1))


def _up_conv() -> nn.Sequential:
    """Upsample slot, conv3x3 -> ReLU: the conv keeps the reference's key ``.1``."""
    return nn.Sequential(nn.Identity(), nn.Conv2d(3, 3, 3, padding=1), nn.ReLU())


class MultiResolutionFusion(nn.Module):
    """Flat 3-stage softmax fusion at 64, 128 and the experts' own size, with 0.3
    progressive blends. ``forward(lr, expert_outputs, target_size=None)``."""

    def __init__(self, num_experts: int = 3, base_channels: int = 32):
        super().__init__()
        self.num_experts = num_experts
        self.fusion_64 = _router(base_channels, num_experts)
        self.fusion_128 = _router(base_channels, num_experts)
        self.fusion_256 = _router(base_channels, num_experts)
        self.up_64_128 = _up_conv()
        self.up_128_256 = _up_conv()
        self.refine = nn.Sequential(nn.Conv2d(3, 32, 3, padding=1), nn.ReLU(),
                                    nn.Conv2d(32, 3, 3, padding=1))

    @staticmethod
    def _route(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        g = conv1x1_nhwc(seq[2], F.relu(conv_nhwc(seq[0], x)))
        return torch.softmax(g, dim=-1)                             # over the experts

    def forward(self, lr: torch.Tensor, expert_outputs: List[torch.Tensor],
                target_size: Optional[int] = None) -> torch.Tensor:
        stack = torch.stack(list(expert_outputs), dim=-2)          # [B,Hs,Ws,E,3]
        b, hs, ws = stack.shape[:3]
        target_size = target_size or hs

        def fuse_at(size_h, size_w, seq, experts):
            wts = self._route(seq, resize(lr, size_h, size_w, "bilinear"))
            return (experts * wts[..., None]).sum(dim=-2)

        def down_experts(size):
            flat = resize(stack.reshape(b, hs, ws, -1), size, size, "bilinear")
            return flat.reshape(b, size, size, self.num_experts, 3)

        fused_64 = fuse_at(64, 64, self.fusion_64, down_experts(64))
        up = F.relu(conv_nhwc(self.up_64_128[1], resize(fused_64, 128, 128, "bilinear")))
        fused_128 = fuse_at(128, 128, self.fusion_128, down_experts(128)) + up * 0.3
        up = F.relu(conv_nhwc(self.up_128_256[1], resize(fused_128, hs, ws, "bilinear")))
        fused = fuse_at(hs, ws, self.fusion_256, stack) + up * 0.3
        r = conv_nhwc(self.refine[2], F.relu(conv_nhwc(self.refine[0], fused)))
        fused = fused + r * 0.1
        if fused.shape[1] != target_size:
            fused = resize(fused, target_size, target_size, "bilinear")
        return fused.clamp(0.0, 1.0)


class MultiFusionSR(nn.Module):
    """Experts (run elsewhere, frozen) + FrequencyAwareFusion."""

    def __init__(self, num_experts: int = 3, upscale: int = 4, use_residual: bool = True,
                 use_multiscale: bool = True):
        super().__init__()
        self.fusion = FrequencyAwareFusion(num_experts, use_residual=use_residual,
                                           use_multiscale=use_multiscale, upscale=upscale)

    def forward(self, lr: torch.Tensor, expert_outputs) -> torch.Tensor:
        return self.fusion(lr, expert_outputs)


class EnhancedMultiFusionSR(nn.Module):
    """The legacy all-improvements wrapper: multi-resolution fusion when enabled, else the
    flat frequency-aware fusion."""

    def __init__(self, num_experts: int = 3, upscale: int = 4,
                 use_multi_resolution: bool = False):
        super().__init__()
        self.use_multi_resolution = use_multi_resolution
        if use_multi_resolution:
            self.multi_res_fusion = MultiResolutionFusion(num_experts)
        else:
            self.fusion = FrequencyAwareFusion(num_experts, upscale=upscale)

    def forward(self, lr: torch.Tensor, expert_outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        expert_list = list(expert_outputs.values())
        if self.use_multi_resolution:
            return self.multi_res_fusion(lr, expert_list, target_size=expert_list[0].shape[1])
        return self.fusion(lr, expert_list)
