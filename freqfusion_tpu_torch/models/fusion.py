"""The fusion head on NHWC tensors. Twin of ``freqfusion_tpu/models/fusion.py``.

The head is a function of (lr, expert_outputs[, expert_features]); running the experts is
``models/experts.py``'s part. Its phases:
  2+3  frequency decomposition (+ cross-band attention)
  4    collaborative feature learning, only when expert features are supplied (serving
       passes none)
  5    hierarchical fusion blended 0.7 / 0.3 with the frequency-weighted sum
  6    dynamic per-pixel expert selection (difficulty-blended, 0.3 weight)
  7    refine_net (0.1-scaled) + learnable bilinear LR residual + clamp, then the optional
       Laplacian edge enhancement

Shipped config: fusion_dim 64, 4 heads, refine 4 x 64, every enable flag true (multi-domain
9-band + LKA + edge). Module and parameter names follow the reference's state-dict keys, so
a ``.pth`` of the head loads with ``load_state_dict``. Kernels B11 and B12 run inside
``cross_band_attn`` (``models/lka.py``); every conv here is a library conv, as the JAX
package leaves the head's convs to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops.kernels import _mma
from ..ops.resize import resize
from ..parallel.mesh import global_batch_mean
from .edge import LaplacianEdgeRefinement
from .frequency import FrequencyDecomposition, MultiDomainFrequency
from .fusion_blocks import (AdaptiveFrequencyBandPredictor, CollaborativeFeatureLearning,
                            CrossBandAttention, DynamicExpertSelector, FrequencyRouter,
                            MultiScaleFeatureExtractor)
from .fusion_variants import MultiResolutionFusion
from .hierarchical import HierarchicalFusion
from .layers import conv_nhwc
from .lka import EnhancedCollaborativeWithLKA, EnhancedCrossBandWithLKA

# A bf16 model's elementwise glue (the experts' weighting, the refine and edge residuals)
# takes its bf16 activations to f32 and rounds its result once, as XLA's fusions do for the
# JAX twin: torch would round every op's output.
f32 = _mma.up

EXPERT_ORDER = ("hat", "dat", "nafnet")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Mirrors the reference MODEL_CONFIG."""

    num_experts: int = 3
    num_bands: int = 3
    block_size: int = 8
    upscale: int = 4
    fusion_dim: int = 64
    num_heads: int = 4
    refine_depth: int = 4
    refine_channels: int = 64
    enable_hierarchical: bool = True
    enable_lka: bool = True
    enable_edge_enhance: bool = True
    enable_multi_domain_freq: bool = True
    enable_dynamic_selection: bool = True
    enable_cross_band_attn: bool = True
    enable_adaptive_bands: bool = True
    enable_multi_resolution: bool = True
    enable_collaborative: bool = True


class RefineNet(nn.Sequential):
    """Phase-7 refinement stack: `depth` 3x3 convs with GELU between them, a Sequential so
    that conv i has the reference key ``refine_net.{2i}``. The head applies it 0.1-scaled,
    with its own ``residual_scale`` for the bilinear LR residual."""

    def __init__(self, depth: int = 4, channels: int = 64):
        layers, cin = [], 3
        for i in range(depth):
            cout = 3 if i == depth - 1 else channels
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            if i < depth - 1:
                layers.append(nn.GELU())
            cin = cout
        super().__init__(*layers)


class FusionHead(nn.Module):
    """``forward(lr, expert_outputs, expert_features=None)`` -> SR [B, 4H, 4W, 3]."""

    def __init__(self, cfg: FusionConfig = FusionConfig()):
        super().__init__()
        self.cfg = cfg
        if cfg.enable_multi_domain_freq:
            self.multi_domain_freq = MultiDomainFrequency(cfg.block_size)
        else:
            self.freq_decomp = FrequencyDecomposition(cfg.block_size)
            if cfg.enable_adaptive_bands:
                self.adaptive_band_predictor = AdaptiveFrequencyBandPredictor()

        if cfg.enable_cross_band_attn:
            if cfg.enable_lka:
                self.cross_band_attn = EnhancedCrossBandWithLKA(
                    dim=cfg.fusion_dim,
                    num_bands=9 if cfg.enable_multi_domain_freq else cfg.num_bands,
                    num_heads=cfg.num_heads)
            else:
                self.cross_band_attn = CrossBandAttention(dim=cfg.fusion_dim,
                                                          num_heads=cfg.num_heads)

        if cfg.enable_collaborative:
            collab = (EnhancedCollaborativeWithLKA if cfg.enable_lka
                      else CollaborativeFeatureLearning)
            self.collaborative = collab(num_experts=cfg.num_experts,
                                        feature_dim=cfg.fusion_dim * 2,
                                        num_heads=cfg.num_heads * 2)

        # Phase 5: hierarchical -> flat multi-resolution -> flat router fusion
        if cfg.enable_hierarchical:
            self.multi_res_fusion = HierarchicalFusion(num_experts=cfg.num_experts,
                                                       base_channels=cfg.fusion_dim)
        elif cfg.enable_multi_resolution:
            self.multi_res_fusion = MultiResolutionFusion(num_experts=cfg.num_experts,
                                                          base_channels=cfg.fusion_dim)
        else:
            self.freq_router = FrequencyRouter(num_experts=cfg.num_experts,
                                               num_bands=cfg.num_bands)

        # always created, as in the reference; only the flat-router branch reads them
        self.expert_weights = nn.Parameter(torch.ones(cfg.num_experts, cfg.num_bands))
        self.band_importance = nn.Parameter(torch.ones(cfg.num_bands))

        if cfg.enable_dynamic_selection:   # the routing features feed the selector alone
            self.multiscale = MultiScaleFeatureExtractor(out_channels=cfg.fusion_dim)
            self.dynamic_selector = DynamicExpertSelector(hidden_dim=cfg.fusion_dim,
                                                          num_experts=cfg.num_experts)
        self.refine_net = RefineNet(cfg.refine_depth, cfg.refine_channels)
        self.residual_scale = nn.Parameter(torch.tensor(0.1))
        self.edge_refine = LaplacianEdgeRefinement() if cfg.enable_edge_enhance else None

    @property
    def takes_batch_mean(self) -> bool:
        """Whether a forward couples the images of its batch (the adaptive-band split's
        batch mean, reached with the multi-domain bands off)."""
        return not self.cfg.enable_multi_domain_freq and self.cfg.enable_adaptive_bands

    # ----- Phase 2+3 ------------------------------------------------------
    def process_frequency_bands(self, lr: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        if cfg.enable_multi_domain_freq:
            raw = self.multi_domain_freq.decompose(lr)
            if cfg.enable_cross_band_attn:
                raw = self.cross_band_attn(raw)
            return self.multi_domain_freq.band_fusion(raw)

        if cfg.enable_adaptive_bands:
            low_split, high_split = self.adaptive_band_predictor(lr)
            b = lr.shape[0]
            # batch-mean splits, as the reference's .item() calls; on a mesh the global
            # batch's, as the JAX twin's mean under a sharded jit
            low, mid, high = self.freq_decomp.adaptive(
                lr, global_batch_mean(low_split).expand(b),
                global_batch_mean(high_split).expand(b))
            low_scale = (low_split / 0.25).reshape(b, 1, 1, 1)
            high_scale = ((1.0 - high_split) / 0.25).reshape(b, 1, 1, 1)
            mid_scale = 1.0 + 0.1 * (1.0 - low_scale - high_scale)
            low = low * (0.9 + 0.2 * torch.sigmoid(low_scale - 1.0))
            mid = mid * (0.9 + 0.2 * torch.sigmoid(mid_scale - 1.0))
            high = high * (0.9 + 0.2 * torch.sigmoid(high_scale - 1.0))
        else:
            low, mid, high = self.freq_decomp(lr)
        bands = [low, mid, high]
        if cfg.enable_cross_band_attn:
            bands = self.cross_band_attn(bands)
        return bands

    # ----- Phase 5+6 ------------------------------------------------------
    def fuse_experts(self, lr: torch.Tensor, expert_outputs: Dict[str, torch.Tensor],
                     bands: List[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        h_hr, w_hr = lr.shape[1] * cfg.upscale, lr.shape[2] * cfg.upscale
        names = EXPERT_ORDER[: cfg.num_experts]
        stack = torch.stack([f32(expert_outputs[n]) for n in names], dim=-2)   # [B,H,W,E,3]

        mags = [f32(b).abs().mean(dim=-1, keepdim=True) for b in bands]
        freq_sum = mags[0] + mags[1] + mags[2] + 1e-8
        # [high -> HAT, mid -> DAT, low -> NAFNet]
        guidance = torch.cat([mags[2] / freq_sum, mags[1] / freq_sum, mags[0] / freq_sum], -1)
        guidance_hr = resize(guidance, h_hr, w_hr, "bilinear")
        freq_weighted = (stack * guidance_hr[..., None]).sum(dim=-2)

        if cfg.enable_hierarchical:
            fused = f32(self.multi_res_fusion({n: expert_outputs[n] for n in names}))
            fused = fused * 0.7 + freq_weighted * 0.3
        elif cfg.enable_multi_resolution:   # the flat 64 / 128 / full-size baseline
            fused = f32(self.multi_res_fusion(lr, [expert_outputs[n] for n in names]))
            fused = fused * 0.7 + freq_weighted * 0.3
        else:
            # flat router fusion, routed from the LR image the router was built for
            routing = f32(self.freq_router(lr))                           # [B,H,W,E,bands]
            weighted = routing * self.expert_weights * torch.softmax(self.band_importance, 0)
            agg = weighted.sum(dim=-1)                                    # [B,H,W,E]
            agg = agg / (agg.sum(dim=-1, keepdim=True) + 1e-8)
            fused = (stack * resize(agg, h_hr, w_hr, "bilinear")[..., None]).sum(dim=-2)

        if cfg.enable_dynamic_selection:
            gates, difficulty = self.dynamic_selector(lr, self.multiscale(lr))
            gates_hr = resize(f32(gates), h_hr, w_hr, "bilinear")
            gated = (stack * gates_hr[..., None]).sum(dim=-2)
            dynamic_fused = gated / (gates_hr.sum(dim=-1, keepdim=True) + 1e-8)
            difficulty_hr = resize(f32(difficulty), h_hr, w_hr, "bilinear")
            fused = (fused * (1.0 - 0.3 * difficulty_hr)
                     + dynamic_fused * (0.3 * difficulty_hr))
        return fused.to(lr.dtype)

    def refine(self, fused: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        up = resize(f32(lr), fused.shape[1], fused.shape[2], "bilinear")
        out = f32(fused) + 0.1 * f32(conv_nhwc(self.refine_net, fused))
        return (out + self.residual_scale * up).clamp(0.0, 1.0).to(fused.dtype)

    def forward(self, lr: torch.Tensor, expert_outputs: Dict[str, torch.Tensor],
                expert_features: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        cfg = self.cfg
        bands = self.process_frequency_bands(lr)
        # collaborative runs whenever features are supplied; the serving path passes none
        if cfg.enable_collaborative and expert_features is not None:
            names = EXPERT_ORDER[: cfg.num_experts]
            enhanced = self.collaborative(expert_features, [expert_outputs[n] for n in names])
            expert_outputs = dict(zip(names, enhanced))
        fused = self.refine(self.fuse_experts(lr, expert_outputs, bands), lr)
        if self.edge_refine is not None:
            fused = self.edge_refine(fused)
        return fused
