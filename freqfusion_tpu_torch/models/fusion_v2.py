"""The alternate V2 fusion head (about 167 K parameters) on NHWC tensors. Twin of
``freqfusion_tpu/models/fusion_v2.py``.

V2 is a compact self-contained head with its own block set: an adaptive DCT decomposition
whose low / high zigzag thresholds an 8x8-pooled MLP predicts per image (soft sigmoid gates
over the normalised zigzag index), ``CrossBandAttentionV2``,
``CollaborativeFeatureLearningV2``, ``MultiResolutionFusionV2`` and
``DynamicExpertSelectorV2``. It is exported beside the shipped ``FusionHead`` and used by no
shipped checkpoint. Module names are the reference's state-dict keys, which
``utils/convert.py:v2_key`` gives the JAX modules' parameters. No kernel runs here: every
conv is a library conv and the attention a plain product, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import dct as dct_ops
from ..ops.resize import resize
from .layers import TorchMHA, conv1x1_nhwc, conv_nhwc

EXPERT_NAMES = ("hat", "dat", "nafnet")


def run_nhwc(seq: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """A Sequential of Conv2d and elementwise layers applied to an NHWC tensor: each conv
    as a library conv (a 1x1 as the product over channels it is)."""
    for m in seq:
        if isinstance(m, nn.Conv2d):
            x = conv1x1_nhwc(m, x) if m.kernel_size == (1, 1) else conv_nhwc(m, x)
        else:
            x = m(x)
    return x


def _conv_stack(cin: int, hidden: int, cout: int, last_kernel: int) -> nn.Sequential:
    """conv3x3 -> ReLU -> conv3x3 -> ReLU -> conv(last_kernel): keys .0, .2, .4."""
    return nn.Sequential(nn.Conv2d(cin, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, hidden, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(hidden, cout, last_kernel, padding=last_kernel // 2))


class AdaptiveFrequencyDecompositionV2(nn.Module):
    """Per-image learnable-threshold DCT banding. ``forward(x)`` -> (low, mid, high,
    (low_t, high_t))."""

    def __init__(self, block_size: int = 8, sharpness: float = 50.0, in_channels: int = 3):
        super().__init__()
        self.block_size, self.sharpness = block_size, sharpness
        # the pool is the JAX twin's `_adaptive_avg_pool` (torch's bins), the flatten
        # channel-major, over NCHW
        self.threshold_predictor = nn.Sequential(
            nn.AdaptiveAvgPool2d(8), nn.Flatten(), nn.Linear(in_channels * 64, 32), nn.ReLU(),
            nn.Linear(32, 2), nn.Sigmoid())

    def forward(self, x: torch.Tensor):
        n = self.block_size
        t = self.threshold_predictor(x.permute(0, 3, 1, 2))
        low_t = 0.15 + t[:, 0] * (0.40 - 0.15)
        high_t = 0.60 + t[:, 1] * (0.85 - 0.60)

        zz = torch.from_numpy(dct_ops.zigzag_indices(n)).to(x) / (n * n - 1)
        low_m = torch.sigmoid((low_t[:, None, None] - zz) * self.sharpness)
        high_m = torch.sigmoid((zz - high_t[:, None, None]) * self.sharpness)
        mid_m = (1.0 - low_m - high_m).clamp(0.0, 1.0)

        xp, (hh, ww) = dct_ops.reflect_pad_to_block(x, n)
        blocks = dct_ops.blockify(xp, n)
        coeffs = dct_ops.dct2d(blocks.reshape(*blocks.shape[:-1], n, n), n)
        bands = []
        for m in (low_m, mid_m, high_m):
            band = dct_ops.idct2d(coeffs * m[:, None, None, None], n)
            band = band.reshape(*band.shape[:-2], n * n)
            bands.append(dct_ops.unblockify(band, n)[:, :hh, :ww, :])
        return bands[0], bands[1], bands[2], (low_t, high_t)


class CrossBandAttentionV2(nn.Module):
    """Per-band 1x1 projectors, per-pixel MHA over the 3 band tokens, per-band output
    projectors, softmax(band_gates)-weighted residual."""

    def __init__(self, in_channels: int = 3, hidden_dim: int = 32, num_heads: int = 4):
        super().__init__()
        self.band_projectors = nn.ModuleList(nn.Conv2d(in_channels, hidden_dim, 1)
                                             for _ in range(3))
        self.attention = TorchMHA(hidden_dim, num_heads)
        self.band_gates = nn.Parameter(torch.ones(3))
        self.output_projectors = nn.ModuleList(nn.Conv2d(hidden_dim, in_channels, 1)
                                               for _ in range(3))

    def forward(self, bands: List[torch.Tensor]) -> List[torch.Tensor]:
        projected = [conv1x1_nhwc(p, b) for p, b in zip(self.band_projectors, bands)]
        attn = self.attention(torch.stack(projected, dim=-2))       # [B,H,W,3,hidden]
        w = torch.softmax(self.band_gates, 0)
        return [band + w[i] * conv1x1_nhwc(self.output_projectors[i], attn[..., i, :])
                for i, band in enumerate(bands)]


class CollaborativeFeatureLearningV2(nn.Module):
    """Project -> cross-expert MHA -> mean consensus -> conv refine -> a shared sigmoid
    modulation head on (attn_i + consensus) -> out_i * (1 + 0.2 * mod_i)."""

    def __init__(self, common_dim: int = 128, num_heads: int = 8,
                 expert_channels: Optional[Dict[str, int]] = None):
        super().__init__()
        chans = expert_channels or {"hat": 180, "dat": 180, "nafnet": 64}
        self.names = [n for n in EXPERT_NAMES if n in chans]
        self.feature_projectors = nn.ModuleDict({n: nn.Conv2d(chans[n], common_dim, 1)
                                                 for n in self.names})
        self.cross_expert_attention = TorchMHA(common_dim, num_heads)
        self.feature_refine = nn.Sequential(
            nn.Conv2d(common_dim, common_dim, 3, padding=1), nn.GELU(),
            nn.Conv2d(common_dim, common_dim, 3, padding=1))
        self.modulation_head = nn.Sequential(nn.Conv2d(common_dim, 64, 1), nn.GELU(),
                                             nn.Conv2d(64, 1, 1), nn.Sigmoid())

    def forward(self, expert_features: Dict[str, torch.Tensor],
                expert_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        projected = [conv1x1_nhwc(self.feature_projectors[n], expert_features[n])
                     for n in self.names]
        attn = self.cross_expert_attention(torch.stack(projected, dim=-2))  # [B,H,W,E,C]
        consensus = run_nhwc(self.feature_refine, attn.mean(dim=-2))
        outs = []
        for i, out in enumerate(expert_outputs):
            m = run_nhwc(self.modulation_head, attn[..., i, :] + consensus)
            outs.append(out * (1.0 + 0.2 * resize(m, out.shape[1], out.shape[2], "bilinear")))
        return outs


class MultiResolutionFusionV2(nn.Module):
    """64 / 128 / full-size fusion: 3-conv softmax routers per level and learnable residual
    blending up + w * (direct - up), w_128 = 0.5, w_256 = 0.3."""

    def __init__(self, num_experts: int = 3, base_channels: int = 32):
        super().__init__()
        self.num_experts = num_experts
        for level in (64, 128, 256):
            setattr(self, f"router_{level}", _conv_stack(3, base_channels, num_experts, 1))
        self.res_weight_128 = nn.Parameter(torch.tensor(0.5))
        self.res_weight_256 = nn.Parameter(torch.tensor(0.3))

    def _route(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(run_nhwc(seq, x), dim=-1)

    def forward(self, lr: torch.Tensor, expert_outputs: List[torch.Tensor]) -> torch.Tensor:
        stack = torch.stack(expert_outputs, dim=-2)                 # [B,Hs,Ws,E,3]
        b, hs, ws = stack.shape[:3]

        def experts_at(size):
            flat = resize(stack.reshape(b, hs, ws, -1), size, size, "bilinear")
            return flat.reshape(b, size, size, self.num_experts, 3)

        r64 = self._route(self.router_64, resize(lr, 64, 64, "bilinear"))
        fused_64 = (experts_at(64) * r64[..., None]).sum(dim=-2)

        up = resize(fused_64, 128, 128, "bilinear")
        r128 = self._route(self.router_128, resize(lr, 128, 128, "bilinear"))
        direct = (experts_at(128) * r128[..., None]).sum(dim=-2)
        fused_128 = up + self.res_weight_128 * (direct - up)

        up = resize(fused_128, hs, ws, "bilinear")
        r256 = self._route(self.router_256, resize(lr, hs, ws, "bilinear"))
        direct = (stack * r256[..., None]).sum(dim=-2)
        return up + self.res_weight_256 * (direct - up)


class DynamicExpertSelectorV2(nn.Module):
    """Difficulty CNN; independent sigmoid gates at the difficulty-adaptive threshold
    0.7 - 0.5 d with a learnable temperature; soft normalisation / max(sum g, 0.3).
    ``forward(lr)`` -> (gates [B,H,W,E], difficulty [B,H,W,1])."""

    def __init__(self, hidden_dim: int = 32, num_experts: int = 3):
        super().__init__()
        self.difficulty_net = nn.Sequential(*_conv_stack(3, hidden_dim, 1, 3), nn.Sigmoid())
        self.gate_net = _conv_stack(3, hidden_dim, num_experts, 1)
        self.temperature = nn.Parameter(torch.tensor(10.0))

    def forward(self, lr_input: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        difficulty = run_nhwc(self.difficulty_net, lr_input)
        raw = run_nhwc(self.gate_net, lr_input)
        gates = torch.sigmoid(self.temperature * (raw - (0.7 - 0.5 * difficulty)))
        gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True) + 1e-8, min=0.3)
        return gates, difficulty


class FusionHeadV2(nn.Module):
    """V2's CompleteEnhancedFusionSR with the expert outputs and features as explicit
    inputs: adaptive 3-band decomposition -> cross-band attention -> collaborative learning
    -> multi-resolution fusion (or a 1x1 fallback over the concatenated experts) -> dynamic
    selection blended at 0.3 + 0.4 * difficulty -> refine net (0.1) + bilinear residual.

    ``forward(lr, expert_outputs, expert_features=None)`` -> SR [B, Hr, Wr, 3] in [0, 1].
    Dropout (the MHAs' attention probabilities) acts in training mode only.

    V2 computes the enhanced bands and never feeds them into the fusion (the reference
    only returns them as intermediates); mirrored as the JAX twin does."""

    def __init__(self, num_experts: int = 3, block_size: int = 8, upscale: int = 4,
                 enable_dynamic_selection: bool = True, enable_cross_band_attn: bool = True,
                 enable_adaptive_bands: bool = True, enable_multi_resolution: bool = True,
                 enable_collaborative: bool = True):
        super().__init__()
        self.num_experts, self.upscale = num_experts, upscale
        self.enable_dynamic_selection = enable_dynamic_selection
        self.enable_cross_band_attn = enable_cross_band_attn
        self.enable_adaptive_bands = enable_adaptive_bands
        self.enable_multi_resolution = enable_multi_resolution
        self.enable_collaborative = enable_collaborative
        if enable_adaptive_bands:
            self.freq_decomp = AdaptiveFrequencyDecompositionV2(block_size)
        if enable_cross_band_attn:
            self.cross_band = CrossBandAttentionV2()
        if enable_collaborative:
            self.collaborative = CollaborativeFeatureLearningV2()
        if enable_multi_resolution:
            self.multi_res = MultiResolutionFusionV2(num_experts)
        else:
            self.simple_fusion = nn.Conv2d(3 * num_experts, 3, 1)
        if enable_dynamic_selection:
            self.dynamic_selector = DynamicExpertSelectorV2(num_experts=num_experts)
        self.refine = _conv_stack(3, 64, 3, 3)
        self.residual_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, lr: torch.Tensor, expert_outputs: Dict[str, torch.Tensor],
                expert_features: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        experts = [expert_outputs[n] for n in EXPERT_NAMES[: self.num_experts]]
        h_hr, w_hr = experts[0].shape[1], experts[0].shape[2]

        bands = None
        if self.enable_adaptive_bands:
            bands = list(self.freq_decomp(lr)[:3])
        if self.enable_cross_band_attn and bands is not None:
            bands = self.cross_band(bands)   # computed, never fused (see the docstring)

        if self.enable_collaborative and expert_features is not None:
            experts = self.collaborative(expert_features, experts)

        if self.enable_multi_resolution:
            fused = self.multi_res(lr, experts)
        else:
            fused = conv1x1_nhwc(self.simple_fusion, torch.cat(experts, dim=-1))

        if self.enable_dynamic_selection:
            gates, difficulty = self.dynamic_selector(lr)
            gates_hr = resize(gates, h_hr, w_hr, "bilinear")
            stack = torch.stack(experts, dim=-2)
            dyn = (stack * gates_hr[..., None]).sum(dim=-2) / (
                gates_hr.sum(dim=-1, keepdim=True) + 1e-8)
            blend = 0.3 + 0.4 * resize(difficulty, h_hr, w_hr, "bilinear")
            fused = (1.0 - blend) * fused + blend * dyn

        fused = fused + 0.1 * run_nhwc(self.refine, fused)
        fused = fused + self.residual_scale * resize(lr, h_hr, w_hr, "bilinear")
        return fused.clamp(0.0, 1.0)
