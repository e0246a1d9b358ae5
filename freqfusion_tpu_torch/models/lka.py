"""Large Kernel Attention stack on NHWC tensors. Twin of ``freqfusion_tpu/models/lka.py``.

The 21x21 receptive field decomposed as 5x5 DW -> 1x21 DW -> 21x1 DW -> 1x1 PW -> BN ->
sigmoid gate, the LKABlock residual wrapper, and the two fusion modules built on it
(cross-band and collaborative attention with LKA refinement). Module and parameter names
follow the reference's state-dict keys.

In eval mode with ``kernels = True`` the gate runs kernel B12 (``ops/kernels/lka.py``) for
any batch and any C, and the per-pixel band attention runs kernel B11
(``ops/kernels/bandmha.py``); ``kernels = False`` runs their plain versions on any device,
to compare the two. Training mode runs plain torch ops with BatchNorm's batch statistics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import layernorm
from ..ops.kernels.bandmha import fused_band_mha, fused_band_mha_plain
from ..ops.kernels.lka import lka_gate, lka_gate_plain
from ..ops.resize import resize
from .layers import BatchNorm2d, TorchMHA, conv1x1_nhwc, conv_nhwc, gelu


def bn_nhwc(bn: BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm on an NHWC tensor: the folded affine in eval mode, the module (batch
    statistics, running-statistics update) in training mode."""
    if bn.training:
        return conv_nhwc(bn, x)
    scale, shift = bn.affine_eval()
    return x * scale + shift


class LargeKernelAttention(nn.Module):
    """Decomposed large-kernel spatial gate (all depthwise but the 1x1)."""

    def __init__(self, dim: int, kernel_size: int = 21):
        super().__init__()
        k = kernel_size
        self.dim, self.kernel_size = dim, k
        self.local_conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)
        self.h_conv = nn.Conv2d(dim, dim, (1, k), padding=(0, k // 2), groups=dim, bias=False)
        self.v_conv = nn.Conv2d(dim, dim, (k, 1), padding=(k // 2, 0), groups=dim, bias=False)
        self.pw_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.bn = BatchNorm2d(dim)
        self.kernels = True

    def raw(self):
        """(w5 [5,5,C], wh [k,C], wv [k,C], wp [C,C] as ``a @ wp``) for kernel B12; wp is a
        view of the parameter, so that the kernel's split weights are kept on it."""
        d, k = self.dim, self.kernel_size
        return (self.local_conv.weight.reshape(d, 5, 5).permute(1, 2, 0).contiguous(),
                self.h_conv.weight.reshape(d, k).t().contiguous(),
                self.v_conv.weight.reshape(d, k).t().contiguous(),
                self.pw_conv.weight.reshape(d, d).t())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.kernel_size == 21:
            gate = lka_gate if self.kernels else lka_gate_plain
            return gate(x.contiguous(), *self.raw(), *self.bn.affine_eval())
        attn = self.v_conv(self.h_conv(self.local_conv(x.permute(0, 3, 1, 2))))
        attn = self.bn(self.pw_conv(attn)).permute(0, 2, 3, 1)
        return x * torch.sigmoid(attn)


class LKABlock(nn.Module):
    """BN -> LKA -> + scale1 * residual, BN -> FFN(2x) -> + scale2 * residual."""

    def __init__(self, dim: int, kernel_size: int = 21, ffn_ratio: float = 2.0):
        super().__init__()
        ffn_dim = int(dim * ffn_ratio)
        self.norm1 = BatchNorm2d(dim)
        self.lka = LargeKernelAttention(dim, kernel_size)
        self.norm2 = BatchNorm2d(dim)
        self.ffn = nn.Sequential(nn.Conv2d(dim, ffn_dim, 1), nn.GELU(),
                                 nn.Conv2d(ffn_dim, dim, 1))
        self.scale1 = nn.Parameter(torch.tensor(0.1))
        self.scale2 = nn.Parameter(torch.tensor(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.scale1 * self.lka(bn_nhwc(self.norm1, x))
        h = conv1x1_nhwc(self.ffn[0], bn_nhwc(self.norm2, x))
        return x + self.scale2 * conv1x1_nhwc(self.ffn[2], gelu(h))


class EnhancedCrossBandWithLKA(nn.Module):
    """Cross-band per-pixel MHA + shared LKA refinement per band.

    ``forward(list of [B,H,W,3] x num_bands)`` -> the same shapes. The per-pixel MHA treats
    the bands as tokens: [B,H,W,bands,dim]."""

    def __init__(self, dim: int = 64, num_bands: int = 9, num_heads: int = 4,
                 lka_kernel: int = 21):
        super().__init__()
        self.dim, self.num_bands, self.num_heads = dim, num_bands, num_heads
        self.band_proj = nn.Conv2d(3, dim, 1)
        self.band_attention = TorchMHA(dim, num_heads)
        self.norm = nn.LayerNorm(dim)
        self.lka_block = LKABlock(dim, lka_kernel)
        self.out_proj = nn.Conv2d(dim, 3, 1)
        self.kernels = True

    def forward(self, bands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        projected = torch.stack([conv1x1_nhwc(self.band_proj, b) for b in bands], dim=-2)
        mha = self.band_attention
        if self.training:
            attn = mha(layernorm(projected, self.norm.weight, self.norm.bias)) + projected
            return [conv1x1_nhwc(self.out_proj, self.lka_block(attn[..., i, :])) + band
                    for i, band in enumerate(bands)]
        band_mha = fused_band_mha if self.kernels else fused_band_mha_plain
        attn = band_mha(projected.contiguous(), *mha.raw(), self.norm.weight, self.norm.bias,
                        self.num_heads)
        # eval: the bands folded into the batch, one LKA / out_proj call at 9x the batch
        # (BN is a fixed affine in eval and the weights are shared across bands)
        b, h, w, nb, d = attn.shape
        flat = attn.permute(3, 0, 1, 2, 4).reshape(nb * b, h, w, d).contiguous()
        feats = conv1x1_nhwc(self.out_proj, self.lka_block(flat)).reshape(nb, b, h, w, 3)
        return [feats[i] + band for i, band in enumerate(bands)]


class EnhancedCollaborativeWithLKA(nn.Module):
    """Cross-expert per-pixel MHA + FFN + shared LKA + per-expert global modulation of the
    SR outputs: out * (1 + 0.2 * (sigmoid - 0.5)), clamped. Serving does not run it: the
    head calls it only when expert features are supplied."""

    NAMES = ("hat", "dat", "nafnet")

    def __init__(self, num_experts: int = 3, feature_dim: int = 128, num_heads: int = 8,
                 lka_kernel: int = 21, expert_channels: Optional[Dict[str, int]] = None):
        super().__init__()
        self.names = self.NAMES[:num_experts]
        self.chans = expert_channels or {"hat": 180, "dat": 180, "nafnet": 64}
        fd = feature_dim
        self.align_layers = nn.ModuleDict(
            {n: nn.Conv2d(self.chans[n], fd, 1) for n in self.names})
        self.norm1 = nn.LayerNorm(fd)
        self.cross_attn = TorchMHA(fd, num_heads)
        self.norm2 = nn.LayerNorm(fd)
        self.ffn = nn.Sequential(nn.Linear(fd, fd * 2), nn.GELU(), nn.Linear(fd * 2, fd))
        self.lka_global = LKABlock(fd, lka_kernel)
        # Sequential(conv, GELU, pool, conv, Sigmoid) in the reference: keys `.0` and `.3`
        self.modulation = nn.ModuleList(
            nn.Sequential(nn.Conv2d(fd, fd // 4, 1), nn.GELU(), nn.AdaptiveAvgPool2d(1),
                          nn.Conv2d(fd // 4, 3, 1)) for _ in range(num_experts))

    def forward(self, expert_features: Dict[str, torch.Tensor],
                expert_outputs: List[torch.Tensor]) -> List[torch.Tensor]:
        min_h = min(expert_features[n].shape[1] for n in self.names)
        min_w = min(expert_features[n].shape[2] for n in self.names)
        aligned = []
        for n in self.names:
            feat, expected = expert_features[n], self.chans[n]
            if feat.shape[-1] > expected:     # truncate / zero-pad a channel mismatch
                feat = feat[..., :expected]
            elif feat.shape[-1] < expected:
                feat = F.pad(feat, (0, expected - feat.shape[-1]))
            a = conv1x1_nhwc(self.align_layers[n], feat)
            if a.shape[1] != min_h or a.shape[2] != min_w:
                a = resize(a, min_h, min_w, "bilinear")
            aligned.append(a)

        stacked = torch.stack(aligned, dim=-2)   # [B,H,W,E,C]
        stacked = stacked + self.cross_attn(self.norm1(stacked))
        stacked = stacked + self.ffn(self.norm2(stacked))

        if self.training:
            feats = [self.lka_global(stacked[..., i, :]) for i in range(len(expert_outputs))]
        else:   # eval: one batched LKA over the expert axis
            b, h, w, e, d = stacked.shape
            flat = stacked.permute(3, 0, 1, 2, 4).reshape(e * b, h, w, d)
            feats = list(self.lka_global(flat).reshape(e, b, h, w, d))
        h_sr, w_sr = expert_outputs[0].shape[1], expert_outputs[0].shape[2]
        outs = []
        for i, out in enumerate(expert_outputs):
            mod = self.modulation[i]
            m = gelu(conv1x1_nhwc(mod[0], resize(feats[i], h_sr, w_sr, "bilinear")))
            m = torch.sigmoid(conv1x1_nhwc(mod[3], m.mean(dim=(1, 2), keepdim=True)))
            outs.append((out * (1.0 + 0.2 * (m - 0.5))).clamp(0.0, 1.0))
        return outs
