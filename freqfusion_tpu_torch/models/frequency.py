"""Frequency decomposition stack on NHWC tensors. Twin of
``freqfusion_tpu/models/frequency.py``.

- ``MultiDomainFrequency``: the production 9-band decomposition, block-DCT thirds (3) +
  db4 DWT subbands (4) + learnable-mask rFFT split (2), and the gated 9 -> 3
  ``AdaptiveBandFusion``.
- ``FrequencyDecomposition``: the baseline 3-band block-DCT path, with optional soft
  adaptive split masks (sigmoid sharpness 50).

Module and parameter names follow the reference's state-dict keys. The DCT banding is one
[64,192] product (``ops/dct.py``), the DWT two depthwise strided convs, and the FFT split
uses ``torch.fft.rfft2`` / ``irfft2`` with ``norm="ortho"`` over H and W.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dct as dct_ops
from ..ops.resize import resize
from .layers import conv1x1_nhwc

# Daubechies db4 decomposition filters (standard published coefficients).
DB4_LO = np.array([
    -0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
    -0.18703481171888114, -0.027983769416983849, 0.63088076792959036,
    0.71484657055291582, 0.23037781330885523], dtype=np.float32)
DB4_HI = np.array([
    -0.23037781330885523, 0.71484657055291582, -0.63088076792959036,
    -0.027983769416983849, 0.18703481171888114, 0.030841381835986965,
    -0.032883011666982945, -0.010597401784997278], dtype=np.float32)


class DCTThirds(nn.Module):
    """8x8 block-DCT -> 3 zigzag-third bands, learnable per-band scale."""

    def __init__(self, block_size: int = 8):
        super().__init__()
        self.block_size = block_size
        self.band_scale = nn.Parameter(torch.ones(3))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        op = dct_ops.band_operator(self.block_size, "thirds")
        bands = dct_ops.block_dct_bands(x, op, self.block_size, 3)
        return [b * self.band_scale[i] for i, b in enumerate(bands)]


def _dwt_conv(x: torch.Tensor, filt: np.ndarray, axis: int) -> torch.Tensor:
    """Depthwise stride-2 conv of an NCHW tensor along H (axis=2) or W (axis=3) with
    reflect padding of len - 1 a side (cross-correlation, as F.conv2d)."""
    c, n = x.shape[1], len(filt)
    f = torch.from_numpy(filt).to(device=x.device, dtype=x.dtype)
    if axis == 2:
        xp = F.pad(x, (0, 0, n - 1, n - 1), mode="reflect")
        return F.conv2d(xp, f.reshape(1, 1, n, 1).expand(c, 1, n, 1), stride=(2, 1), groups=c)
    xp = F.pad(x, (n - 1, n - 1, 0, 0), mode="reflect")
    return F.conv2d(xp, f.reshape(1, 1, 1, n).expand(c, 1, 1, n), stride=(1, 2), groups=c)


class DWTDb4(nn.Module):
    """Single-level separable db4 DWT -> [LL, LH, HL, HH], each bilinearly upsampled back
    to the input resolution, learnable per-subband scale."""

    def __init__(self):
        super().__init__()
        self.subband_scale = nn.Parameter(torch.ones(4))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, w = x.shape[1], x.shape[2]
        xc = x.permute(0, 3, 1, 2)
        lo_r = _dwt_conv(xc, DB4_LO, axis=3)
        hi_r = _dwt_conv(xc, DB4_HI, axis=3)
        subbands = [_dwt_conv(lo_r, DB4_LO, axis=2), _dwt_conv(lo_r, DB4_HI, axis=2),
                    _dwt_conv(hi_r, DB4_LO, axis=2), _dwt_conv(hi_r, DB4_HI, axis=2)]
        return [resize(sb.permute(0, 2, 3, 1), h, w, "bilinear") * self.subband_scale[i]
                for i, sb in enumerate(subbands)]


def _radial_lowpass_logits(size: int) -> np.ndarray:
    g = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    yy, xx = np.meshgrid(g, g, indexing="ij")
    r = np.sqrt(xx**2 + yy**2)
    return (3.0 * (0.5 - r)).astype(np.float32)[None, None]


class FFTSplit(nn.Module):
    """rFFT2 low / high split with a learnable sigmoid mask, resized to the half spectrum.
    ``freq_mask_logits`` is [1,1,S,S] as in the reference."""

    def __init__(self, mask_size: int = 64):
        super().__init__()
        self.freq_mask_logits = nn.Parameter(
            torch.from_numpy(_radial_lowpass_logits(mask_size)))
        self.temperature = nn.Parameter(torch.tensor(5.0))
        self.band_scale = nn.Parameter(torch.ones(2))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h, w = x.shape[1], x.shape[2]
        spec = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")      # [B, H, W//2+1, C]
        mask = F.interpolate(self.freq_mask_logits, size=(spec.shape[1], spec.shape[2]),
                             mode="bilinear", align_corners=False)
        mask = torch.sigmoid(mask * self.temperature.clamp(min=1.0))[0, 0, :, :, None]
        low = torch.fft.irfft2(spec * mask, s=(h, w), dim=(1, 2), norm="ortho")
        high = torch.fft.irfft2(spec * (1.0 - mask), s=(h, w), dim=(1, 2), norm="ortho")
        return [low * self.band_scale[0], high * self.band_scale[1]]


class BandSpatialAttention(nn.Module):
    """Per-band 3x3 conv -> sigmoid spatial gate; the conv sits in a Sequential for the
    reference key ``conv.0``. ``AdaptiveBandFusion`` runs the nine of them as one grouped
    conv."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(in_channels, 1, 3, padding=1))


class AdaptiveBandFusion(nn.Module):
    """Gated 9 -> 3 band fusion with softplus-normalised domain importance and a
    0.3-weighted DCT residual."""

    def __init__(self, hidden: int = 64, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.dct_importance = nn.Parameter(torch.ones(3))
        self.dwt_importance = nn.Parameter(torch.full((4,), 0.8))
        self.fft_importance = nn.Parameter(torch.full((2,), 0.6))
        self.band_attention = nn.ModuleList(BandSpatialAttention(in_channels) for _ in range(9))
        cat, out = 9 * in_channels, 3 * in_channels
        self.fusion_transform = nn.Sequential(nn.Conv2d(cat, hidden, 1), nn.GELU(),
                                              nn.Conv2d(hidden, out, 1))
        self.fusion_gate = nn.Sequential(nn.Conv2d(cat, hidden, 1), nn.GELU(),
                                         nn.Conv2d(hidden, out, 1))
        self.dct_residual = nn.Conv2d(out, out, 1)

    def forward(self, bands: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(bands) != 9:
            raise ValueError(f"AdaptiveBandFusion takes 9 bands, got {len(bands)}")
        cin = self.in_channels
        imp = F.softplus(torch.cat([self.dct_importance, self.dwt_importance,
                                    self.fft_importance]))
        imp = imp / (imp.sum() + 1e-8)
        concat_b = torch.cat(list(bands), dim=-1)                       # [B,H,W,27]
        # the nine per-band 3 -> 1 convs as one conv of nine groups
        wt = torch.cat([m.conv[0].weight for m in self.band_attention])  # [9,cin,3,3]
        bs = torch.cat([m.conv[0].bias for m in self.band_attention])
        att = torch.sigmoid(F.conv2d(concat_b.permute(0, 3, 1, 2), wt, bs, padding=1,
                                     groups=9)).permute(0, 2, 3, 1)     # [B,H,W,9]
        gates = (att * imp).repeat_interleave(cin, dim=-1)
        concat = concat_b * gates

        def mlp(seq, t):
            return conv1x1_nhwc(seq[2], F.gelu(conv1x1_nhwc(seq[0], t)))

        fused = mlp(self.fusion_transform, concat) * torch.sigmoid(mlp(self.fusion_gate, concat))
        dct_concat = torch.cat(list(bands[:3]), dim=-1)
        fused = fused + conv1x1_nhwc(self.dct_residual, dct_concat) * 0.3
        return list(fused.split(cin, dim=-1))


class MultiDomainFrequency(nn.Module):
    """DCT(3) + DWT(4) + FFT(2) = 9 raw bands; ``band_fusion`` -> 3 guidance bands."""

    def __init__(self, block_size: int = 8, fft_mask_size: int = 64):
        super().__init__()
        self.dct = DCTThirds(block_size)
        self.dwt = DWTDb4()
        self.fft = FFTSplit(fft_mask_size)
        self.band_fusion = AdaptiveBandFusion()

    def decompose(self, x: torch.Tensor) -> List[torch.Tensor]:
        return list(self.dct(x)) + list(self.dwt(x)) + list(self.fft(x))

    def forward(self, x: torch.Tensor, return_raw: bool = False):
        raw = self.decompose(x)
        fused = self.band_fusion(raw)
        return (fused, raw) if return_raw else (fused, None)


class FrequencyDecomposition(nn.Module):
    """Baseline 3-band block-DCT decomposition (no parameters).

    ``forward(x)`` uses the fixed ratio masks; ``adaptive(x, low_split, high_split)`` builds
    per-sample soft sigmoid masks (sharpness 50) from split tensors [B]."""

    def __init__(self, block_size: int = 8, low_ratio: float = 0.25, high_ratio: float = 0.25):
        super().__init__()
        self.block_size, self.low_ratio, self.high_ratio = block_size, low_ratio, high_ratio

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        op = dct_ops.band_operator(self.block_size, "ratio", self.low_ratio, self.high_ratio)
        return tuple(dct_ops.block_dct_bands(x, op, self.block_size, 3))

    def adaptive(self, x: torch.Tensor, low_split: torch.Tensor, high_split: torch.Tensor):
        n = self.block_size
        low_split = low_split.clamp(0.15, 0.40).reshape(-1, 1, 1)
        high_split = high_split.clamp(0.60, 0.85).reshape(-1, 1, 1)
        zz = torch.from_numpy(dct_ops.zigzag_indices(n).astype(np.float32)).to(x) / (n * n)
        low_mask = torch.sigmoid((low_split - zz) * 50.0)    # [B,n,n]
        high_mask = torch.sigmoid((zz - high_split) * 50.0)
        mid_mask = (1.0 - low_mask - high_mask).clamp(0.0, 1.0)

        xp, (h, w) = dct_ops.reflect_pad_to_block(x, n)
        blocks = dct_ops.blockify(xp, n)
        coeffs = dct_ops.dct2d(blocks.reshape(*blocks.shape[:-1], n, n), n)
        outs = []
        for m in (low_mask, mid_mask, high_mask):
            band = dct_ops.idct2d(coeffs * m[:, None, None, None], n)
            band = band.reshape(*band.shape[:-2], n * n)
            outs.append(dct_ops.unblockify(band, n)[:, :h, :w, :])
        return tuple(outs)

    @staticmethod
    def reconstruct(low, mid, high):
        return low + mid + high
