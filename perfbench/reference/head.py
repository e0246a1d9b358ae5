"""The fusion head of NTIRE 2026 Team 29 (Nikhil-AI-Labs/image-super-resolution-2), in plain
PyTorch on NCHW tensors, as it serves: eval mode, no expert features (the collaborative
module does not run), every flag of the shipped configuration on.

  bands   8x8 block DCT in zigzag thirds (3), one level of the db4 DWT (4, each resized back),
          a learnable-mask rFFT split (2); cross-band attention over the 9 bands at each pixel
          and a large-kernel-attention block on each; the gated 9 -> 3 band fusion
  fuse    hierarchical 1/4 -> 1/2 -> 1 fusion of the expert images, blended 0.7 / 0.3 with
          the band-guided weighting; the per-pixel expert selector, blended by difficulty
  refine  0.1-scaled 4-conv refinement and the bilinear LR residual, clamp, then the
          Laplacian-pyramid edge enhancement

``forward`` returns the guidance bands, the fused image before the refinement and its
clamp, and the output. Parameter names are the published state-dict keys; the DCT basis,
the zigzag order, the db4 taps and the blur window are computed here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import bn, conv, conv_w, gelu, lin, ln, mm, resize

DB4_LO = (-0.010597401784997278, 0.032883011666982945, 0.030841381835986965,
          -0.18703481171888114, -0.027983769416983849, 0.63088076792959036,
          0.71484657055291582, 0.23037781330885523)
DB4_HI = (-0.23037781330885523, 0.71484657055291582, -0.63088076792959036,
          -0.027983769416983849, 0.18703481171888114, 0.030841381835986965,
          -0.032883011666982945, -0.010597401784997278)


def zigzag(n):
    """JPEG zigzag rank of each (i, j) of an n x n block."""
    cells = sorted(((i, j) for i in range(n) for j in range(n)),
                   key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else -p[0]))
    z = np.zeros((n, n), dtype=np.int64)
    for rank, (i, j) in enumerate(cells):
        z[i, j] = rank
    return z


def dct_basis(n):
    k, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    d[0] = 1.0 / math.sqrt(n)
    return d.astype(np.float32)


class DCTThirds(nn.Module):
    def __init__(self, n=8):
        super().__init__()
        self.n = n
        self.band_scale = nn.Parameter(torch.empty(3))

    def forward(self, x):
        n = self.n
        b, c, h, w = x.shape
        xp = F.pad(x, (0, (-w) % n, 0, (-h) % n), mode="reflect")
        hp, wp = xp.shape[2:]
        blocks = xp.view(b, c, hp // n, n, wp // n, n).permute(0, 1, 2, 4, 3, 5)
        d = torch.as_tensor(dct_basis(n), device=x.device)
        coef = mm(mm(d, blocks), d.t())
        z = torch.as_tensor(zigzag(n), device=x.device)
        third = n * n // 3
        masks = [(z < third), (z >= third) & (z < 2 * n * n // 3), (z >= 2 * n * n // 3)]
        out = []
        for k, m in enumerate(masks):
            band = mm(mm(d.t(), coef * m.to(coef.dtype)), d)
            band = band.permute(0, 1, 2, 4, 3, 5).reshape(b, c, hp, wp)[:, :, :h, :w]
            out.append(band * self.band_scale[k])
        return out


class DWTDb4(nn.Module):
    def __init__(self):
        super().__init__()
        self.subband_scale = nn.Parameter(torch.empty(4))

    @staticmethod
    def _filt(x, taps, along_h):
        c, n = x.shape[1], len(taps)
        f = torch.tensor(taps, device=x.device, dtype=x.dtype)
        if along_h:
            xp = F.pad(x, (0, 0, n - 1, n - 1), mode="reflect")
            return conv_w(xp, f.view(1, 1, n, 1).expand(c, 1, n, 1), stride=(2, 1), groups=c)
        xp = F.pad(x, (n - 1, n - 1, 0, 0), mode="reflect")
        return conv_w(xp, f.view(1, 1, 1, n).expand(c, 1, 1, n), stride=(1, 2), groups=c)

    def forward(self, x):
        h, w = x.shape[2:]
        lo, hi = self._filt(x, DB4_LO, False), self._filt(x, DB4_HI, False)
        subs = [self._filt(lo, DB4_LO, True), self._filt(lo, DB4_HI, True),
                self._filt(hi, DB4_LO, True), self._filt(hi, DB4_HI, True)]
        return [resize(s, h, w) * self.subband_scale[i] for i, s in enumerate(subs)]


class FFTSplit(nn.Module):
    def __init__(self, size=64):
        super().__init__()
        self.freq_mask_logits = nn.Parameter(torch.empty(1, 1, size, size))
        self.temperature = nn.Parameter(torch.empty(()))
        self.band_scale = nn.Parameter(torch.empty(2))

    def forward(self, x):
        h, w = x.shape[2:]
        spec = torch.fft.rfft2(x, norm="ortho")
        mask = resize(self.freq_mask_logits, spec.shape[2], spec.shape[3])
        mask = torch.sigmoid(mask * self.temperature.clamp(min=1.0))
        low = torch.fft.irfft2(spec * mask, s=(h, w), norm="ortho")
        high = torch.fft.irfft2(spec * (1.0 - mask), s=(h, w), norm="ortho")
        return [low * self.band_scale[0], high * self.band_scale[1]]


class BandSpatialAttention(nn.Module):
    def __init__(self, cin=3):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, 1, 3, padding=1))


class AdaptiveBandFusion(nn.Module):
    def __init__(self, hidden=64, cin=3):
        super().__init__()
        self.dct_importance = nn.Parameter(torch.empty(3))
        self.dwt_importance = nn.Parameter(torch.empty(4))
        self.fft_importance = nn.Parameter(torch.empty(2))
        self.band_attention = nn.ModuleList(BandSpatialAttention(cin) for _ in range(9))
        self.fusion_transform = nn.Sequential(nn.Conv2d(9 * cin, hidden, 1), nn.GELU(),
                                              nn.Conv2d(hidden, 3 * cin, 1))
        self.fusion_gate = nn.Sequential(nn.Conv2d(9 * cin, hidden, 1), nn.GELU(),
                                         nn.Conv2d(hidden, 3 * cin, 1))
        self.dct_residual = nn.Conv2d(3 * cin, 3 * cin, 1)

    def forward(self, bands):
        imp = F.softplus(torch.cat([self.dct_importance, self.dwt_importance,
                                    self.fft_importance]))
        imp = imp / (imp.sum() + 1e-8)
        gated = [band * torch.sigmoid(conv(band, m.conv[0])) * imp[i]
                 for i, (band, m) in enumerate(zip(bands, self.band_attention))]
        cat = torch.cat(gated, dim=1)
        ft, fg = self.fusion_transform, self.fusion_gate
        fused = conv(gelu(conv(cat, ft[0])), ft[2]) * torch.sigmoid(conv(gelu(conv(cat, fg[0])),
                                                                          fg[2]))
        fused = fused + conv(torch.cat(bands[:3], dim=1), self.dct_residual) * 0.3
        return list(fused.split(3, dim=1))


class MultiDomainFrequency(nn.Module):
    def __init__(self, block=8):
        super().__init__()
        self.dct, self.dwt, self.fft = DCTThirds(block), DWTDb4(), FFTSplit()
        self.band_fusion = AdaptiveBandFusion()


class MHA(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj), attention over axis -2."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        *lead, t, d = x.shape
        hd = d // self.heads
        qkv = mm(x, self.in_proj_weight.t()) + self.in_proj_bias
        qkv = qkv.reshape(-1, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = mm(qkv[0] * hd ** -0.5, qkv[1].transpose(-2, -1)).softmax(dim=-1)
        out = mm(attn, qkv[2]).transpose(1, 2).reshape(*lead, t, d)
        return lin(out, self.out_proj)


class LargeKernelAttention(nn.Module):
    def __init__(self, dim, k=21):
        super().__init__()
        self.local_conv = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, bias=False)
        self.h_conv = nn.Conv2d(dim, dim, (1, k), padding=(0, k // 2), groups=dim, bias=False)
        self.v_conv = nn.Conv2d(dim, dim, (k, 1), padding=(k // 2, 0), groups=dim, bias=False)
        self.pw_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.bn = nn.BatchNorm2d(dim)

    def forward(self, x):
        a = conv(conv(conv(x, self.local_conv), self.h_conv), self.v_conv)
        return x * torch.sigmoid(bn(conv(a, self.pw_conv), self.bn))


class LKABlock(nn.Module):
    def __init__(self, dim, k=21, ffn_ratio=2.0):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim)
        self.lka = LargeKernelAttention(dim, k)
        self.norm2 = nn.BatchNorm2d(dim)
        self.ffn = nn.Sequential(nn.Conv2d(dim, int(dim * ffn_ratio), 1), nn.GELU(),
                                 nn.Conv2d(int(dim * ffn_ratio), dim, 1))
        self.scale1 = nn.Parameter(torch.empty(()))
        self.scale2 = nn.Parameter(torch.empty(()))

    def forward(self, x):
        x = x + self.scale1 * self.lka(bn(x, self.norm1))
        return x + self.scale2 * conv(gelu(conv(bn(x, self.norm2), self.ffn[0])), self.ffn[2])


class CrossBandLKA(nn.Module):
    def __init__(self, dim=64, bands=9, heads=4, k=21):
        super().__init__()
        self.band_proj = nn.Conv2d(3, dim, 1)
        self.band_attention = MHA(dim, heads)
        self.norm = nn.LayerNorm(dim)
        self.lka_block = LKABlock(dim, k)
        self.out_proj = nn.Conv2d(dim, 3, 1)

    def forward(self, bands):
        # the bands are the tokens of a per-pixel attention: [B, H, W, bands, dim]
        tokens = torch.stack([conv(b, self.band_proj) for b in bands], dim=-1)
        tokens = tokens.permute(0, 2, 3, 4, 1)
        tokens = tokens + self.band_attention(ln(tokens, self.norm))
        return [conv(self.lka_block(tokens[..., i, :].permute(0, 3, 1, 2)), self.out_proj) + b
                for i, b in enumerate(bands)]


class SpatialGate(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.gate = nn.Sequential(nn.Conv2d(c, c // 4, 1), nn.GELU(), nn.Conv2d(c // 4, 1, 1))

    def forward(self, x):
        return x * torch.sigmoid(conv(gelu(conv(x, self.gate[0])), self.gate[2]))


class ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(c, c, 3, padding=1, bias=False), nn.GELU(),
                                   nn.Conv2d(c, c, 3, padding=1, bias=False))
        self.scale = nn.Parameter(torch.empty(()))

    def forward(self, x):
        return x + self.scale * conv(gelu(conv(x, self.block[0])), self.block[2])


def conv_gelu_conv(seq, x):
    return conv(gelu(conv(x, seq[0])), seq[2])


class HierarchicalFusion(nn.Module):
    def __init__(self, experts=3, bc=64):
        super().__init__()
        cin = 3 * experts
        self.bc = bc

        def pair(c0, c1, c2):
            return nn.Sequential(nn.Conv2d(c0, c1, 3, padding=1), nn.GELU(),
                                 nn.Conv2d(c1, c2, 3, padding=1))
        self.stage1_conv, self.stage1_gate, self.stage1_res = (
            pair(cin, bc, bc), SpatialGate(bc), ResBlock(bc))
        self.stage2_conv, self.stage2_gate, self.stage2_res = (
            pair(bc + cin, bc, bc), SpatialGate(bc), ResBlock(bc))
        self.stage3_conv, self.stage3_gate, self.stage3_res = (
            pair(bc + cin, bc, bc // 2), SpatialGate(bc // 2), ResBlock(bc // 2))
        self.residual_weight_1_2 = nn.Parameter(torch.empty(()))
        self.residual_weight_2_3 = nn.Parameter(torch.empty(()))
        self.to_rgb = nn.Sequential(nn.Conv2d(bc // 2, bc // 4, 3, padding=1), nn.GELU(),
                                    nn.Conv2d(bc // 4, 3, 3, padding=1))

    def forward(self, stack):
        h, w = stack.shape[2:]

        def stage(i, x):
            c, g, r = (getattr(self, f"stage{i}_{k}") for k in ("conv", "gate", "res"))
            return r(g(gelu(conv_gelu_conv(c, x))))

        f1 = stage(1, resize(stack, max(h // 4, 1), max(w // 4, 1)))
        f1_up = resize(f1, max(h // 2, 1), max(w // 2, 1))
        f2 = stage(2, torch.cat([f1_up, resize(stack, max(h // 2, 1), max(w // 2, 1))], 1))
        f2 = f2 + self.residual_weight_1_2 * f1_up
        f2_up = resize(f2, h, w)
        f3 = stage(3, torch.cat([f2_up, stack], 1))
        f3 = f3 + self.residual_weight_2_3 * f2_up[:, : self.bc // 2]
        return torch.sigmoid(conv_gelu_conv(self.to_rgb, f3))


class MultiScaleFeatureExtractor(nn.Module):
    def __init__(self, c=64):
        super().__init__()

        def branch():
            return nn.Sequential(nn.Conv2d(3, c, 3, padding=1, bias=False), nn.ReLU(),
                                 nn.BatchNorm2d(c))
        self.conv_1x, self.conv_2x, self.conv_4x = branch(), branch(), branch()
        self.fusion = nn.Conv2d(3 * c, c, 1, bias=False)

    def forward(self, x):
        h, w = x.shape[2:]

        def run(seq, z):
            return bn(F.relu(conv(z, seq[0])), seq[2])
        f1 = run(self.conv_1x, x)
        f2 = run(self.conv_2x, resize(x, h // 2, w // 2))
        f4 = run(self.conv_4x, resize(x, h // 4, w // 4))
        return conv(torch.cat([f1, resize(f2, h, w), resize(f4, h, w)], 1), self.fusion)


class DynamicExpertSelector(nn.Module):
    def __init__(self, hd=64, experts=3):
        super().__init__()
        self.difficulty_estimator = nn.Sequential(
            nn.Conv2d(3, hd, 3, padding=1), nn.ReLU(), nn.Conv2d(hd, hd // 2, 3, padding=1),
            nn.ReLU(), nn.Conv2d(hd // 2, 1, 3, padding=1))
        self.expert_gate = nn.Sequential(nn.Conv2d(hd, hd, 3, padding=1), nn.ReLU(),
                                         nn.Conv2d(hd, experts, 1))

    def forward(self, lr, feats):
        de = self.difficulty_estimator
        difficulty = torch.sigmoid(conv(F.relu(conv(F.relu(conv(lr, de[0])), de[2])), de[4]))
        eg = self.expert_gate
        gates = torch.sigmoid(conv(F.relu(conv(feats, eg[0])), eg[2]))
        gates = torch.sigmoid(10.0 * (gates - (0.7 - 0.4 * difficulty)))
        top = gates.amax(dim=1, keepdim=True)
        return torch.maximum(gates, (gates >= top * 0.99).to(gates.dtype) * 0.9), difficulty


def gaussian_window(size=5, sigma=1.5):
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


class EdgeAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attn = nn.Sequential(nn.Conv2d(c, c // 4, 1), nn.GELU(),
                                  nn.Conv2d(c // 4, 1, 3, padding=1))

    def forward(self, x):
        return x * torch.sigmoid(conv_gelu_conv(self.attn, x))


class EdgeRefineBlock(nn.Module):
    def __init__(self, cin=3, c=32):
        super().__init__()
        self.proj = nn.Conv2d(cin, c, 1)
        self.conv1 = nn.Conv2d(cin, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.conv3 = nn.Conv2d(c, c, 3, padding=1)
        self.attn = EdgeAttention(c)

    def forward(self, x):
        y = gelu(conv(gelu(conv(x, self.conv1)), self.conv2))
        return self.attn(conv(y, self.conv3) + conv(x, self.proj))


class LaplacianEdgeRefinement(nn.Module):
    def __init__(self, levels=3, c=32):
        super().__init__()
        self.levels = levels
        self.edge_refiners = nn.ModuleList(EdgeRefineBlock(3, c) for _ in range(levels))
        self.level_weights = nn.Parameter(torch.empty(levels))
        self.fusion = nn.Sequential(nn.Conv2d(levels * c, c, 3, padding=1), nn.GELU(),
                                    nn.Conv2d(c, 3, 3, padding=1))
        self.edge_gate = nn.Sequential(nn.Conv2d(6, 16, 3, padding=1), nn.GELU(),
                                       nn.Conv2d(16, 1, 3, padding=1))
        self.edge_strength = nn.Parameter(torch.empty(()))

    def forward(self, img):
        h, w = img.shape[2:]
        win = torch.as_tensor(gaussian_window(), device=img.device)
        pyramid, cur = [], img
        for level in range(self.levels):
            if level < self.levels - 1:
                blur = conv_w(cur, win.expand(cur.shape[1], 1, 5, 5), padding=2,
                              groups=cur.shape[1])
                down = F.avg_pool2d(blur, 2)
                pyramid.append(cur - resize(down, cur.shape[2], cur.shape[3]))
                cur = down
            else:
                pyramid.append(cur)
        lw = torch.softmax(self.level_weights, dim=0)
        feats = []
        for level, lap in enumerate(pyramid):
            f = self.edge_refiners[level](lap)
            if f.shape[2:] != (h, w):
                f = resize(f, h, w)
            feats.append(f * lw[level])
        edge = conv_gelu_conv(self.fusion, torch.cat(feats, 1))
        gate = torch.sigmoid(conv_gelu_conv(self.edge_gate, torch.cat([img, edge], 1)))
        return (img + gate * self.edge_strength * edge).clamp(0.0, 1.0)


class FusionHead(nn.Module):
    """``forward(lr [B,3,h,w], {hat, dat, nafnet}: [B,3,4h,4w])`` -> {"bands": the three
    guidance bands [B,9,h,w] (the band fusion's output, fed by the cross-band attention and
    its LKA block), "fused": the fused image before the refinement and its clamp, "sr": the
    output}."""

    def __init__(self, fusion_dim=64, num_heads=4, refine_depth=4, refine_channels=64,
                 block_size=8, upscale=4, experts=3):
        super().__init__()
        self.upscale = upscale
        self.multi_domain_freq = MultiDomainFrequency(block_size)
        self.cross_band_attn = CrossBandLKA(fusion_dim, 9, num_heads)
        self.multi_res_fusion = HierarchicalFusion(experts, fusion_dim)
        self.multiscale = MultiScaleFeatureExtractor(fusion_dim)
        self.dynamic_selector = DynamicExpertSelector(fusion_dim, experts)
        layers, cin = [], 3
        for i in range(refine_depth):
            cout = 3 if i == refine_depth - 1 else refine_channels
            layers.append(nn.Conv2d(cin, cout, 3, padding=1))
            if i < refine_depth - 1:
                layers.append(nn.GELU())
            cin = cout
        self.refine_net = nn.Sequential(*layers)
        self.residual_scale = nn.Parameter(torch.empty(()))
        self.edge_refine = LaplacianEdgeRefinement()

    def forward(self, lr, outs):
        mdf = self.multi_domain_freq
        raw = mdf.dct(lr) + mdf.dwt(lr) + mdf.fft(lr)
        bands = mdf.band_fusion(self.cross_band_attn(raw))
        hr = (lr.shape[2] * self.upscale, lr.shape[3] * self.upscale)
        experts = [outs["hat"], outs["dat"], outs["nafnet"]]
        stack = torch.stack(experts, dim=1)                             # [B,E,3,H,W]
        mags = [b.abs().mean(dim=1, keepdim=True) for b in bands]
        total = mags[0] + mags[1] + mags[2] + 1e-8
        guidance = torch.cat([mags[2] / total, mags[1] / total, mags[0] / total], 1)
        guidance = resize(guidance, *hr)
        freq_weighted = (stack * guidance[:, :, None]).sum(dim=1)
        fused = self.multi_res_fusion(torch.cat(experts, 1)) * 0.7 + freq_weighted * 0.3
        gates, difficulty = self.dynamic_selector(lr, self.multiscale(lr))
        gates = resize(gates, *hr)
        dynamic = (stack * gates[:, :, None]).sum(dim=1) / (gates.sum(1, keepdim=True) + 1e-8)
        d = resize(difficulty, *hr)
        fused = fused * (1.0 - 0.3 * d) + dynamic * (0.3 * d)
        up = resize(lr, *hr)
        rn = self.refine_net
        r = fused
        for i in range(0, len(rn), 2):
            r = conv(r, rn[i])
            if i + 1 < len(rn):
                r = gelu(r)
        out = (fused + 0.1 * r + self.residual_scale * up).clamp(0.0, 1.0)
        return {"bands": torch.cat(bands, 1), "fused": fused, "sr": self.edge_refine(out)}
