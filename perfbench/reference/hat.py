"""HAT (Chen et al., CVPR 2023; XPixelGroup/HAT), the x4 SR transformer, in plain PyTorch.

Written after the published architecture: tokens [B, HW, C] through residual hybrid attention
groups (window attention with a relative position bias, a channel-attention conv branch
scaled by 0.01, an MLP), each group ending in an overlapping cross-attention block and a 3x3
conv. Parameter names are the published state-dict keys. The position indices and shift
masks are computed here, per shape. Departure from the published code: none in eval mode
(no dropout, no drop path).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import conv, conv_w, gelu, lin, ln, mm

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def window_partition(x, ws):
    """[B, H, W, C] -> [B * nW, ws * ws, C]."""
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins, ws, h, w):
    b = wins.shape[0] // ((h // ws) * (w // ws))
    x = wins.view(b, h // ws, w // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def relative_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]


def overlap_relative_index(ws, wse):
    ori = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ext = np.stack(np.meshgrid(np.arange(wse), np.arange(wse), indexing="ij")).reshape(2, -1)
    rel = (ext[:, None, :] - ori[:, :, None]).transpose(1, 2, 0) + (ws - wse + 1)
    # negative entries index the table from its end, as the published code's do
    return rel[:, :, 0] * (ws + wse - 1) + rel[:, :, 1]


def shift_mask(h, w, ws, s):
    """[nW, ws*ws, ws*ws] of 0 and -100: the shifted-window mask of an H x W image."""
    img = np.zeros((h, w), dtype=np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
        for wsl in (slice(0, -ws), slice(-ws, -s), slice(-s, None)):
            img[hs, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(wins[:, None, :] != wins[:, :, None], -100.0, 0.0).astype(np.float32)


class Tables:
    """Index tables and masks, built once per shape and device."""

    def __init__(self):
        self._cache = {}

    def get(self, key, make, device):
        k = key + (str(device),)
        if k not in self._cache:
            self._cache[k] = torch.as_tensor(make(), device=device)
        return self._cache[k]


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return lin(gelu(lin(x, self.fc1)), self.fc2)


class WindowAttention(nn.Module):
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, index, mask):
        b_, n, c = x.shape
        hd = c // self.heads
        qkv = lin(x, self.qkv).reshape(b_, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        qh, kh, vh = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = mm(qh, kh.transpose(-2, -1))
        bias = self.relative_position_bias_table[index.reshape(-1)].view(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b_ // nw, nw, self.heads, n, n) + mask[None, :, None]
            attn = attn.view(-1, self.heads, n, n)
        out = mm(attn.softmax(dim=-1), vh).transpose(1, 2).reshape(b_, n, c)
        return lin(out, self.proj)


class ChannelAttention(nn.Module):
    def __init__(self, dim, squeeze):
        super().__init__()
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1),
                                       nn.ReLU(), nn.Conv2d(dim // squeeze, dim, 1),
                                       nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(2, 3), keepdim=True)
        y = torch.sigmoid(conv(F.relu(conv(y, self.attention[1])), self.attention[3]))
        return x * y


class CAB(nn.Module):
    def __init__(self, dim, compress, squeeze):
        super().__init__()
        self.cab = nn.Sequential(nn.Conv2d(dim, dim // compress, 3, padding=1), nn.GELU(),
                                 nn.Conv2d(dim // compress, dim, 3, padding=1),
                                 ChannelAttention(dim, squeeze))

    def forward(self, x):
        return self.cab[3](conv(gelu(conv(x, self.cab[0])), self.cab[2]))


class HAB(nn.Module):
    def __init__(self, dim, heads, ws, shift, compress, squeeze, conv_scale, mlp_ratio):
        super().__init__()
        self.ws, self.shift, self.conv_scale = ws, shift, conv_scale
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, ws, heads)
        self.conv_block = CAB(dim, compress, squeeze)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t, size, tables):
        h, w = size
        b, _, c = t.shape
        ws, s = self.ws, self.shift
        x = ln(t, self.norm1).view(b, h, w, c)
        conv_x = self.conv_block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        index = tables.get(("sa", ws), lambda: relative_index(ws), t.device)
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = tables.get(("mask", h, w, ws, s), lambda: shift_mask(h, w, ws, s), t.device)
        att = window_reverse(self.attn(window_partition(x, ws), index, mask), ws, h, w)
        if s > 0:
            att = torch.roll(att, (s, s), dims=(1, 2))
        y = t + att.reshape(b, h * w, c) + conv_x * self.conv_scale
        return y + self.mlp(ln(y, self.norm2))


class OCAB(nn.Module):
    def __init__(self, dim, ws, overlap_ratio, heads, mlp_ratio):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.wse = int(ws * overlap_ratio) + ws
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((ws + self.wse - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, t, size, tables):
        h, w = size
        b, _, c = t.shape
        ws, wse, heads = self.ws, self.wse, self.heads
        hd = c // heads
        qkv = lin(ln(t, self.norm1), self.qkv).view(b, h, w, 3 * c)
        q = window_partition(qkv[..., :c], ws)                            # [B*nW, ws*ws, C]
        # keys and values: (wse x wse) windows at stride ws, zero-padded around the image
        kv = qkv[..., c:].permute(0, 3, 1, 2)
        kv = F.unfold(kv, kernel_size=wse, stride=ws, padding=(wse - ws) // 2)
        kv = kv.view(b, 2, c, wse * wse, -1).permute(1, 0, 4, 3, 2).reshape(2, -1, wse * wse, c)
        nq, nk = ws * ws, wse * wse

        def heads_of(z, n):
            return z.reshape(z.shape[0], n, heads, hd).permute(0, 2, 1, 3)

        attn = mm(heads_of(q, nq) * hd ** -0.5, heads_of(kv[0], nk).transpose(-2, -1))
        index = tables.get(("oca", ws, wse), lambda: overlap_relative_index(ws, wse), t.device)
        bias = self.relative_position_bias_table[index.reshape(-1)].view(nq, nk, -1)
        attn = (attn + bias.permute(2, 0, 1).unsqueeze(0)).softmax(dim=-1)
        out = mm(attn, heads_of(kv[1], nk)).transpose(1, 2).reshape(-1, nq, c)
        out = window_reverse(out, ws, h, w).reshape(b, h * w, c)
        y = lin(out, self.proj) + t
        return y + self.mlp(ln(y, self.norm2))


class AttenBlocks(nn.Module):
    def __init__(self, dim, depth, heads, ws, compress, squeeze, conv_scale, overlap_ratio,
                 mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, heads, ws, 0 if j % 2 == 0 else ws // 2, compress, squeeze, conv_scale,
                mlp_ratio) for j in range(depth)])
        self.overlap_attn = OCAB(dim, ws, overlap_ratio, heads, mlp_ratio)


class SeamConv(nn.Module):
    """A 3x3 conv whose parameters sit directly under its key (``layers.i.conv.weight``)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return conv_w(x, self.weight, self.bias, padding=1)


class RHAG(nn.Module):
    def __init__(self, dim, depth, heads, ws, compress, squeeze, conv_scale, overlap_ratio,
                 mlp_ratio):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, heads, ws, compress, squeeze, conv_scale,
                                          overlap_ratio, mlp_ratio)
        self.conv = SeamConv(dim, dim)

    def forward(self, t, size, tables):
        h, w = size
        b, _, c = t.shape
        r = t
        for blk in self.residual_group.blocks:
            r = blk(r, size, tables)
        r = self.residual_group.overlap_attn(r, size, tables)
        r = self.conv(r.transpose(1, 2).reshape(b, c, h, w)).flatten(2).transpose(1, 2)
        return t + r


class PatchEmbed(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


def upsample_tail(x, before, ups, last):
    """conv + LeakyReLU, (conv + PixelShuffle(2)) per factor 2, the last conv."""
    x = F.leaky_relu(conv(x, before), 0.01)
    for c in ups:
        x = F.pixel_shuffle(conv(x, c), 2)
    return conv(x, last)


class HAT(nn.Module):
    """``forward(x [B, 3, H, W])`` -> SR [B, 3, 4H, 4W] (unclamped); H, W whole windows."""

    def __init__(self, upscale=4, embed_dim=180, depths=(6,) * 12, num_heads=(6,) * 12,
                 window=16, compress=3, squeeze=30, conv_scale=0.01, overlap_ratio=0.5,
                 mlp_ratio=2.0, num_feat=64, img_range=1.0):
        super().__init__()
        self.img_range, self.window = img_range, window
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            RHAG(embed_dim, d, num_heads[i], window, compress, squeeze, conv_scale,
                 overlap_ratio, mlp_ratio) for i, d in enumerate(depths)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = SeamConv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, padding=1),
                                                  nn.LeakyReLU(0.01))
        ups = []
        for _ in range(int(math.log2(upscale))):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)
        self.tables = Tables()

    def forward(self, x):
        mean = torch.tensor(RGB_MEAN, device=x.device).view(1, 3, 1, 1)
        x = conv((x - mean) * self.img_range, self.conv_first)
        b, c, h, w = x.shape
        t = ln(x.flatten(2).transpose(1, 2), self.patch_embed.norm)
        for layer in self.layers:
            t = layer(t, (h, w), self.tables)
        t = ln(t, self.norm).transpose(1, 2).reshape(b, c, h, w)
        x = self.conv_after_body(t) + x
        x = upsample_tail(x, self.conv_before_upsample[0], self.upsample[::2], self.conv_last)
        return x / self.img_range + mean
