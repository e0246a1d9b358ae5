"""DAT (Chen et al., ICCV 2023; zhengchen1999/DAT), the x4 SR transformer, in plain PyTorch.

Written after the published architecture: residual groups of blocks that alternate a
dual rectangular-window spatial attention (windows (s0, s1) on one half of the channels,
(s1, s0) on the other, a dynamic position bias, shifted in some blocks) and a channel
attention, each joined to a depthwise-conv branch by the adaptive interaction module (AIM),
and a spatial-gate FFN (SGFN). Parameter names are the published state-dict keys; the
position tables and shift masks are computed here. Images are whole windows (the serving
buckets are), so the published code's padding of q, k, v does not arise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .hat import SeamConv, Tables, upsample_tail
from .ops import bn, conv, gelu, lin, ln, mm

RGB_MEAN = (0.4488, 0.4371, 0.4040)


def rect_index(hs, ws):
    coords = np.stack(np.meshgrid(np.arange(hs), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    return (rel[:, :, 0] + hs - 1) * (2 * ws - 1) + rel[:, :, 1] + ws - 1


def rect_offsets(hs, ws):
    g = np.stack(np.meshgrid(np.arange(1 - hs, hs), np.arange(1 - ws, ws), indexing="ij"))
    return g.reshape(2, -1).T.astype(np.float32)


def rect_shift_mask(h, w, hs, ws, sh, sw):
    img = np.zeros((h, w), dtype=np.int64)
    cnt = 0
    for a in (slice(0, -hs), slice(-hs, -sh), slice(-sh, None)):
        for b in (slice(0, -ws), slice(-ws, -sw), slice(-sw, None)):
            img[a, b] = cnt
            cnt += 1
    wins = img.reshape(h // hs, hs, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, hs * ws)
    return np.where(wins[:, None, :] != wins[:, :, None], -100.0, 0.0).astype(np.float32)


class DynamicPosBias(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        p = dim // 4
        self.pos_proj = nn.Linear(2, p)
        self.pos1 = nn.Sequential(nn.LayerNorm(p), nn.ReLU(), nn.Linear(p, p))
        self.pos2 = nn.Sequential(nn.LayerNorm(p), nn.ReLU(), nn.Linear(p, p))
        self.pos3 = nn.Sequential(nn.LayerNorm(p), nn.ReLU(), nn.Linear(p, heads))

    def forward(self, x):
        x = lin(x, self.pos_proj)
        for seq in (self.pos1, self.pos2, self.pos3):
            x = lin(F.relu(ln(x, seq[0])), seq[2])
        return x


class SpatialAttention(nn.Module):
    """One branch: attention inside (hs, ws) windows of pre-projected q, k, v."""

    def __init__(self, dim, heads, hs, ws):
        super().__init__()
        self.heads, self.hs, self.ws = heads, hs, ws
        self.pos = DynamicPosBias(dim // 4, heads)

    def forward(self, q, k, v, h, w, mask, tables):
        """q, k, v [B, H, W, D] -> [B, H, W, D]."""
        b, _, _, d = q.shape
        hs, ws, heads = self.hs, self.ws, self.heads
        hd, n = d // heads, hs * ws

        def wins(t):
            t = t.view(b, h // hs, hs, w // ws, ws, d).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(-1, n, heads, hd).permute(0, 2, 1, 3)

        attn = mm(wins(q) * hd ** -0.5, wins(k).transpose(-2, -1))
        offsets = tables.get(("offsets", hs, ws), lambda: rect_offsets(hs, ws), q.device)
        index = tables.get(("rect", hs, ws), lambda: rect_index(hs, ws), q.device)
        bias = self.pos(offsets)[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(-1, nw, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
        out = mm(attn.softmax(dim=-1), wins(v)).transpose(1, 2).reshape(-1, hs, ws, d)
        out = out.view(b, h // hs, w // ws, hs, ws, d).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, h, w, d)


class AIM(nn.Module):
    """The depthwise-conv branch, both interaction heads and the output projection."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1, groups=dim),
                                    nn.BatchNorm2d(dim), nn.GELU())
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // 8, 1), nn.BatchNorm2d(dim // 8),
            nn.GELU(), nn.Conv2d(dim // 8, dim, 1))
        self.spatial_interaction = nn.Sequential(
            nn.Conv2d(dim, dim // 16, 1), nn.BatchNorm2d(dim // 16), nn.GELU(),
            nn.Conv2d(dim // 16, 1, 1))
        self.proj = nn.Linear(dim, dim)

    def conv_branch(self, v):
        return gelu(bn(conv(v, self.dwconv[0]), self.dwconv[1]))

    def channel_map(self, x):
        ci = self.channel_interaction
        y = x.mean(dim=(2, 3), keepdim=True)
        return conv(gelu(bn(conv(y, ci[1]), ci[2])), ci[4])

    def spatial_map(self, x):
        si = self.spatial_interaction
        return conv(gelu(bn(conv(x, si[0]), si[1])), si[3])


class AdaptiveSpatialAttention(AIM):
    def __init__(self, dim, heads, split_size, shift):
        super().__init__(dim)
        self.heads, self.split_size, self.shift = heads, tuple(split_size), shift
        self.qkv = nn.Linear(dim, 3 * dim)
        s0, s1 = self.split_size
        self.attns = nn.ModuleList([SpatialAttention(dim // 2, heads // 2, s0, s1),
                                    SpatialAttention(dim // 2, heads // 2, s1, s0)])

    def forward(self, t, h, w, tables):
        b, n, c = t.shape
        half = c // 2
        qkv = lin(t, self.qkv).view(b, h, w, 3, c)
        s0, s1 = self.split_size
        outs = []
        for br, (hs, ws) in enumerate(((s0, s1), (s1, s0))):
            q, k, v = (qkv[..., i, br * half:(br + 1) * half] for i in range(3))
            mask = None
            if self.shift:
                sh, sw = hs // 2, ws // 2
                q, k, v = (torch.roll(z, (-sh, -sw), dims=(1, 2)) for z in (q, k, v))
                mask = tables.get(("rmask", h, w, hs, ws),
                                  lambda: rect_shift_mask(h, w, hs, ws, sh, sw), t.device)
            o = self.attns[br](q.contiguous(), k.contiguous(), v.contiguous(), h, w, mask,
                               tables)
            if self.shift:
                o = torch.roll(o, (hs // 2, ws // 2), dims=(1, 2))
            outs.append(o)
        attened = torch.cat(outs, dim=-1).reshape(b, n, c)
        v_img = qkv[..., 2, :].permute(0, 3, 1, 2)
        conv_x = self.conv_branch(v_img)
        cmap = self.channel_map(conv_x).permute(0, 2, 3, 1).reshape(b, 1, c)
        smap = self.spatial_map(attened.transpose(1, 2).reshape(b, c, h, w))
        attened = attened * torch.sigmoid(cmap)
        conv_x = (torch.sigmoid(smap) * conv_x).permute(0, 2, 3, 1).reshape(b, n, c)
        return lin(attened + conv_x, self.proj)


class AdaptiveChannelAttention(AIM):
    def __init__(self, dim, heads):
        super().__init__(dim)
        self.heads = heads
        self.temperature = nn.Parameter(torch.empty(heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)

    def forward(self, t, h, w, tables):
        b, n, c = t.shape
        heads, hd = self.heads, c // self.heads
        qkv = lin(t, self.qkv).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 4, 1)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # [B, heads, hd, N]
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        attn = (mm(q, k.transpose(-2, -1)) * self.temperature).softmax(dim=-1)
        attened = mm(attn, v).permute(0, 3, 1, 2).reshape(b, n, c)
        conv_x = self.conv_branch(v.reshape(b, c, h, w))
        cmap = self.channel_map(attened.transpose(1, 2).reshape(b, c, h, w))
        smap = self.spatial_map(conv_x).permute(0, 2, 3, 1).reshape(b, n, 1)
        attened = attened * torch.sigmoid(smap)
        conv_x = (conv_x * torch.sigmoid(cmap)).permute(0, 2, 3, 1).reshape(b, n, c)
        return lin(attened + conv_x, self.proj)


class SpatialGate(nn.Module):
    def __init__(self, half):
        super().__init__()
        self.norm = nn.LayerNorm(half)
        self.conv = nn.Conv2d(half, half, 3, padding=1, groups=half)


class SGFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def forward(self, t, h, w):
        b, n, _ = t.shape
        x1, x2 = gelu(lin(t, self.fc1)).chunk(2, dim=-1)
        x2 = ln(x2, self.sg.norm).transpose(1, 2).reshape(b, -1, h, w)
        x2 = conv(x2, self.sg.conv).flatten(2).transpose(1, 2)
        return lin(x1 * x2, self.fc2)


class DATB(nn.Module):
    def __init__(self, dim, heads, split_size, expansion, spatial, shift):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = (AdaptiveSpatialAttention(dim, heads, split_size, shift) if spatial
                     else AdaptiveChannelAttention(dim, heads))
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = SGFN(dim, int(dim * expansion))

    def forward(self, t, h, w, tables):
        t = t + self.attn(ln(t, self.norm1), h, w, tables)
        return t + self.ffn(ln(t, self.norm2), h, w)


def shifts(group, block):
    """Whether block `block` of residual group `group` shifts its windows (published rule)."""
    if group % 2 == 0:
        return block > 0 and (block - 2) % 4 == 0
    return block % 4 == 0


class ResidualGroup(nn.Module):
    def __init__(self, dim, depth, heads, split_size, expansion, group):
        super().__init__()
        self.blocks = nn.ModuleList([
            DATB(dim, heads, split_size, expansion, j % 2 == 0, shifts(group, j))
            for j in range(depth)])
        self.conv = SeamConv(dim, dim)

    def forward(self, t, h, w, tables):
        b, n, c = t.shape
        r = t
        for blk in self.blocks:
            r = blk(r, h, w, tables)
        return t + self.conv(r.transpose(1, 2).reshape(b, c, h, w)).flatten(2).transpose(1, 2)


class DAT(nn.Module):
    """``forward(x [B, 3, H, W])`` -> SR [B, 3, 4H, 4W] (unclamped)."""

    def __init__(self, upscale=4, embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                 split_size=(8, 32), expansion=4.0, num_feat=64, img_range=1.0):
        super().__init__()
        self.img_range = img_range
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.before_RG = nn.Sequential(nn.Identity(), nn.LayerNorm(embed_dim))
        self.layers = nn.ModuleList([
            ResidualGroup(embed_dim, d, num_heads[i], split_size, expansion, i)
            for i, d in enumerate(depths)])
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
        t = ln(x.flatten(2).transpose(1, 2), self.before_RG[1])
        for layer in self.layers:
            t = layer(t, h, w, self.tables)
        t = ln(t, self.norm).transpose(1, 2).reshape(b, c, h, w)
        x = self.conv_after_body(t) + x
        x = upsample_tail(x, self.conv_before_upsample[0], self.upsample[::2], self.conv_last)
        return x / self.img_range + mean
