"""MambaIR expert (state-space x4 SR) on NHWC tensors. Twin of
``freqfusion_tpu/models/mambair.py``.

The reference's MambaIR needs the ``mamba_ssm`` CUDA kernels; the JAX twin evaluates its
selective scan with ``jax.lax.associative_scan``, and no TPU kernel is involved. Here the
scan is plain PyTorch, chunked (``selective_scan``), so that neither a Python loop over the
sequence nor the whole [L, D, N] state is ever needed.

Architecture (the reference's mambair_arch.py): SS2D (4-direction scan: row-major,
column-major and both reversed), VSSBlock (LN -> SS2D with a per-channel skip scale, LN ->
CAB conv-attention with a second skip scale), residual state-space groups with a 3x3 conv
and a skip, the HAT-style conv_first / conv_after_body frame, RGB mean normalisation and
PixelShuffle upsampling. Default MambaIR-SR config: embed 180, 6 groups x 6 blocks,
d_state 16, expand 2. Module names are the reference's state-dict keys, which
``utils/convert.py:mambair_key`` gives the JAX modules' parameters.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import pixel_shuffle
from .layers import conv1x1_nhwc, conv_nhwc

RGB_MEAN = (0.4488, 0.4371, 0.4040)
#: tokens a chunk of the selective scan; the scan takes 2 x SCAN_CHUNK sequential steps
SCAN_CHUNK = 64


def selective_scan(x: torch.Tensor, delta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, d: torch.Tensor, chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """The selective scan h_t = exp(delta_t a) h_{t-1} + delta_t x_t b_t, y_t = c_t . h_t +
    d x_t over the sequence axis.

    x, delta [..., L, D]; a [..., D, N] (negative); b, c [..., L, N]; d [..., D] -> y
    [..., L, D]. Leading axes broadcast (SS2D passes its 4 directions as one leading axis,
    each with its own a and d).

    Chunked in two levels: the sequence is cut into chunks of `chunk` tokens (the last
    padded with delta = 0, a step that keeps the state). Pass 1 runs `chunk` sequential
    steps over all chunks at once from a zero state and keeps each chunk's end state; a
    log-depth (Hillis-Steele) scan over the chunks carries those states across, with each
    chunk's decay exp(a * sum delta) (a sum, never a product of exponentials divided back
    out, which would underflow); pass 2 re-runs every chunk from the state entering it and
    reads y. Memory is O(L D N / chunk). The sums run in another order than the JAX twin's
    associative scan."""
    *lead, l, dim = x.shape
    n = a.shape[-1]
    t = max(1, min(chunk, l))
    nc = -(-l // t)
    pad = nc * t - l
    if pad:
        x, delta, b, c = (F.pad(v, (0, 0, 0, pad)) for v in (x, delta, b, c))
    dl = delta.reshape(*lead, nc, t, dim)
    u = (delta * x).reshape(*lead, nc, t, dim)
    bb = b.reshape(*lead, nc, t, n)
    cc = c.reshape(*lead, nc, t, n)
    ac = a.unsqueeze(-3)                                  # [..., 1, D, N] over the chunks

    def step(h, i):
        da = torch.exp(dl[..., i, :, None] * ac)
        return h.mul_(da).addcmul_(u[..., i, :, None], bb[..., i, None, :])

    # pass 1: each chunk's end state from a zero start
    h = x.new_zeros(*lead, nc, dim, n)
    for i in range(t):
        h = step(h, i)
    # across chunks: inclusive scan of (decay, end state) pairs, (A1, H1) then (A2, H2)
    # combining to (A2 A1, A2 H1 + H2)
    decay = torch.exp(dl.sum(dim=-2)[..., None] * ac)
    k = 1
    while k < nc:
        h = torch.cat([h[..., :k, :, :], decay[..., k:, :, :] * h[..., :-k, :, :]
                       + h[..., k:, :, :]], dim=-3)
        decay = torch.cat([decay[..., :k, :, :], decay[..., k:, :, :] * decay[..., :-k, :, :]],
                          dim=-3)
        k *= 2
    # pass 2: every chunk from the state entering it
    h = torch.cat([torch.zeros_like(h[..., :1, :, :]), h[..., :-1, :, :]], dim=-3)
    y = x.new_empty(*lead, nc, t, dim)
    for i in range(t):
        h = step(h, i)
        y[..., i, :] = (h @ cc[..., i, :, None]).squeeze(-1)
    y = y.reshape(*lead, nc * t, dim)[..., :l, :]
    return y + x[..., :l, :] * d.unsqueeze(-2)


class SS2D(nn.Module):
    """4-directional 2-D selective scan block. The four directions' parameters are stacked
    (x_proj_weight [4, R + 2N, D], dt_projs_weight [4, D, R], dt_projs_bias [4, D],
    A_logs [4D, N], Ds [4D]), as in the reference."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3, expand: float = 2.0):
        super().__init__()
        self.d_state = d_state
        self.d_inner = d_inner = int(expand * d_model)
        self.dt_rank = dt_rank = math.ceil(d_model / 16)
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv, padding=(d_conv - 1) // 2,
                                groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.empty(4, dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(
            torch.empty(4, d_inner, dt_rank).uniform_(-dt_rank ** -0.5, dt_rank ** -0.5))
        # softplus^-1(0.01)
        self.dt_projs_bias = nn.Parameter(torch.full((4, d_inner), math.log(math.expm1(0.01))))
        self.A_logs = nn.Parameter(torch.log(torch.arange(1, d_state + 1, dtype=torch.float32))
                                   .repeat(4 * d_inner, 1))
        self.Ds = nn.Parameter(torch.ones(4 * d_inner))
        self.out_norm = nn.LayerNorm(d_inner, eps=1e-5)
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)
        for w in self.x_proj_weight:
            nn.init.xavier_uniform_(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B,H,W,C]
        bsz, h, w, _ = x.shape
        d, n, r, l = self.d_inner, self.d_state, self.dt_rank, h * w
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        xs = F.silu(conv_nhwc(self.conv2d, xs))

        # four scan orders, one leading axis: row-major, column-major, both reversed
        seq_hw = xs.reshape(bsz, l, d)
        seq_wh = xs.transpose(1, 2).reshape(bsz, l, d)
        seqs = torch.stack([seq_hw, seq_wh, seq_hw.flip(1), seq_wh.flip(1)])   # [4,B,L,D]
        dbl = seqs @ self.x_proj_weight.transpose(1, 2).unsqueeze(1)           # [4,B,L,R+2N]
        dt, bs, cs = dbl.split([r, n, n], dim=-1)
        delta = F.softplus(dt @ self.dt_projs_weight.transpose(1, 2).unsqueeze(1)
                           + self.dt_projs_bias[:, None, None, :])
        a = -torch.exp(self.A_logs.reshape(4, 1, d, n))
        ys = selective_scan(seqs, delta, a, bs, cs, self.Ds.reshape(4, 1, d))

        y = (ys[0] + ys[2].flip(1)).reshape(bsz, h, w, d)
        y = y + (ys[1] + ys[3].flip(1)).reshape(bsz, w, h, d).transpose(1, 2)
        y = self.out_norm(y) * F.silu(z)
        return self.out_proj(y)


class ChannelAttention(nn.Module):
    """GAP -> 1x1 conv -> ReLU -> 1x1 conv -> sigmoid gate; keys attention.1 / attention.3."""

    def __init__(self, features: int, squeeze: int = 16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(features, features // squeeze, 1), nn.ReLU(),
            nn.Conv2d(features // squeeze, features, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = x.mean(dim=(1, 2), keepdim=True)
        att = F.relu(conv1x1_nhwc(self.attention[1], att))
        return x * torch.sigmoid(conv1x1_nhwc(self.attention[3], att))


class MambaCAB(nn.Module):
    """Conv-attention branch of the VSSBlock: conv3x3 (C -> C/3) -> GELU -> conv3x3 -> RCAN
    channel attention (C / 16, as the JAX twin); keys cab.0, cab.2, cab.3.*."""

    def __init__(self, features: int, compress: int = 3):
        super().__init__()
        mid = features // compress
        self.cab = nn.Sequential(nn.Conv2d(features, mid, 3, padding=1), nn.GELU(),
                                 nn.Conv2d(mid, features, 3, padding=1),
                                 ChannelAttention(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.cab[2], F.gelu(conv_nhwc(self.cab[0], x)))
        return self.cab[3](h)


class VSSBlock(nn.Module):
    def __init__(self, dim: int, d_state: int = 16, expand: float = 2.0):
        super().__init__()
        # the reference's BasicLayer passes nn.LayerNorm (eps 1e-5) explicitly
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attention = SS2D(dim, d_state, expand=expand)
        self.skip_scale = nn.Parameter(torch.ones(dim))
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.conv_blk = MambaCAB(dim)
        self.skip_scale2 = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.skip_scale + self.self_attention(self.ln_1(x))
        return x * self.skip_scale2 + self.conv_blk(self.ln_2(x))


class _Blocks(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSSG(nn.Module):
    """Residual State-Space Group: depth x VSSBlock + 3x3 conv + skip."""

    def __init__(self, dim: int, depth: int, d_state: int, expand: float):
        super().__init__()
        self.residual_group = _Blocks(VSSBlock(dim, d_state, expand) for _ in range(depth))
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.residual_group.blocks:
            x = blk(x)
        return res + conv_nhwc(self.conv, x)


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class MambaIR(nn.Module):
    """MambaIR x`upscale` SR: ``forward(x)`` -> (sr [B,sH,sW,3], deep features
    [B,H,W,embed_dim])."""

    def __init__(self, upscale: int = 4, embed_dim: int = 180, depths: Sequence[int] = (6,) * 6,
                 d_state: int = 16, expand: float = 2.0, num_feat: int = 64,
                 img_range: float = 1.0):
        super().__init__()
        self.upscale, self.img_range = upscale, img_range
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        # patch_norm=True: LN after the (no-op) patch embed
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList(RSSG(embed_dim, depth, d_state, expand) for depth in depths)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, padding=1)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, padding=1),
                                                  nn.LeakyReLU())
        ups = []
        for _ in range(int(math.log2(upscale))):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
        x = (x - mean) * self.img_range
        x = conv_nhwc(self.conv_first, x)
        feat = self.patch_embed.norm(x)
        for layer in self.layers:
            feat = layer(feat)
        deep = conv_nhwc(self.conv_after_body, self.norm(feat))
        x = F.leaky_relu(conv_nhwc(self.conv_before_upsample[0], deep + x), 0.01)
        for conv in self.upsample[::2]:
            x = pixel_shuffle(conv_nhwc(conv, x), 2)
        x = conv_nhwc(self.conv_last, x)
        return x / self.img_range + mean, deep
