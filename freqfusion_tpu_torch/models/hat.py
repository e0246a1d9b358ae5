"""HAT-L expert (Hybrid Attention Transformer) on NHWC tensors. Twin of
``freqfusion_tpu/models/hat.py``.

HAT-L config: embed 180, 12 RHAG x (6 HAB + 1 OCAB), 6 heads, window 16 (shift 8),
overlap_ratio 0.5 (OCAB window 24), CAB compress 3 / squeeze 30 / conv_scale 0.01,
mlp_ratio 2, pixelshuffle x4, num_feat 64. Module names follow the reference's state-dict
keys (``layers.i.residual_group.blocks.j.attn.qkv``, ``conv_block.cab.3.attention.1``,
``layers.i.residual_group.overlap_attn.qkv``, ``patch_embed.norm``, ``upsample.0/2``, ...)
and parameters keep the reference's shapes, so a state dict of the reference loads as it is
(its buffers ``relative_position_index_SA``, ``relative_position_index_OCA`` and the
attention masks are rebuilt here and must be dropped).

Where the JAX package runs its Pallas kernels, a CUDA tensor runs the hand-written ones:
every HAB is the CAB chain (B7) and the fused block (B8) when its window is at least 8 px
and H, W are even (the JAX gate) and B8 takes its windows and heads (``hab_is_fused``); a
HAB inside the JAX gate that B8 refuses (window 12 or 24, heads over 32) runs B7, the
standalone window attention (B14) and the residual MLP tail (B10); every OCAB is the
overlapping attention (B9) and the residual MLP tail (B10) when its window is a multiple of
16 with an overlap of half of it; the group-ending convs and ``conv_after_body`` are kernel
B3. A HAB outside the JAX gate (odd H or W, hence an odd window, since H and W are whole
windows; or a window under 8 px) runs its block in torch around B14, which takes any
window; an OCAB outside its gate runs in plain torch on any device, as the JAX package
leaves it to XLA. The LR/HR convs around the trunk, the channel attention's MLP on the
pooled vector, OCAB's ``norm1`` and ``qkv``, the bias gathers and the un-roll of a shifted
block's output stay torch, as in the JAX package. Each module's ``kernels = False`` runs the
plain versions on any device, to compare the two.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import windows as W
from ..ops.common import layernorm, pixel_shuffle
from ..ops.kernels.cab import cab_chain, cab_chain_plain
from ..ops.kernels.wattn import (fused_hab_block, fused_hab_block_plain,
                                 fused_overlap_attention, fused_overlap_attention_plain,
                                 fused_residual_ln_mlp, fused_residual_ln_mlp_plain,
                                 fused_window_attention, fused_window_attention_plain,
                                 xqkv_takes)
from .layers import (SeamConv, conv_nhwc as _conv_nhwc, gelu, hwio as _hwio,
                     linear_io_view as _io)

RGB_MEAN = (0.4488, 0.4371, 0.4040)

#: Smallest window of HAB's kernels (the JAX package's gate).
MIN_FUSED_WINDOW = 8


def hab_is_fused(window: int, h: int, w: int, head_dim: int) -> bool:
    """Whether a HAB at this shape takes the CAB-chain and fused-block kernels (B7 + B8): the
    JAX package's gate (a window of 8 px or more, even H and W; ``hab_keeps_kernels``) and
    windows and heads that B8's attention kernel takes (``xqkv_takes``: 64 to 256 tokens in
    steps of 64, heads up to 32 wide)."""
    return hab_keeps_kernels(window, h, w) and xqkv_takes(window * window, head_dim)


def hab_keeps_kernels(window: int, h: int, w: int) -> bool:
    """Whether a HAB inside the JAX package's gate runs kernels: B7 + B8 where
    ``hab_is_fused``, else its CAB chain (B7) and residual MLP tail (B10) around the
    standalone window attention (B14), which takes any window and head width (HAT's window
    12 or 24, heads wider than 32). Outside the gate (odd H or W, a window under 8 px) the
    block runs torch's CAB and MLP around B14."""
    return window >= MIN_FUSED_WINDOW and h % 2 == 0 and w % 2 == 0


def ocab_is_fused(window: int, overlap: int) -> bool:
    """Whether an OCAB takes the overlapping-attention and residual-MLP kernels."""
    return window % 16 == 0 and overlap == window // 2


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def raw(self):
        """(w1, b1, w2, b2) in the kernels' [in,out] layout."""
        return _io(self.fc1), self.fc1.bias, _io(self.fc2), self.fc2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class ChannelAttention(nn.Module):
    """RCAN channel attention: GAP -> 1x1 (C -> C/squeeze) -> ReLU -> 1x1 -> sigmoid."""

    def __init__(self, dim: int, squeeze: int):
        super().__init__()
        self.attention = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // squeeze, 1),
                                       nn.ReLU(), nn.Conv2d(dim // squeeze, dim, 1),
                                       nn.Sigmoid())

    def gate(self, pooled: torch.Tensor) -> torch.Tensor:
        """The gate [B,1,1,C] from the pooled (mean) vector [B,1,1,C]."""
        fc1, fc2 = self.attention[1], self.attention[3]
        y = F.relu(pooled @ fc1.weight.flatten(1).t() + fc1.bias)
        return torch.sigmoid(y @ fc2.weight.flatten(1).t() + fc2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B,H,W,C]
        return x * self.gate(x.mean(dim=(1, 2), keepdim=True))


class CAB(nn.Module):
    """Conv attention branch of HAB: 3x3 (C -> C/compress) -> GELU -> 3x3 -> CA."""

    def __init__(self, dim: int, compress: int, squeeze: int):
        super().__init__()
        self.cab = nn.Sequential(nn.Conv2d(dim, dim // compress, 3, padding=1), nn.GELU(),
                                 nn.Conv2d(dim // compress, dim, 3, padding=1),
                                 ChannelAttention(dim, squeeze))

    def raw(self):
        """(w1, b1, w2, b2) of the two convs in the layouts of ops/kernels/cab.py."""
        return _hwio(self.cab[0]), self.cab[0].bias, _hwio(self.cab[2]), self.cab[2].bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B,H,W,C], already normalised
        u = _conv_nhwc(self.cab[2], gelu(_conv_nhwc(self.cab[0], x)))
        return self.cab[3](u)


class WindowAttention(nn.Module):
    """Parameters of W-MSA over window x window windows with a learned relative-position
    bias table; the attention itself is ops/kernels/wattn.py."""

    def __init__(self, dim: int, window: int, num_heads: int):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(   # a constant, rebuilt and not part of the state dict
            "relative_position_index",
            torch.from_numpy(W.relative_position_index(window, window).copy()),
            persistent=False)

    def raw(self):
        """(wqkv, bqkv, wproj, bproj, bias [heads,N,N])."""
        bias = W.swin_bias_from_table(self.relative_position_bias_table, self.window,
                                      self.window, self.relative_position_index)
        return _io(self.qkv), self.qkv.bias, _io(self.proj), self.proj.bias, bias


class HAB(nn.Module):
    """Hybrid Attention Block: (S)W-MSA + conv_scale-scaled CAB conv branch + MLP."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int, compress: int,
                 squeeze: int, conv_scale: float, mlp_ratio: float):
        super().__init__()
        self.window, self.shift, self.num_heads = window, shift, num_heads
        self.conv_scale = conv_scale
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, num_heads)
        self.conv_block = CAB(dim, compress, squeeze)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        # the shift mask as its 4 window types, never the whole image's [nW,N,N]
        self.register_buffer("mask_types", None if shift == 0 else torch.from_numpy(
            W.shift_mask_types(window, window, shift, shift).copy()), persistent=False)
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B,H,W,C]
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        wqkv, bqkv, wproj, bproj, bias = self.attn.raw()
        if hab_is_fused(ws, h, w, c // self.num_heads):
            chain, block = ((cab_chain, fused_hab_block) if self.kernels
                            else (cab_chain_plain, fused_hab_block_plain))
            # the CAB branch comes out rolled; the spatially constant CA gate rides the
            # block's cab_scale operand
            conv_x, sums = chain(x, self.norm1.weight, self.norm1.bias,
                                 *self.conv_block.raw(), out_shift=s)
            gate = self.conv_block.cab[3].gate(sums / (h * w))
            xs, in_shift = x, 0
            if s > 0 and 2 * s == ws:
                in_shift = s    # the block reads its windows from the un-rolled x
            elif s > 0:
                xs = torch.roll(x, (-s, -s), dims=(1, 2)).contiguous()
            out = block(xs, conv_x, self.norm1.weight, self.norm1.bias, self.norm2.weight,
                        self.norm2.bias, wqkv, bqkv, wproj, bproj, *self.mlp.raw(), bias,
                        self.mask_types, (ws, ws), self.num_heads, self.conv_scale,
                        cab_scale=gate, in_shift=in_shift)
            return torch.roll(out, (s, s), dims=(1, 2)) if s > 0 else out

        if hab_keeps_kernels(ws, h, w):
            # windows or heads that B8 refuses: B7, then B14 on LN1(x), then B10's tail
            chain, attend, tail = ((cab_chain, fused_window_attention, fused_residual_ln_mlp)
                                   if self.kernels else
                                   (cab_chain_plain, fused_window_attention_plain,
                                    fused_residual_ln_mlp_plain))
            conv_x, sums = chain(x, self.norm1.weight, self.norm1.bias, *self.conv_block.raw())
            gate = self.conv_block.cab[3].gate(sums / (h * w))
            x_ln = layernorm(x, self.norm1.weight, self.norm1.bias)
            shifted = torch.roll(x_ln, (-s, -s), dims=(1, 2)) if s > 0 else x_ln
            att = attend(shifted.contiguous(), wqkv, bqkv, wproj, bproj, bias, self.mask_types,
                         (ws, ws), self.num_heads)
            if s > 0:
                att = torch.roll(att, (s, s), dims=(1, 2))
            a = (att + conv_x * gate * self.conv_scale).contiguous()
            return tail(a, x, self.norm2.weight, self.norm2.bias, *self.mlp.raw())

        # outside the JAX gate (odd H or W, a window under MIN_FUSED_WINDOW) the block runs
        # in torch around the standalone window-attention kernel, which takes any window
        x_ln = layernorm(x, self.norm1.weight, self.norm1.bias)
        conv_x = self.conv_block(x_ln)
        shifted = torch.roll(x_ln, (-s, -s), dims=(1, 2)) if s > 0 else x_ln
        attend = fused_window_attention if self.kernels else fused_window_attention_plain
        att = attend(shifted.contiguous(), wqkv, bqkv, wproj, bproj, bias, self.mask_types,
                     (ws, ws), self.num_heads)
        if s > 0:
            att = torch.roll(att, (s, s), dims=(1, 2))
        y = x + att + conv_x * self.conv_scale
        return y + self.mlp(layernorm(y, self.norm2.weight, self.norm2.bias))


class OCAB(nn.Module):
    """Overlapping cross-attention block: window x window queries attend to the
    (window + overlap)^2 keys and values around them, then the MLP tail."""

    def __init__(self, dim: int, window: int, overlap_ratio: float, num_heads: int,
                 mlp_ratio: float):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.overlap_window = int(window * overlap_ratio) + window
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((window + self.overlap_window - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.register_buffer(   # a constant, rebuilt and not part of the state dict
            "relative_position_index",
            torch.from_numpy(W.oca_relative_position_index(window, self.overlap_window).copy()),
            persistent=False)
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B,H,W,C]
        ws, overlap = self.window, self.overlap_window - self.window
        q, k, v = (t.contiguous() for t in
                   self.qkv(layernorm(x, self.norm1.weight, self.norm1.bias)).chunk(3, dim=-1))
        bias = W.oca_bias_from_table(self.relative_position_bias_table, ws,
                                     self.overlap_window, self.relative_position_index)
        # a shape outside the gate runs in torch on any device, as the JAX package leaves
        # it to XLA
        fused = self.kernels and ocab_is_fused(ws, overlap)
        attend, tail = ((fused_overlap_attention, fused_residual_ln_mlp) if fused
                        else (fused_overlap_attention_plain, fused_residual_ln_mlp_plain))
        a = attend(q, k, v, _io(self.proj), self.proj.bias, bias, ws, overlap, self.num_heads)
        return tail(a, x, self.norm2.weight, self.norm2.bias, *self.mlp.raw())


class AttenBlocks(nn.Module):
    """The HABs of a group and its OCAB (the reference's ``residual_group``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, compress: int,
                 squeeze: int, conv_scale: float, overlap_ratio: float, mlp_ratio: float):
        super().__init__()
        self.blocks = nn.ModuleList([
            HAB(dim, num_heads, window, 0 if j % 2 == 0 else window // 2, compress, squeeze,
                conv_scale, mlp_ratio) for j in range(depth)])
        self.overlap_attn = OCAB(dim, window, overlap_ratio, num_heads, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.overlap_attn(x)


class RHAG(nn.Module):
    """Residual Hybrid Attention Group: depth x HAB + OCAB + 3x3 conv + skip."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, compress: int,
                 squeeze: int, conv_scale: float, overlap_ratio: float, mlp_ratio: float):
        super().__init__()
        self.residual_group = AttenBlocks(dim, depth, num_heads, window, compress, squeeze,
                                          conv_scale, overlap_ratio, mlp_ratio)
        self.conv = SeamConv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(self.residual_group(x))


class _PatchEmbed(nn.Module):
    """Holds the LayerNorm that follows conv_first (the reference's ``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class HAT(nn.Module):
    """The full HAT x4 SR model. ``forward(lr [B,H,W,3])`` ->
    (sr [B,4H,4W,3], deep features [B,H,W,embed_dim], the output of conv_after_body).
    H and W must be multiples of `window`."""

    def __init__(self, upscale: int = 4, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 12, num_heads: Sequence[int] = (6,) * 12,
                 window: int = 16, compress: int = 3, squeeze: int = 30,
                 conv_scale: float = 0.01, overlap_ratio: float = 0.5,
                 mlp_ratio: float = 2.0, num_feat: int = 64, img_range: float = 1.0):
        super().__init__()
        self.upscale, self.img_range, self.window = upscale, img_range, window
        self.register_buffer("mean", torch.tensor(RGB_MEAN), persistent=False)
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        self.patch_embed = _PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([
            RHAG(embed_dim, d, num_heads[i], window, compress, squeeze, conv_scale,
                 overlap_ratio, mlp_ratio) for i, d in enumerate(depths)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = SeamConv(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(embed_dim, num_feat, 3, padding=1),
                                                  nn.LeakyReLU(0.01))
        # Sequential(conv, PixelShuffle, conv, PixelShuffle): convs at keys upsample.0/2/..;
        # the shuffle is ops.common.pixel_shuffle on NHWC
        ups = []
        for _ in range(int(math.log2(upscale))):
            ups += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1), nn.PixelShuffle(2)]
        self.upsample = nn.Sequential(*ups)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.shape[1] % self.window or x.shape[2] % self.window:
            raise ValueError(f"HAT: {x.shape[1]}x{x.shape[2]} is not a multiple of the "
                             f"{self.window}-px window; pad upstream")
        x = (x - self.mean) * self.img_range
        # the LR/HR convs around the trunk stay library convs, as in the JAX package
        x = _conv_nhwc(self.conv_first, x)
        ln = self.patch_embed.norm
        feat = layernorm(x, ln.weight, ln.bias)
        for layer in self.layers:
            feat = layer(feat)
        deep = self.conv_after_body(layernorm(feat, self.norm.weight, self.norm.bias))
        x = deep + x
        x = F.leaky_relu(_conv_nhwc(self.conv_before_upsample[0], x), 0.01)
        for conv in self.upsample[::2]:
            x = pixel_shuffle(_conv_nhwc(conv, x), 2)
        x = _conv_nhwc(self.conv_last, x)
        return x / self.img_range + self.mean, deep
