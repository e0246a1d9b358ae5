"""DAT expert (Dual Aggregation Transformer) on NHWC tensors. Twin of
``freqfusion_tpu/models/dat.py``.

Shipped ensemble config: embed 180, 6 groups x 6 blocks, 6 heads, split_size (8, 32),
expansion 4.0, img_range 1.0, pixelshuffle x4. Spatial and channel blocks alternate; every
block joins its attention to a depthwise-conv branch (AIM) and ends in a Spatial-Gate FFN.
Module names follow the reference's state-dict keys (``layers.i.blocks.j.attn.attns.k.pos.
pos1.2``, ``attn.dwconv.0/1``, ``channel_interaction.1/2/4``, ``spatial_interaction.0/1/3``,
``ffn.sg.norm``, ``upsample.0/2``, ...) and parameters keep the reference's shapes, so a
state dict of the reference loads as it is (its precomputed buffers ``rpe_biases``,
``relative_position_index`` and ``attn_mask_*`` are rebuilt here and must be dropped).

Where the JAX package runs its Pallas kernels, a CUDA tensor runs the hand-written ones:
the AIM kernels (B5a, B5b) and the fused tail (B6) in every block, kernel B3 in the
group-ending convs and ``conv_after_body``, and the in-kernel-qkv window attention (B4)
when the image is a whole number of windows that B4 takes (64 to 256 tokens in steps of 64,
heads up to 32 wide: ``dat_is_fused``), as every 32-px serving bucket is. Any other shape (a
176-px tile, a ragged direct call, windows of fewer than 64 tokens or of a count B4 does not
take, such as split (6, 24), heads over 32) projects q, k, v first, zero-pads them to whole
windows and takes the pre-projected kernel (B13), which takes any window and head width.
The channel attention's products, the v projection that feeds AIM, the pooled C-Map MLP,
the position-bias MLP and the LR/HR convs around the trunk stay torch, as in the JAX
package. Each module's ``kernels = False`` runs the plain versions on any device, to
compare the two.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import windows as W
from ..ops.common import layernorm, pixel_shuffle
from ..ops.kernels.aim import (aim_conv_branch, aim_conv_branch_plain, aim_gates_proj,
                               aim_gates_proj_plain)
from ..ops.kernels.sgfn import fused_sgfn_tail, fused_sgfn_tail_plain
from ..ops.kernels.wattn import (branch_qkv, fused_window_attention_qkv,
                                 fused_window_attention_qkv_plain,
                                 fused_window_attention_xqkv,
                                 fused_window_attention_xqkv_plain, xqkv_takes)
from .layers import (BatchNorm2d, SeamConv, conv_nhwc as _conv_nhwc, gelu, hwio as _hwio,
                     linear_io_view)

RGB_MEAN = (0.4488, 0.4371, 0.4040)

def dat_is_fused(tokens: int, head_dim: int) -> bool:
    """Whether a spatial branch at whole windows of `tokens` tokens and heads `head_dim` wide
    projects its q, k, v inside kernel B4: what B4's kernel takes (``xqkv_takes``), which
    lies inside the JAX package's gate (64 tokens or more). Any other window or head width
    projects in torch and takes the pre-projected kernel B13, which takes any."""
    return xqkv_takes(tokens, head_dim)


class DynamicPosBias(nn.Module):
    """CrossFormer dynamic relative position bias MLP: 2 -> pos_dim -> pos_dim -> pos_dim
    -> num_heads, LayerNorm + ReLU before each hidden Linear. `dim` is the constructor
    dim; the width is dim // 4 (with branch width D the MLP is D/16 wide)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        pos_dim = dim // 4
        self.pos_proj = nn.Linear(2, pos_dim)
        self.pos1 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(), nn.Linear(pos_dim, pos_dim))
        self.pos2 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(), nn.Linear(pos_dim, pos_dim))
        self.pos3 = nn.Sequential(nn.LayerNorm(pos_dim), nn.ReLU(), nn.Linear(pos_dim, num_heads))

    def forward(self, biases: torch.Tensor) -> torch.Tensor:  # [(2h-1)(2w-1), 2]
        return self.pos3(self.pos2(self.pos1(self.pos_proj(biases))))


class SpatialWindowAttention(nn.Module):
    """One C/2 branch of the spatial attention: (hs, ws) windows with a dynamic position
    bias. It owns the bias MLP and, in a shifted block, the 4 window types of the shift
    mask for shift (sh, sw); the attention itself is ops/kernels/wattn.py."""

    def __init__(self, dim: int, num_heads: int, hs: int, ws: int, shift=None):
        super().__init__()
        self.num_heads, self.hs, self.ws = num_heads, hs, ws
        self.pos = DynamicPosBias(dim // 4, num_heads)
        # constants, rebuilt and not part of the state dict
        self.register_buffer("rpe_biases",
                             torch.from_numpy(W.relative_coords_table(hs, ws).copy()),
                             persistent=False)
        self.register_buffer("relative_position_index",
                             torch.from_numpy(W.relative_position_index(hs, ws).copy()),
                             persistent=False)
        self.register_buffer("mask_types", None if shift is None else
                             torch.from_numpy(W.shift_mask_types(hs, ws, *shift).copy()),
                             persistent=False)

    def bias(self) -> torch.Tensor:
        """[num_heads, N, N] position bias."""
        return W.swin_bias_from_table(self.pos(self.rpe_biases), self.hs, self.ws,
                                      self.relative_position_index)


class _AIM(nn.Module):
    """What both attention variants share: the depthwise-conv branch, the two interaction
    heads and the output projection, with the reference's Sequential indices as keys."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1, groups=dim),
                                    BatchNorm2d(dim), nn.GELU())
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // 8, 1), BatchNorm2d(dim // 8),
            nn.GELU(), nn.Conv2d(dim // 8, dim, 1))
        self.spatial_interaction = nn.Sequential(
            nn.Conv2d(dim, dim // 16, 1), BatchNorm2d(dim // 16), nn.GELU(),
            nn.Conv2d(dim // 16, 1, 1))
        self.proj = nn.Linear(dim, dim)
        self.kernels = True

    def conv_weights(self):
        """(wdw, bdw, bn_scale, bn_shift) in the layouts of ops/kernels/aim.py."""
        return (_hwio(self.dwconv[0]), self.dwconv[0].bias, *self.dwconv[1].affine_eval())

    def gates_weights(self):
        """The S-Map's and the projection's parameters in the layouts of
        ops/kernels/aim.py, in the order of aim_gates_proj's arguments. fc1's and the
        projection's weights are views: the kernel keeps their split planes on them."""
        fc1, bn, fc2 = (self.spatial_interaction[i] for i in (0, 1, 3))
        return (fc1.weight.permute(2, 3, 1, 0), fc1.bias, *bn.affine_eval(), _hwio(fc2),
                fc2.bias, linear_io_view(self.proj), self.proj.bias)

    def conv_branch(self, v: torch.Tensor):
        """v -> (conv_x, sums of conv_x [B,1,1,C]): kernel B5a."""
        fn = aim_conv_branch if self.kernels else aim_conv_branch_plain
        return fn(v, *self.conv_weights())

    def channel_map(self, pooled: torch.Tensor) -> torch.Tensor:
        """The C-Map before its sigmoid from a pooled [B,1,1,C] vector: 1x1 (C -> C/8) ->
        BN -> GELU -> 1x1 (C/8 -> C)."""
        fc1, bn, fc2 = (self.channel_interaction[i] for i in (1, 2, 4))
        # in pooled's dtype: the f32 sums of a bf16 model's B5a keep f32, as in JAX
        w1, b1, w2, b2, scale, shift = (t.to(pooled.dtype) for t in (
            fc1.weight, fc1.bias, fc2.weight, fc2.bias, *bn.affine_eval()))
        g = pooled @ w1.flatten(1).t() + b1
        return gelu(g * scale + shift) @ w2.flatten(1).t() + b2

    def gates_proj(self, attened, conv_x, chmap, swap: bool) -> torch.Tensor:
        """Both gates, their sum and the projection: kernel B5b."""
        fn = aim_gates_proj if self.kernels else aim_gates_proj_plain
        return fn(attened, conv_x, chmap, *self.gates_weights(), swap=swap)


def _should_shift(rg_idx: int, b_idx: int) -> bool:
    return ((rg_idx % 2 == 0 and b_idx > 0 and (b_idx - 2) % 4 == 0)
            or (rg_idx % 2 != 0 and b_idx % 4 == 0))


class AdaptiveSpatialAttention(_AIM):
    """Dual rectangular-window attention, (s0, s1) windows on one half of the channels
    and (s1, s0) on the other, + AIM."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int], shift: bool):
        super().__init__(dim)
        self.num_heads = num_heads
        self.split_size = tuple(split_size)
        self.shift_size = (split_size[0] // 2, split_size[1] // 2)
        self.shift = shift
        self.qkv = nn.Linear(dim, 3 * dim)
        s0, s1 = self.split_size
        sh0, sh1 = self.shift_size
        self.attns = nn.ModuleList([
            SpatialWindowAttention(dim // 2, num_heads // 2, s0, s1,
                                   (sh0, sh1) if shift else None),
            SpatialWindowAttention(dim // 2, num_heads // 2, s1, s0,
                                   (sh1, sh0) if shift else None)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B,H,W,C]
        b, h, w, c = x.shape
        wqkv, bqkv = linear_io_view(self.qkv), self.qkv.bias
        s0, s1 = self.split_size
        sh0, sh1 = self.shift_size
        mx = max(s0, s1)
        ph, pw = (mx - h % mx) % mx, (mx - w % mx) % mx
        half = c // 2
        # The in-kernel projection needs whole windows: zero-padding q, k, v AFTER the
        # projection (as the reference does) differs from projecting a zero-padded image,
        # where the bias lands in the pad region. Serving pads to 32-px buckets, so this
        # is the served path; ragged shapes and windows or heads that kernel does not take
        # (dat_is_fused) project first and take the pre-projected kernel, which takes any.
        fused_x = ph == 0 and pw == 0 and dat_is_fused(s0 * s1, half // (self.num_heads // 2))
        if fused_x:
            v = x @ wqkv[:, 2 * c:] + bqkv[2 * c:]   # AIM's conv branch needs the v image
        else:
            q, k, v = (x @ wqkv + bqkv).chunk(3, dim=-1)
            qp, kp, vp = (F.pad(t, (0, 0, 0, pw, 0, ph)) if ph or pw else t
                          for t in (q, k, v))

        outs = []
        for br, (hs, ws, sh, sw) in enumerate(((s0, s1, sh0, sh1), (s1, s0, sh1, sh0))):
            mask = self.attns[br].mask_types   # None unless the block shifts
            bias = self.attns[br].bias()
            heads = self.num_heads // 2
            if fused_x:
                xb = torch.roll(x, (-sh, -sw), dims=(1, 2)) if self.shift else x
                if self.kernels:   # the parameter itself, and the branch's columns (`cols`):
                    # the kernel's head slabs are kept on the parameter
                    o = fused_window_attention_xqkv(xb.contiguous(), wqkv, bqkv, bias, mask,
                                                    (hs, ws), heads, (br * half, half))
                else:
                    wb, bb = branch_qkv(wqkv, bqkv, br * half, half)
                    o = fused_window_attention_xqkv_plain(xb, wb, bb, bias, mask, (hs, ws),
                                                          heads)
            else:
                sl = slice(br * half, br * half + half)
                qb, kb, vb = qp[..., sl], kp[..., sl], vp[..., sl]
                if self.shift:
                    qb, kb, vb = (torch.roll(t, (-sh, -sw), dims=(1, 2))
                                  for t in (qb, kb, vb))
                fn = (fused_window_attention_qkv if self.kernels
                      else fused_window_attention_qkv_plain)
                o = fn(qb.contiguous(), kb.contiguous(), vb.contiguous(), bias, mask,
                       (hs, ws), heads)
            if self.shift:
                o = torch.roll(o, (sh, sw), dims=(1, 2))
            outs.append(o[:, :h, :w])
        attened = torch.cat(outs, dim=-1)

        conv_x, sums = self.conv_branch(v.contiguous())
        chmap = self.channel_map(sums / (h * w))
        return self.gates_proj(attened, conv_x, chmap, swap=False)


class AdaptiveChannelAttention(_AIM):
    """XCiT-style cross-covariance channel attention + AIM. Tensors stay [B,N,C]: the
    per-head Grams are the diagonal blocks of the full [C,C] Gram of the l2-normalised
    q and k, and attention is applied as one product with the block-diagonal matrix."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__(dim)
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B,H,W,C]
        b, h, w, c = x.shape
        nh, hd = self.num_heads, c // self.num_heads
        qf, kf, vf = self.qkv(x).reshape(b, h * w, 3 * c).chunk(3, dim=-1)
        qn = qf.square().sum(dim=1).sqrt().clamp_min(1e-12)   # [B,C]
        kn = kf.square().sum(dim=1).sqrt().clamp_min(1e-12)
        gram = qf.transpose(1, 2) @ kf / (qn[:, :, None] * kn[:, None, :])
        blocks = torch.stack([gram[:, i * hd:(i + 1) * hd, i * hd:(i + 1) * hd]
                              for i in range(nh)], dim=1)      # [B,heads,hd,hd]
        attn = torch.softmax(blocks * self.temperature, dim=-1)
        bd = torch.stack([torch.block_diag(*a) for a in attn])  # [B,C,C]
        attened = (vf @ bd.transpose(1, 2)).reshape(b, h, w, c)

        conv_x, _ = self.conv_branch(vf.reshape(b, h, w, c).contiguous())
        chmap = self.channel_map(attened.mean(dim=(1, 2), keepdim=True))
        return self.gates_proj(attened, conv_x, chmap, swap=True)


class _SpatialGate(nn.Module):
    """Parameters of the SGFN gate: LayerNorm + 3x3 depthwise conv on half the hidden."""

    def __init__(self, half: int):
        super().__init__()
        self.norm = nn.LayerNorm(half)
        self.conv = nn.Conv2d(half, half, 3, padding=1, groups=half)


class SGFN(nn.Module):
    """Spatial-Gate FFN: fc1 -> GELU -> x1 * dwconv(LN(x2)) -> fc2. It holds the
    parameters; the block's fused tail (kernel B6) applies them."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = _SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)

    def raw(self):
        """(w1, b1, sg_w, sg_b, wdw, bdw, w2, b2) in the layouts of ops/kernels/sgfn.py."""
        return (linear_io_view(self.fc1), self.fc1.bias, self.sg.norm.weight,
                self.sg.norm.bias, _hwio(self.sg.conv), self.sg.conv.bias,
                linear_io_view(self.fc2), self.fc2.bias)


class DATB(nn.Module):
    """Dual Aggregation Transformer Block: x + attn(LN(x)), then the SGFN tail."""

    def __init__(self, dim: int, num_heads: int, split_size: Sequence[int],
                 expansion: float, spatial: bool, shift: bool):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = (AdaptiveSpatialAttention(dim, num_heads, split_size, shift) if spatial
                     else AdaptiveChannelAttention(dim, num_heads))
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = SGFN(dim, int(dim * expansion))
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(layernorm(x, self.norm1.weight, self.norm1.bias))
        tail = fused_sgfn_tail if self.kernels else fused_sgfn_tail_plain
        return tail(h.contiguous(), x, self.norm2.weight, self.norm2.bias, *self.ffn.raw())


class ResidualGroup(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, split_size: Sequence[int],
                 expansion: float, rg_idx: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            DATB(dim, num_heads, split_size, expansion, j % 2 == 0, _should_shift(rg_idx, j))
            for j in range(depth)])
        self.conv = SeamConv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for blk in self.blocks:
            x = blk(x)
        return res + self.conv(x)


class DAT(nn.Module):
    """The full DAT x4 SR model. ``forward(lr [B,H,W,3])`` ->
    (sr [B,4H,4W,3], deep features [B,H,W,embed_dim], the output of conv_after_body)."""

    def __init__(self, upscale: int = 4, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 split_size: Sequence[int] = (8, 32), expansion: float = 4.0,
                 num_feat: int = 64, img_range: float = 1.0):
        super().__init__()
        self.upscale, self.img_range = upscale, img_range
        self.register_buffer("mean", torch.tensor(RGB_MEAN), persistent=False)
        self.conv_first = nn.Conv2d(3, embed_dim, 3, padding=1)
        # Sequential(rearrange, LayerNorm) in the reference: the key is before_RG.1
        self.before_RG = nn.Sequential(nn.Identity(), nn.LayerNorm(embed_dim))
        self.layers = nn.ModuleList([
            ResidualGroup(embed_dim, d, num_heads[i], split_size, expansion, i)
            for i, d in enumerate(depths)])
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
        x = (x - self.mean) * self.img_range
        # the LR/HR convs around the trunk stay library convs, as in the JAX package
        x = _conv_nhwc(self.conv_first, x)
        ln = self.before_RG[1]
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
