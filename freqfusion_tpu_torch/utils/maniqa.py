"""MANIQA: a ViT with transposed and window attention stages. Twin of
``freqfusion_tpu/utils/maniqa.py``.

MANIQA (Yang et al., CVPRW 2022) scores a 224 x 224 crop by
  1. a ViT-B/8 whose token outputs after blocks 6 to 9 are concatenated over channels (CLS
     dropped) into a 28 x 28 feature map,
  2. two stages of [TABlock x 2 -> 1x1 conv -> a 2-block Swin stage (window 4, shifts 0 and
     2, relative-position bias, residuals x 0.8)], where a TABlock attends across channels
     (a C x C attention over the token vectors),
  3. a score head (ReLU) and a weight head (sigmoid) per token; the crop's score is the
     weighted mean of the token scores, in [0, 1].
An image's score is the mean over 20 seeded random crops (``FREQFUSION_MANIQA_CROPS=five``:
five fixed crops; an integer: that many random crops). The crops come from numpy's
generator with the JAX package's seed, so both packages score the same pixels.

The TABlock keeps the published model's output quirk: ``attn @ v`` [B,C,N] is transposed
to [B,N,C] and then reshaped, not transposed, back to [B,C,N] before the residual.

Weights: ``FREQFUSION_MANIQA_WEIGHTS`` names a torch state dict in the layout documented in
the JAX twin's docstring (``vit.*`` in timm's naming, ``tablock{1,2}.{i}.c_q/c_k/c_v``,
``conv1``, ``conv2``, ``swintransformer{1,2}.blocks.{j}.*``, ``fc_score.{0,3}``,
``fc_weight.{0,3}``); the sizes are read from its shapes. Inputs are normalised with mean =
std = 0.5.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from ..ops import windows as W
from ..ops.resize import resize
from .convert import load_torch_checkpoint, load_tower_state
from .musiq import ViTBlock

NORM_MEAN = 0.5
NORM_STD = 0.5


class ViTBackbone(nn.Module):
    """timm-style ViT returning the token sequences (CLS dropped) after blocks `feat_idx`."""

    def __init__(self, width: int = 768, patch: int = 8, layers: int = 12, heads: int = 12,
                 feat_idx: Sequence[int] = (6, 7, 8, 9), tokens: int = 784):
        super().__init__()
        self.feat_idx = tuple(feat_idx)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, width, patch, stride=patch)
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, width))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, tokens + 1, width))
        self.blocks = nn.ModuleList(ViTBlock(width, heads, 4 * width) for _ in range(layers))

    def forward(self, x: torch.Tensor):
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], dim=1) + self.pos_embed
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.feat_idx:
                feats.append(x[:, 1:])
        return feats


class TABlock(nn.Module):
    """Transposed attention over [B, C, N] token vectors, with the published output quirk:
    ``(attn @ v).transpose(1, 2).reshape(B, C, N)``, a reinterpretation of memory."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.c_q, self.c_k, self.c_v = nn.Linear(n, n), nn.Linear(n, n), nn.Linear(n, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.c_q(x), self.c_k(x), self.c_v(x)
        att = torch.softmax((q @ k.transpose(1, 2)) * self.n ** -0.5, dim=-1)   # [B, C, C]
        return x + (att @ v).transpose(1, 2).reshape(x.shape)


class SwinStageBlock(nn.Module):
    """One Swin-style block on [B,H,W,C]: window attention with a relative-position bias
    (shifted by `shift` under the Swin mask), residuals scaled by `res_scale`."""

    def __init__(self, dim: int, heads: int, window: int, mlp_dim: int, shift: int,
                 res_scale: float):
        super().__init__()
        self.heads, self.window, self.shift, self.res_scale = heads, window, shift, res_scale
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.attn.relative_position_bias_table = nn.Parameter(
            0.02 * torch.randn((2 * window - 1) ** 2, heads))
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, mlp_dim)
        self.mlp.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, nh, s = self.window, self.heads, self.shift
        hd = c // nh
        shortcut = x
        x = self.norm1(x)
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        bias = W.swin_bias_from_table(self.attn.relative_position_bias_table, ws, ws)
        xw = W.window_partition(x, ws, ws)                          # [B*nW, ws^2, C]
        bw, n, _ = xw.shape
        q, k, v = self.attn.qkv(xw).reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        att = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias[None]
        if s:
            m = torch.from_numpy(W.shift_attn_mask(h, w, ws, ws, s, s).copy()).to(att)
            nw = m.shape[0]
            att = (att.reshape(bw // nw, nw, nh, n, n) + m[None, :, None]).reshape(bw, nh, n, n)
        o = (torch.softmax(att, dim=-1) @ v).transpose(1, 2).reshape(bw, n, c)
        o = W.window_reverse(self.attn.proj(o), ws, ws, h, w)
        if s:
            o = torch.roll(o, (s, s), dims=(1, 2))
        x = shortcut + self.res_scale * o
        return x + self.res_scale * self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class _Swin(nn.Module):
    """``blocks``: the key level of ``swintransformer{1,2}.blocks.{j}``."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class MANIQA(nn.Module):
    """``forward(x [B,S,S,3] in [0, 1])`` -> [B] scores in [0, 1]; S = vit_patch * side,
    side^2 = the token count the TABlocks were built for."""

    def __init__(self, vit_width: int = 768, vit_patch: int = 8, vit_layers: int = 12,
                 feat_idx: Sequence[int] = (6, 7, 8, 9), dim1: int = 768, dim2: int = 384,
                 num_tab: int = 2, window: int = 4, swin_depth: int = 2, swin_heads: int = 4,
                 mlp_dim: int = 768, res_scale: float = 0.8, image_size: int = 224):
        super().__init__()
        self.vit_patch = vit_patch
        self.side = image_size // vit_patch
        n = self.side ** 2
        self.vit = ViTBackbone(vit_width, vit_patch, vit_layers, max(1, vit_width // 64),
                               feat_idx, n)
        self.tablock1 = nn.ModuleList(TABlock(n) for _ in range(num_tab))
        self.conv1 = nn.Conv2d(len(tuple(feat_idx)) * vit_width, dim1, 1)
        self.swintransformer1 = _Swin(
            SwinStageBlock(dim1, swin_heads, window, mlp_dim, 0 if j % 2 == 0 else window // 2,
                           res_scale) for j in range(swin_depth))
        self.tablock2 = nn.ModuleList(TABlock(n) for _ in range(num_tab))
        self.conv2 = nn.Conv2d(dim1, dim2, 1)
        self.swintransformer2 = _Swin(
            SwinStageBlock(dim2, swin_heads, window, mlp_dim, 0 if j % 2 == 0 else window // 2,
                           res_scale) for j in range(swin_depth))
        self.fc_score = nn.Sequential(nn.Linear(dim2, dim2), nn.ReLU(), nn.Dropout(0.1),
                                      nn.Linear(dim2, 1), nn.ReLU())
        self.fc_weight = nn.Sequential(nn.Linear(dim2, dim2), nn.ReLU(), nn.Dropout(0.1),
                                       nn.Linear(dim2, 1), nn.Sigmoid())

    def _stage(self, f: torch.Tensor, tabs, conv: nn.Conv2d, swin: _Swin) -> torch.Tensor:
        b = f.shape[0]
        f = f.transpose(1, 2)                                          # [B, C, N]
        for tab in tabs:
            f = tab(f)
        f = f.transpose(1, 2).reshape(b, self.side, self.side, -1)
        f = F.linear(f, conv.weight.flatten(1), conv.bias)             # the 1x1 conv
        for blk in swin.blocks:
            f = blk(f)
        return f.reshape(b, self.side * self.side, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = torch.cat(self.vit((x - NORM_MEAN) / NORM_STD), dim=-1)   # [B, N, K*D]
        f = self._stage(f, self.tablock1, self.conv1, self.swintransformer1)
        t = self._stage(f, self.tablock2, self.conv2, self.swintransformer2)
        s = self.fc_score(t)[..., 0]
        wgt = self.fc_weight(t)[..., 0]
        return (s * wgt).sum(-1) / (wgt.sum(-1) + 1e-8)


def infer_maniqa_config(sd) -> MANIQA:
    """The module built from the checkpoint's own shapes. The four feature depths are the
    published (6, 7, 8, 9) where the ViT is deep enough, else its last min(4, layers)
    blocks; the input size follows from the TABlocks' token count."""
    width = sd["vit.cls_token"].shape[-1]
    patch = sd["vit.patch_embed.proj.weight"].shape[-1]
    layers = len({k.split(".")[2] for k in sd if k.startswith("vit.blocks.")})
    if layers >= 10:
        feat_idx = (6, 7, 8, 9)
    else:
        k = min(4, layers)
        feat_idx = tuple(range(layers - k, layers))
    table = sd["swintransformer1.blocks.0.attn.relative_position_bias_table"]
    side = int(round(np.sqrt(sd["tablock1.0.c_q.weight"].shape[0])))
    return MANIQA(vit_width=width, vit_patch=patch, vit_layers=layers, feat_idx=feat_idx,
                  dim1=sd["conv1.weight"].shape[0], dim2=sd["conv2.weight"].shape[0],
                  num_tab=len({k.split(".")[1] for k in sd if k.startswith("tablock1.")}),
                  window=(int(round(np.sqrt(table.shape[0]))) + 1) // 2,
                  swin_depth=len({k.split(".")[2] for k in sd
                                  if k.startswith("swintransformer1.blocks.")}),
                  swin_heads=table.shape[1],
                  mlp_dim=sd["swintransformer1.blocks.0.mlp.fc1.weight"].shape[0],
                  image_size=side * patch)


def _upscale_to_min(img: np.ndarray, size: int) -> np.ndarray:
    h, w, _ = img.shape
    if h < size or w < size:
        s = size / min(h, w)
        nh, nw = max(size, round(h * s)), max(size, round(w * s))
        img = resize(torch.from_numpy(np.ascontiguousarray(img)[None]), nh, nw,
                     "bicubic")[0].numpy()
        img = np.clip(img, 0.0, 1.0)
    return img


def five_crops(img: np.ndarray, size: int) -> np.ndarray:
    """Five fixed crops (the four corners and the centre) of `size`, after an upscale where
    the image is smaller (``FREQFUSION_MANIQA_CROPS=five``)."""
    img = _upscale_to_min(img, size)
    h, w, _ = img.shape
    crops = [img[0:size, 0:size], img[h - size:, 0:size], img[0:size, w - size:],
             img[h - size:, w - size:],
             img[(h - size) // 2:(h - size) // 2 + size, (w - size) // 2:(w - size) // 2 + size]]
    return np.stack(crops)


def random_crops(img: np.ndarray, size: int, num: int, seed: int = 0) -> np.ndarray:
    """The published protocol: `num` random crops of `size`, averaged by the caller; seeded
    (numpy's default_rng(seed), as the JAX package) so that the score is deterministic."""
    img = _upscale_to_min(img, size)
    h, w, _ = img.shape
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h - size + 1, size=num)
    xs = rng.integers(0, w - size + 1, size=num)
    return np.stack([img[y:y + size, x:x + size] for y, x in zip(ys, xs)])


def load_maniqa(weights_path: str) -> MANIQA:
    sd = load_torch_checkpoint(weights_path)
    return load_tower_state(infer_maniqa_config(sd), sd).eval()


class NativeMANIQA:
    """MANIQA score on uint8 HWC RGB images (higher is better, in [0, 1]), on `device` (the
    card unless the caller names another; without a card the default raises).

    Weights: `weights_path`, else ``FREQFUSION_MANIQA_WEIGHTS``; without any
    the constructor raises and the maniqa column stays NaN. Crops: `num_crops`, else
    ``FREQFUSION_MANIQA_CROPS`` (default 20; ``five`` for the five fixed crops). `dtype` is
    the one the tower computes in (float64: a reference)."""

    def __init__(self, weights_path: Optional[str] = None, num_crops: Optional[int] = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        self.device, self.dtype = require_device(device), dtype
        weights_path = weights_path or os.environ.get("FREQFUSION_MANIQA_WEIGHTS")
        if not (weights_path and os.path.exists(weights_path)):
            raise RuntimeError("MANIQA needs FREQFUSION_MANIQA_WEIGHTS (state dict in the "
                               "layout documented in utils/maniqa.py)")
        self.model = load_maniqa(weights_path).to(self.device, dtype)
        self.size = self.model.side * self.model.vit_patch
        if num_crops is None:
            env = os.environ.get("FREQFUSION_MANIQA_CROPS", "20")
            num_crops = 0 if env == "five" else int(env)
        self.num_crops = num_crops

    def crops(self, output: np.ndarray) -> np.ndarray:
        x = np.asarray(output, np.float32)
        if x.max() > 1.5:
            x = x / 255.0
        if self.num_crops > 0:
            return random_crops(x, self.size, self.num_crops)
        return five_crops(x, self.size)

    def __call__(self, output: np.ndarray, target=None) -> float:
        with torch.inference_mode(), pinned_precision("highest"):
            scores = self.model(torch.from_numpy(self.crops(output)).to(self.device, self.dtype))
            return float(scores.mean())
