"""MUSIQ, the multi-scale image quality transformer. Twin of
``freqfusion_tpu/utils/musiq.py``.

MUSIQ (Ke et al., ICCV 2021) scores an image with a transformer over 32 x 32 patches of a
multi-scale composition (the image at its own resolution plus aspect-preserving resizes to
longer sides 224 and 384), with a hashed 2-D spatial embedding (a G x G grid indexed by each
patch's normalised position), a per-scale embedding and a CLS token whose final state feeds
the score head (MOS in about [0, 100] for the koniq model).

Patch encoder: the 5-layer ResNet root of the paper (weight-standardised 7x7/2 conv +
GroupNorm + ReLU + 3x3/2 max-pool + one pre-activation bottleneck with a 1x1 ``downsample``
projection), flattened in torch's (C,H,W) order and projected by the ``embedding`` Linear;
a checkpoint in the linear layout (``patch_embed.*``) selects a linear encoder instead.

Weights: ``FREQFUSION_MUSIQ_WEIGHTS`` names a torch state dict in the layout documented in
the JAX twin's docstring (``conv_root``, ``gn_root``, ``block1.unit01.*``, ``embedding``,
``cls_token``, ``scale_embedding``, ``spatial_embedding``, ``blocks.{i}.*`` in timm's
naming, ``norm``, ``head``); the size is read from its shapes.

The JAX package pads each image's patch sequence up to a multiple of 512 under an attention
mask, to bound its compiled programs; the port runs the sequence at its own length, which
scores the same (masked keys carry no weight and masked queries are never read).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from ..ops.resize import resize
from .convert import load_torch_checkpoint, load_tower_state

PATCH = 32
GRID = 10
# the official multi-scale composition: the image's own resolution + aspect-preserving
# resizes with these longer sides
LONGER_SIDES = (224, 384)
# the JAX package's sequence bucket; an image's patch budget is 4 buckets
SEQ_BUCKET = 512
MAX_SEQ = 4 * SEQ_BUCKET


class WSConv(nn.Conv2d):
    """Weight-standardised conv (BiT's StdConv): the kernel standardised over (in, kh, kw)
    per output channel, eps 1e-10, no bias, symmetric (k - 1) // 2 padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        m = w.mean(dim=(1, 2, 3), keepdim=True)
        v = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        return F.conv2d(x, (w - m) * torch.rsqrt(v + 1e-10), None, self.stride, self.padding)


def _gn(width: int) -> nn.GroupNorm:
    """GroupNorm(32) with torch's eps; the group count divides small test widths."""
    return nn.GroupNorm(math.gcd(32, width), width, eps=1e-5)


class PreActBottleneck(nn.Module):
    """BiT's pre-activation bottleneck (GN -> ReLU before each conv), with a 1x1
    ``downsample`` projection where the shape changes. NCHW."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = _gn(cin)
        self.conv1 = WSConv(cin, cmid, 1)
        self.gn2 = _gn(cmid)
        self.conv2 = WSConv(cmid, cmid, 3, stride)
        self.gn3 = _gn(cmid)
        self.conv3 = WSConv(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = WSConv(cin, cout, 1, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.gn1(x))
        residual = self.downsample(out) if hasattr(self, "downsample") else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.gn2(out)))
        out = self.conv3(F.relu(self.gn3(out)))
        return out + residual


class ViTBlock(nn.Module):
    """Pre-norm ViT block in timm's layout (``attn.qkv`` packed, ``attn.proj``,
    ``mlp.fc1`` / ``mlp.fc2``), LayerNorm eps 1e-6, exact GELU."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, mlp_dim)
        self.mlp.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.attn.qkv(self.norm1(x)).reshape(b, n, 3, self.heads, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                       # [B, heads, N, hd]
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(d // self.heads), dim=-1)
        x = x + self.attn.proj((att @ v).transpose(1, 2).reshape(b, n, d))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class MUSIQTransformer(nn.Module):
    """``forward(patches [B,N,3*P*P] (P,P,3) order, spatial_idx [B,N], scale_idx [B,N])`` ->
    [B] quality scores: patch encoder + spatial-hash embedding + scale embedding, CLS
    prepended, ``layers`` ViT blocks, score = head(norm(CLS))."""

    def __init__(self, hidden: int = 384, layers: int = 14, heads: int = 6,
                 mlp_dim: int = 1152, grid: int = GRID, num_scales: int = 1 + len(LONGER_SIDES),
                 conv_root: bool = True, root_width: int = 64, root_cout: int = 256):
        super().__init__()
        self.grid = grid
        if conv_root:
            self.conv_root = WSConv(3, root_width, 7, 2)
            self.gn_root = _gn(root_width)
            self.block1 = nn.ModuleDict(
                {"unit01": PreActBottleneck(root_width, root_cout, max(1, root_cout // 4))})
            self.embedding = nn.Linear((PATCH // 4) ** 2 * root_cout, hidden)
        else:
            self.patch_embed = nn.Linear(3 * PATCH * PATCH, hidden)
        self.spatial_embedding = nn.Parameter(0.02 * torch.randn(grid * grid, hidden))
        self.scale_embedding = nn.Parameter(0.02 * torch.randn(num_scales, hidden))
        self.cls_token = nn.Parameter(0.02 * torch.randn(1, 1, hidden))
        self.blocks = nn.ModuleList(ViTBlock(hidden, heads, mlp_dim) for _ in range(layers))
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.head = nn.Linear(hidden, 1)

    def embed_patches(self, patches: torch.Tensor) -> torch.Tensor:
        b, n, _ = patches.shape
        if not hasattr(self, "embedding"):
            return self.patch_embed(patches)
        x = patches.reshape(b * n, PATCH, PATCH, 3).permute(0, 3, 1, 2)
        x = F.relu(self.gn_root(self.conv_root(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        x = self.block1["unit01"](x)
        return self.embedding(x.reshape(b, n, -1))

    def forward(self, patches: torch.Tensor, spatial_idx: torch.Tensor,
                scale_idx: torch.Tensor) -> torch.Tensor:
        x = (self.embed_patches(patches) + self.spatial_embedding[spatial_idx]
             + self.scale_embedding[scale_idx])
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])[:, 0]


def _normalize_musiq_sd(sd):
    """Fold known naming variants onto the canonical conv-root keys: ``block1.unit1.`` ->
    ``block1.unit01.``, ``conv_proj`` / ``proj`` inside the unit -> ``downsample``, a
    ``patch_embedding.`` / ``resnet_emb.`` prefix on the root keys stripped."""
    out = {}
    for k, v in sd.items():
        for pref in ("patch_embedding.", "resnet_emb."):
            if k.startswith(pref):
                k = k[len(pref):]
        k = k.replace("block1.unit1.", "block1.unit01.")
        if k.startswith("block1.unit01."):
            k = k.replace(".conv_proj.", ".downsample.").replace(".proj.", ".downsample.")
        out[k] = v
    return out


def infer_musiq_config(sd) -> MUSIQTransformer:
    """The module built from the checkpoint's own shapes; heads follow the width // 64
    rule, the patch encoder (conv root or linear) the checkpoint's own keys."""
    hidden = sd["cls_token"].shape[-1]
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    grid = int(round(np.sqrt(sd["spatial_embedding"].shape[0])))
    conv_root = "conv_root.weight" in sd
    kw = {}
    if conv_root:
        kw = dict(root_width=sd["conv_root.weight"].shape[0],
                  root_cout=sd["block1.unit01.conv3.weight"].shape[0])
    return MUSIQTransformer(hidden=hidden, layers=layers, heads=max(1, hidden // 64),
                            mlp_dim=sd["blocks.0.mlp.fc1.weight"].shape[0], grid=grid,
                            num_scales=sd["scale_embedding"].shape[0], conv_root=conv_root,
                            **kw)


# ---------------------------------------------------------------------------
# multi-scale patch composition (host side)
# ---------------------------------------------------------------------------

def _arp_size(h: int, w: int, longer: int) -> Tuple[int, int]:
    """Aspect-preserving size with the longer side `longer`."""
    if h >= w:
        return longer, max(1, round(w * longer / h))
    return max(1, round(h * longer / w)), longer


def _patchify(img: np.ndarray, grid: int):
    """float img [H,W,3] -> (patches [n,3PP], spatial hash [n]), the image zero-padded up to
    whole patches (partial border patches take part, zero-filled)."""
    h, w, _ = img.shape
    hp, wp = -(-h // PATCH) * PATCH, -(-w // PATCH) * PATCH
    img = np.pad(img, [(0, hp - h), (0, wp - w), (0, 0)])
    gh, gw = hp // PATCH, wp // PATCH
    p = img.reshape(gh, PATCH, gw, PATCH, 3).transpose(0, 2, 1, 3, 4)
    patches = p.reshape(gh * gw, 3 * PATCH * PATCH)
    # hash: the patch centre normalised by the original extent, on the G x G grid
    ys = (np.arange(gh) + 0.5) * PATCH / max(h, 1)
    xs = (np.arange(gw) + 0.5) * PATCH / max(w, 1)
    ti = np.clip((ys * grid).astype(np.int32), 0, grid - 1)
    tj = np.clip((xs * grid).astype(np.int32), 0, grid - 1)
    hash_ = (ti[:, None] * grid + tj[None, :]).reshape(-1)
    return patches.astype(np.float32), hash_.astype(np.int32)


def compose_multiscale(img: np.ndarray, grid: int = GRID,
                       longer_sides: Sequence[int] = LONGER_SIDES,
                       max_seq: Optional[int] = None):
    """uint8 / float HWC RGB -> (patches [N,3PP], spatial_idx [N], scale_idx [N]) over the
    image at its own size (scale 0) and the aspect-preserving resizes (bicubic, on the
    CPU). `max_seq` drops patches of scale 0 beyond the budget by uniform striding; the
    resized scales always fit."""
    x = np.asarray(img, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    h, w, _ = x.shape
    per_scale: List[Tuple[np.ndarray, np.ndarray, int]] = []
    for s, longer in enumerate(longer_sides, start=1):
        rh, rw = _arp_size(h, w, longer)
        r = resize(torch.from_numpy(x[None]), rh, rw, "bicubic")[0].numpy()
        p, hsh = _patchify(np.clip(r, 0.0, 1.0), grid)
        per_scale.append((p, hsh, s))
    p0, h0 = _patchify(x, grid)
    if max_seq is not None:
        budget = max_seq - sum(p.shape[0] for p, _, _ in per_scale)
        if budget > 0 and p0.shape[0] > budget:
            sel = np.linspace(0, p0.shape[0] - 1, budget).astype(np.int64)
            p0, h0 = p0[sel], h0[sel]
    per_scale.insert(0, (p0, h0, 0))
    patches = np.concatenate([p for p, _, _ in per_scale])
    spatial = np.concatenate([hh for _, hh, _ in per_scale])
    scales = np.concatenate([np.full(p.shape[0], s, np.int32) for p, _, s in per_scale])
    return patches, spatial, scales


def load_musiq(weights_path: str) -> MUSIQTransformer:
    sd = _normalize_musiq_sd(load_torch_checkpoint(weights_path))
    return load_tower_state(infer_musiq_config(sd), sd).eval()


class NativeMUSIQ:
    """MUSIQ score on uint8 HWC RGB images (koniq scale, about [0, 100]), on `device` (the
    card unless the caller names another; without a card the default raises).

    Weights: `weights_path`, else ``FREQFUSION_MUSIQ_WEIGHTS``; without any
    the constructor raises and the musiq column stays NaN. `dtype` is the one the tower
    computes in (float64: a reference)."""

    def __init__(self, weights_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.device, self.dtype = require_device(device), dtype
        weights_path = weights_path or os.environ.get("FREQFUSION_MUSIQ_WEIGHTS")
        if not (weights_path and os.path.exists(weights_path)):
            raise RuntimeError("MUSIQ needs FREQFUSION_MUSIQ_WEIGHTS (state dict in the "
                               "layout documented in utils/musiq.py)")
        self.model = load_musiq(weights_path).to(self.device, dtype)

    def __call__(self, output: np.ndarray, target=None) -> float:
        p, sp, sc = compose_multiscale(output, grid=self.model.grid, max_seq=MAX_SEQ)
        with torch.inference_mode(), pinned_precision("highest"):
            def idx(a):
                return torch.from_numpy(a[None]).to(self.device).long()
            p = torch.from_numpy(p[None]).to(self.device, self.dtype)
            return float(self.model(p, idx(sp), idx(sc))[0])
