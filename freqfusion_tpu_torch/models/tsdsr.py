"""TSD-SR diffusion refinement of a served image (the reference's optional Phase 7c) on
NHWC tensors. Twin of ``freqfusion_tpu/models/tsdsr.py``.

A DiT (sinusoidal time embedding, adaLN-conditioned transformer blocks over patch-embedded
latents, zero-initialised final projection, a 0.1-scaled one-step residual refinement at
t = 500) and the inference wrapper with a 1-step student path and a multi-step teacher
path, around the SD AutoencoderKL codec of ``models/vae.py`` (scale 0.18215).

Without weights the refiner is an identity and ``TSDSRInference.available`` says so, as
in the reference: ``FREQFUSION_TSDSR_WEIGHTS`` names the DiT checkpoint and
``FREQFUSION_SDVAE_WEIGHTS`` the VAE's. A file that does not load leaves the identity
with a warning. The DiT patchifies with a stride-`patch` conv, so a latent whose sides
are not multiples of the patch (an image whose sides are not multiples of 16 at patch 2)
raises, as the JAX twin does when it adds the residual.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from ..utils import convert as cv
from .vae import MissingWeights, SDVAECodec, read_state_dict

WEIGHTS_ENV = "FREQFUSION_TSDSR_WEIGHTS"


def sinusoidal_time_embed(t: torch.Tensor, dim: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] timesteps -> [B, dim] sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=dtype, device=t.device) / (half - 1))
    ang = t[:, None].to(dtype) * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class AdaLayerNorm(nn.Module):
    """adaLN: an affine-free LayerNorm modulated by scale / shift (zero-initialised) from
    the condition."""

    def __init__(self, hidden: int):
        super().__init__()
        self.mod = nn.Linear(hidden, 2 * hidden)
        nn.init.zeros_(self.mod.weight)
        nn.init.zeros_(self.mod.bias)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        scale, shift = self.mod(cond).chunk(2, dim=-1)
        x = F.layer_norm(x, (x.shape[-1],), eps=1e-6)
        return x * (1.0 + scale[:, None]) + shift[:, None]


class DiTBlock(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.heads = heads
        self.norm1 = AdaLayerNorm(hidden)
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.norm2 = AdaLayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, int(hidden * mlp_ratio))
        self.fc2 = nn.Linear(int(hidden * mlp_ratio), hidden)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x, cond)
        b, n, c = h.shape
        q, k, v = self.qkv(h).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)                 # [B, heads, N, hd]
        x = x + self.proj(o.transpose(1, 2).reshape(b, n, c))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x, cond))))


class DiT(nn.Module):
    """Latent-space diffusion transformer: [B,H,W,C_lat], timesteps [B] -> predicted noise
    [B,H,W,C_lat]."""

    def __init__(self, in_channels: int = 4, hidden: int = 768, depth: int = 12,
                 heads: int = 12, mlp_ratio: float = 4.0, patch: int = 2,
                 time_embed_dim: int = 256):
        super().__init__()
        self.patch, self.time_embed_dim = patch, time_embed_dim
        self.patch_embed = nn.Conv2d(in_channels, hidden, patch, stride=patch)
        self.time_fc1 = nn.Linear(time_embed_dim, 4 * hidden)
        self.time_fc2 = nn.Linear(4 * hidden, hidden)
        self.blocks = nn.ModuleList(DiTBlock(hidden, heads, mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.final_layer = nn.Linear(hidden, patch * patch * in_channels)
        nn.init.zeros_(self.final_layer.weight)
        nn.init.zeros_(self.final_layer.bias)

    def forward(self, x: torch.Tensor, timestep: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        p = self.patch
        tokens = self.patch_embed(x.permute(0, 3, 1, 2))
        gh, gw = tokens.shape[2], tokens.shape[3]
        tokens = tokens.flatten(2).transpose(1, 2)                  # [B, gh*gw, hidden]
        t = sinusoidal_time_embed(timestep, self.time_embed_dim, x.dtype)
        t = self.time_fc2(F.gelu(self.time_fc1(t)))
        for blk in self.blocks:
            tokens = blk(tokens, t)
        out = self.final_layer(self.norm(tokens)).reshape(b, gh, gw, p, p, c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, c)


class TSDSRDiT(nn.Module):
    """One-step refinement head: latent + 0.1 * DiT(latent, t) (t = 500 unless given)."""

    def __init__(self, hidden: int = 768, depth: int = 12, heads: int = 12,
                 one_step_timestep: int = 500, in_channels: int = 4, mlp_ratio: float = 4.0,
                 patch: int = 2, time_embed_dim: int = 256):
        super().__init__()
        self.one_step_timestep = one_step_timestep
        self.dit = DiT(in_channels, hidden, depth, heads, mlp_ratio, patch, time_embed_dim)

    def forward(self, latent: torch.Tensor,
                timestep: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.dit.patch
        if latent.shape[1] % p or latent.shape[2] % p:
            raise ValueError(f"latent {latent.shape[1]}x{latent.shape[2]} is not a whole "
                             f"number of {p}x{p} patches: the DiT's prediction would be "
                             "smaller than the latent it refines")
        if timestep is None:
            timestep = torch.full((latent.shape[0],), float(self.one_step_timestep),
                                  device=latent.device)
        return latent + self.dit(latent, timestep) * 0.1


def tsdsr_small() -> TSDSRDiT:
    return TSDSRDiT(hidden=384, depth=12, heads=6)


def tsdsr_base() -> TSDSRDiT:
    return TSDSRDiT(hidden=768, depth=12, heads=12)


def tsdsr_key(path) -> str:
    """JAX TSD-SR param path -> torch key of the DiT checkpoint contract (own copy of the
    JAX package's ``tsdsr_key_fn``): ('dit','blocks_3','norm1','mod','kernel') ->
    'dit.blocks.3.norm1.mod.weight'. The port's ``TSDSRDiT`` has these keys."""
    parts = [p for p in path if p != "params"]
    leaf = {"kernel": "weight", "bias": "bias", "scale": "weight"}[parts[-1]]
    mods = [f"blocks.{p.split('_', 1)[1]}" if p.startswith("blocks_") else p
            for p in parts[:-1]]
    return ".".join(mods + [leaf])


def tsdsr_params_from_flax(params: Mapping, model: TSDSRDiT):
    """The JAX ``TSDSRDiT`` params -> a state dict for the port's `model`."""
    return cv.tower_params_from_flax(params, tsdsr_key, {k: tuple(v.shape) for k, v in
                                                         model.state_dict().items()})


def infer_dit_config(sd) -> dict:
    """The constructor keywords of the DiT that a state dict holds, from its shapes (the
    reference's state-dict analysis, resolved into an architecture)."""
    pe = sd["dit.patch_embed.weight"]           # OIHW [hidden, in, p, p]
    hidden, in_ch, p = int(pe.shape[0]), int(pe.shape[1]), int(pe.shape[2])
    depth = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("dit.blocks."))
    mlp = int(sd["dit.blocks.0.fc1.weight"].shape[0])
    return dict(hidden=hidden, in_channels=in_ch, patch=p, depth=depth,
                heads=max(1, hidden // 64),      # head width 64 (the DiT family)
                mlp_ratio=mlp / hidden,
                time_embed_dim=int(sd["dit.time_fc1.weight"].shape[1]))


def load_tsdsr_params(weights_path: str) -> TSDSRDiT:
    """A TSD-SR DiT checkpoint (``.safetensors`` or torch ``.pth`` / ``.ckpt``; a bare DiT
    dump without the ``dit.`` prefix too) -> ``TSDSRDiT`` with its weights, the
    architecture inferred from the shapes; strict."""
    sd = read_state_dict(weights_path)
    if not any(k.startswith("dit.") for k in sd):
        sd = {f"dit.{k}": v for k, v in sd.items()}
    return cv.load_tower_state(TSDSRDiT(**infer_dit_config(sd)), sd)


class TSDSRInference:
    """Encode -> student (one step at t = 500) or teacher (`num_steps` descending
    timesteps from 999 to 1, a chain of residual refinements) -> decode, on `device` (the
    card unless the caller names another), f32 with TF32 off.

    Without a DiT or a codec, `refine` is the identity, as the reference's passthrough
    when weights are missing. A DiT not given is loaded from FREQFUSION_TSDSR_WEIGHTS, a
    codec not given from FREQFUSION_SDVAE_WEIGHTS (``SDVAECodec``); a file that does not
    load warns and leaves the identity."""

    def __init__(self, dit: Optional[TSDSRDiT] = None, codec: Optional[SDVAECodec] = None,
                 mode: str = "student", num_steps: int = 20, device="cuda"):
        if mode not in ("student", "teacher"):
            raise ValueError(f"mode={mode!r}; expected 'student' or 'teacher'")
        self.device = require_device(device)
        wpath = os.environ.get(WEIGHTS_ENV)
        if dit is None and wpath:
            try:
                dit = load_tsdsr_params(wpath)
            except Exception as e:   # a bad file: degrade and warn, as the codec below
                warnings.warn(f"TSD-SR DiT loading failed ({e!r}); the refiner stays an "
                              "identity passthrough")
        if codec is None and dit is not None:
            try:
                codec = SDVAECodec(device=self.device)
            except MissingWeights:
                codec = None
            except Exception as e:   # a bad or incompatible file
                warnings.warn(f"VAE loading failed ({e!r}); TSD-SR stays an identity "
                              "passthrough")
        self.dit = None if dit is None else dit.to(self.device).eval()
        self.codec = codec
        self.mode, self.num_steps = mode, num_steps

    @property
    def available(self) -> bool:
        return self.dit is not None and self.codec is not None

    def refine(self, sr_img: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in [0,1] (H, W multiples of 8 x the DiT's patch) -> refined image."""
        if not self.available:
            return sr_img
        with torch.inference_mode(), pinned_precision("highest"):
            lat = self.codec.encode(sr_img.to(self.device))
            if self.mode == "student":
                lat = self.dit(lat)
            else:
                for t in np.linspace(999, 1, self.num_steps):
                    lat = self.dit(lat, torch.full((lat.shape[0],), float(t),
                                                   device=lat.device))
            return self.codec.decode(lat).clamp(0.0, 1.0)


class CompleteSRPipeline:
    """The fused output plus the optional frozen TSD-SR refinement:
    ``__call__(sr, use_tsdsr=True)``."""

    def __init__(self, tsdsr: Optional[TSDSRInference] = None, device="cuda"):
        self.tsdsr = tsdsr or TSDSRInference(device=device)

    def __call__(self, sr_img: torch.Tensor, use_tsdsr: bool = True) -> torch.Tensor:
        if use_tsdsr and self.tsdsr.available:
            return self.tsdsr.refine(sr_img)
        return sr_img
