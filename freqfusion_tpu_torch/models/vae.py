"""The SD AutoencoderKL latent codec. Twin of ``freqfusion_tpu/models/vae.py``.

The VAE that TSD-SR's reference wrapper takes from diffusers (AutoencoderKL of
stable-diffusion-2-1, scale 0.18215, frozen). No weights are in the repository: point
``FREQFUSION_SDVAE_WEIGHTS`` at the diffusers VAE state dict (``.pth``, or
``.safetensors`` where the ``safetensors`` package is installed; keys ``encoder.`` /
``decoder.`` / ``quant_conv`` / ``post_quant_conv``) and ``SDVAECodec`` goes live, which
makes ``TSDSRInference`` (``models/tsdsr.py``) refine instead of passing images through.

Default dims are the SD 2.1 VAE: 4-channel latent, x8 spatial, block channels (128, 256,
512, 512), 2 resnets a block, GroupNorm(32), SiLU, one-head mid-block attention. The
modules carry diffusers' key layout, so its state dict loads directly. The public
functions take NHWC images and latents; inside, the network runs NCHW, the layout of
torch's convolutions and GroupNorm, which at 2048x1344 and 128 channels saves a 1.4 GB
transpose around every conv.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..infer.tiling import require_device
from ..utils import convert as cv

SD_SCALE_FACTOR = 0.18215
WEIGHTS_ENV = "FREQFUSION_SDVAE_WEIGHTS"


class MissingWeights(RuntimeError):
    """No weights were given or named: the caller may run without the codec."""


class _ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _AttnBlock(nn.Module):
    """One-head self-attention over all spatial tokens (diffusers' mid-block
    ``Attention``: group_norm -> to_q/k/v -> to_out.0, residual). The scores are never
    materialised (``F.scaled_dot_product_attention``): at 2048x1344 the latent has 43008
    tokens, whose score matrix would take 7.4 GB."""

    def __init__(self, c: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)            # [B,N,C]
        o = F.scaled_dot_product_attention(self.to_q(t)[:, None], self.to_k(t)[:, None],
                                           self.to_v(t)[:, None])[:, 0]
        return x + self.to_out[0](o).transpose(1, 2).reshape(b, c, h, w)


class _MidBlock(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_ResnetBlock(c, c, groups), _ResnetBlock(c, c, groups)])
        self.attentions = nn.ModuleList([_AttnBlock(c, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride, padding=0 if stride == 2 else 1)


class _Level(nn.Module):
    """One down or up block: resnets, then its down- or upsampler where it has one."""

    def __init__(self, cin: int, cout: int, n: int, groups: int, sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList(_ResnetBlock(cin if j == 0 else cout, cout, groups)
                                     for j in range(n))
        if sampler == "down":
            self.downsamplers = nn.ModuleList([_Sampler(cout, 2)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([_Sampler(cout, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            # diffusers Downsample2D: pad (0,1,0,1), then a stride-2 VALID conv
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        if hasattr(self, "upsamplers"):
            # diffusers Upsample2D: nearest x2, then a SAME conv
            x = self.upsamplers[0].conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class VAEEncoder(nn.Module):
    """NCHW image in [-1, 1] -> [B, 2 * latent, H/8, W/8] (mean | logvar)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _Level(ch[max(i - 1, 0)], c, layers_per_block, groups,
                   "down" if i < len(ch) - 1 else None) for i, c in enumerate(ch))
        self.mid_block = _MidBlock(ch[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    """NCHW latent -> NCHW image in about [-1, 1]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, out_channels: int = 3, latent_channels: int = 4,
                 groups: int = 32):
        super().__init__()
        ch = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block = _MidBlock(ch[0], groups)
        self.up_blocks = nn.ModuleList(
            _Level(ch[max(i - 1, 0)], c, layers_per_block + 1, groups,
                   "up" if i < len(ch) - 1 else None) for i, c in enumerate(ch))
        self.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """``encode(x)`` -> (mean, logvar); ``decode(z)`` -> image; NHWC in and out."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32):
        super().__init__()
        self.encoder = VAEEncoder(block_out_channels, layers_per_block, latent_channels, groups)
        self.decoder = VAEDecoder(block_out_channels, layers_per_block, 3, latent_channels,
                                  groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic round trip through the posterior's mode."""
        return self.decode(self.encode(x)[0])


def vae_key(path: Tuple[str, ...]) -> str:
    """JAX VAE param path -> diffusers AutoencoderKL key (own copy of the JAX package's
    ``vae_key_fn``): ('encoder','down_0_res_1','conv1','kernel') ->
    'encoder.down_blocks.0.resnets.1.conv1.weight'."""
    parts = [p for p in path if p != "params"]
    leaf = {"kernel": "weight", "bias": "bias", "scale": "weight"}[parts[-1]]
    mod = parts[0]
    if mod in ("quant_conv", "post_quant_conv"):
        return f"{mod}.{leaf}"
    if mod in ("encoder", "decoder"):
        return f"{mod}.{_local(parts[1], parts[2:-1])}.{leaf}"
    raise KeyError("/".join(parts))


def _local(name: str, rest) -> str:
    inner = rest[0] if rest else ""
    if name in ("conv_in", "conv_norm_out", "conv_out"):
        return name
    if name == "mid_attn":
        return "mid_block.attentions.0." + ("to_out.0" if inner == "to_out" else inner)
    if name.startswith("mid_res_"):
        return f"mid_block.resnets.{name.split('_')[-1]}.{inner}"
    if name.startswith("down_") and name.endswith("_ds"):
        return f"down_blocks.{name.split('_')[1]}.downsamplers.0.conv"
    if name.startswith("up_") and name.endswith("_us"):
        return f"up_blocks.{name.split('_')[1]}.upsamplers.0.conv"
    if "_res_" in name:
        kind, i, _, j = name.split("_")
        return f"{'down_blocks' if kind == 'down' else 'up_blocks'}.{i}.resnets.{j}.{inner}"
    raise KeyError(name)


def vae_params_from_flax(params: Mapping, model: AutoencoderKL):
    """The JAX ``AutoencoderKL`` params -> a state dict for the port's `model`."""
    return cv.tower_params_from_flax(params, vae_key, {k: tuple(v.shape) for k, v in
                                                       model.state_dict().items()})


def read_state_dict(path: str) -> dict:
    """{key: CPU tensor} from a ``.safetensors`` file (through the ``safetensors``
    package, imported here and only here: it is optional) or a torch checkpoint."""
    if str(path).endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(f"{path}: reading .safetensors needs the safetensors package, "
                               "which is not installed; convert it to a torch .pth") from e
        return load_file(str(path))
    return cv.load_torch_checkpoint(str(path))


def load_vae_params(model: AutoencoderKL, weights_path: str) -> AutoencoderKL:
    """Loads a diffusers AutoencoderKL state dict (``.safetensors`` or torch ``.pth``)
    into `model`, strictly (a missing key or a tensor of another size raises)."""
    return cv.load_tower_state(model, read_state_dict(weights_path))


class SDVAECodec:
    """The latent codec that TSDSRInference consumes: [0,1] NHWC image <-> scaled latent
    (scale 0.18215), on `device` (the card unless the caller names another).

    Weights: an explicit state dict `params`, else `weights_path`, else the
    FREQFUSION_SDVAE_WEIGHTS variable, loaded into `model` (the SD 2.1 AutoencoderKL by
    default). Without any the constructor raises, and TSD-SR stays an identity passthrough
    (the reference's own behaviour without weights)."""

    def __init__(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None, model: Optional[AutoencoderKL] = None,
                 scale_factor: float = SD_SCALE_FACTOR, device="cuda"):
        self.device = require_device(device)
        self.scale_factor = scale_factor
        weights_path = weights_path or os.environ.get(WEIGHTS_ENV)
        if params is None and weights_path and os.path.exists(weights_path):
            params = read_state_dict(weights_path)
        if params is None:
            raise MissingWeights(
                f"SD VAE weights unavailable (set {WEIGHTS_ENV} or pass params / weights_path);"
                " TSD-SR refinement stays an identity passthrough")
        self.model = cv.load_tower_state(model or AutoencoderKL(), params).to(self.device).eval()

    @torch.no_grad()
    def encode(self, img: torch.Tensor, generator: Optional[torch.Generator] = None):
        """[B,H,W,3] in [0,1] -> scaled latent [B,H/8,W/8,4]: the posterior's mean, or a
        sample from `generator` where one is given (the reference samples)."""
        mean, logvar = self.model.encode(img * 2.0 - 1.0)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=generator.device)
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean)
        return mean * self.scale_factor

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latent -> [B,H,W,3] in [0,1]."""
        x = self.model.decode(z / self.scale_factor)
        return ((x + 1.0) * 0.5).clamp(0.0, 1.0)
