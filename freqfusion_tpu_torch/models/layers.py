"""Shared layers. Twin of ``freqfusion_tpu/models/layers.py``."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv3x3 import conv3x3_dense, conv3x3_dense_plain


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as the reference's nn.GELU()."""
    return F.gelu(x)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A library conv on an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


def hwio(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's OIHW weight in the kernels' HWIO layout."""
    return conv.weight.permute(2, 3, 1, 0).contiguous()


def linear_io_view(lin: nn.Linear) -> torch.Tensor:
    """A Linear's [out,in] weight as the [in,out] matrix of x @ w: a view of the weight, for
    the wrappers that lay a weight out once and keep it beside the parameter
    (ops/kernels/_mma.py's ``planes`` and ``fragments``)."""
    return lin.weight.t()


_DROPOUT_GENERATOR: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Inside the block, ``dropout`` draws its masks from `generator` (None: the global
    generator): the train step passes its own, so that a seed fixes the masks."""
    global _DROPOUT_GENERATOR
    before, _DROPOUT_GENERATOR = _DROPOUT_GENERATOR, generator
    try:
        yield
    finally:
        _DROPOUT_GENERATOR = before


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Inverted dropout: in training, each element kept with probability 1 - p and scaled
    by 1 / (1 - p), the mask drawn from the generator of ``dropout_generator``; the
    identity otherwise. The head's three dropouts (p = 0.1) all run through here."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=_DROPOUT_GENERATOR, device=x.device) >= p
    return x * keep / (1.0 - p)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (the reference's state-dict keys, `num_batches_tracked` included). In
    eval mode the port applies it as a fixed per-channel affine of its running statistics
    (the JAX package's ``BatchNormEval``); in training, as the module (batch statistics)."""

    def affine_eval(self):
        """(scale, shift) with eval-mode BN(x) = x * scale + shift."""
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        return scale, self.bias - self.running_mean * scale


class SeamConv(nn.Module):
    """3x3 SAME conv on NHWC tensors, with nn.Conv2d's parameters (weight OIHW, bias).

    On a CUDA tensor it runs kernel B3 (``ops/kernels/conv3x3.py``), on a CPU tensor its
    plain version. Setting ``kernels = False`` runs the plain version on any device, to
    compare the two."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)  # nn.Conv2d's default
        self.kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
        if self.kernels:
            return conv3x3_dense(x, w, self.bias)
        return conv3x3_dense_plain(x, w, self.bias)


def conv1x1_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv on an NHWC tensor as the matrix product it is, over the last axis."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class TorchMHA(nn.Module):
    """Self-attention over the second-to-last axis of [..., N, E] with
    ``nn.MultiheadAttention``'s parameters and keys (packed ``in_proj_weight`` [3E,E],
    ``in_proj_bias``, ``out_proj``). Twin of the JAX package's ``TorchMHA``; dropout acts
    on the attention probabilities in training mode only."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def raw(self):
        """(wqkv [E,3E], bqkv, wproj [E,E], bproj) as ``x @ w`` matrices, for kernel B11: views
        of the parameters, which the kernel's wrapper lays out once for each weight."""
        return (self.in_proj_weight.t(), self.in_proj_bias, linear_io_view(self.out_proj),
                self.out_proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *lead, n, e = x.shape
        h, hd = self.num_heads, e // self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(*lead, n, 3, h, hd).movedim(-3, 0).transpose(-2, -3)
        attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        attn = dropout(attn, self.dropout, self.training)
        return self.out_proj((attn @ v).transpose(-2, -3).reshape(*lead, n, e))


class SEChannelAttention(nn.Module):
    """SE-style channel attention with avg + max pooling; keys ``mlp.0`` / ``mlp.2``."""

    def __init__(self, features: int, reduction: int = 4):
        super().__init__()
        hidden = max(features // reduction, 8)
        self.mlp = nn.Sequential(nn.Conv2d(features, hidden, 1, bias=False), nn.ReLU(),
                                 nn.Conv2d(hidden, features, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(t):
            return conv1x1_nhwc(self.mlp[2], F.relu(conv1x1_nhwc(self.mlp[0], t)))

        avg = mlp(x.mean(dim=(1, 2), keepdim=True))
        mx = mlp(x.amax(dim=(1, 2), keepdim=True))
        return x * torch.sigmoid(avg + mx)


class CBAMSpatialAttention(nn.Module):
    """CBAM spatial attention: [avg | max over C] -> k x k conv -> sigmoid gate."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], -1)
        return x * torch.sigmoid(conv_nhwc(self.conv, pooled))


class ChannelSpatialAttention(nn.Module):
    def __init__(self, features: int, reduction: int = 4, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = SEChannelAttention(features, reduction)
        self.spatial_attention = CBAMSpatialAttention(kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attention(self.channel_attention(x))
