"""Shared layers. Twin of ``freqfusion_tpu/models/layers.py``."""

from __future__ import annotations

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


def linear_io(lin: nn.Linear) -> torch.Tensor:
    """A Linear's [out,in] weight as the [in,out] matrix of x @ w."""
    return lin.weight.t().contiguous()


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (the reference's state-dict keys, `num_batches_tracked` included)
    that the port only ever uses in eval mode, as a fixed per-channel affine of its
    running statistics (the JAX package's ``BatchNormEval``)."""

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
