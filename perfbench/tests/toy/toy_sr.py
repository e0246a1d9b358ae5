"""A toy x4 super-resolution model, served by no cell: a 3x3 convolution to ``width``
features, GELU, a 3x3 convolution to 3 s^2 channels and a pixel shuffle, over the nearest
upsampled input. The tests serve it through the harness with ``models.load`` pointed here,
to show that a model comes in as files of its own; everything a model file gives
(``perfbench/models/__init__.py``) is here. Its program is plain PyTorch served behind the
program's ``InferencePipeline``; it launches no hand-written kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.ops import conv, gelu

UNSERVED = ()
NUMBERS = {"features": "rel_max"}
TINY = {"width": 8}
BOUNDS = {}


class _Toy(nn.Module):
    def __init__(self, upscale: int, width: int):
        super().__init__()
        self.upscale = upscale
        self.body = nn.Conv2d(3, width, 3, padding=1)
        self.tail = nn.Conv2d(width, 3 * upscale ** 2, 3, padding=1)


class Program(_Toy):
    """NHWC in and out, as the pipeline serves a model."""

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        y = F.pixel_shuffle(self.tail(F.gelu(self.body(x))), self.upscale)
        return (y + F.interpolate(x, scale_factor=self.upscale, mode="nearest")).permute(0, 2, 3, 1)


class Reference(_Toy):
    """NCHW in; {"features": the first convolution's, "sr": the output}."""

    def forward(self, x):
        features = conv(x, self.body)
        y = F.pixel_shuffle(conv(gelu(features), self.tail), self.upscale)
        return {"features": features,
                "sr": y + F.interpolate(x, scale_factor=self.upscale, mode="nearest")}


def build(cfg: dict, device):
    torch.manual_seed(0)
    with torch.device(device):
        return Program(cfg["upscale"], cfg["width"])


def reference(cfg: dict):
    return Reference(cfg["upscale"], cfg["width"])


def taps(model):
    return [(model.body, lambda args, out: {"features": out})]


def timed(model):
    return {"body": model.body}


def launches(cfg: dict, b: int, h: int, w: int):
    return []
