"""NAFNet (Chen et al., ECCV 2022; megvii-research/NAFNet) behind a bicubic x4 pre-upsample,
in plain PyTorch: the UNet of NAFBlocks (LayerNorm2d, 1x1 -> depthwise 3x3 -> SimpleGate ->
simplified channel attention -> 1x1, then the gated FFN, with the residual scales beta and
gamma), 2x2 strided downs and 1x1 + PixelShuffle ups, the output added to the upsampled
input, cropped and clamped to [0, 1]. Parameter names are the published state-dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .hat import SeamConv
from .ops import conv, resize


class LayerNorm2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):   # NCHW, over channels, biased variance, eps 1e-6
        mu = x.mean(1, keepdim=True)
        var = (x - mu).pow(2).mean(1, keepdim=True)
        y = (x - mu) / (var + 1e-6).sqrt()
        return self.weight.view(1, -1, 1, 1) * y + self.bias.view(1, -1, 1, 1)


def simple_gate(x):
    a, b = x.chunk(2, dim=1)
    return a * b


class NAFBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        dw = 2 * c
        self.norm1 = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c, 1))
        self.conv3 = nn.Conv2d(c, c, 1)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, dw, 1)
        self.conv5 = nn.Conv2d(c, c, 1)
        self.beta = nn.Parameter(torch.empty(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.empty(1, c, 1, 1))

    def forward(self, inp):
        x = simple_gate(conv(conv(self.norm1(inp), self.conv1), self.conv2))
        x = x * conv(x.mean(dim=(2, 3), keepdim=True), self.sca[1])
        y = inp + conv(x, self.conv3) * self.beta
        x = conv(simple_gate(conv(self.norm2(y), self.conv4)), self.conv5)
        return y + x * self.gamma


class NAFNet(nn.Module):
    def __init__(self, width=64, middle_blk_num=12, enc_blk_nums=(2, 2, 4, 8),
                 dec_blk_nums=(2, 2, 2, 2), img_channel=3):
        super().__init__()
        self.intro = SeamConv(img_channel, width)
        self.encoders, self.downs = nn.ModuleList(), nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, stride=2))
            chan *= 2
        self.middle_blks = nn.Sequential(*[NAFBlock(chan) for _ in range(middle_blk_num)])
        self.ups, self.decoders = nn.ModuleList(), nn.ModuleList()
        for num in dec_blk_nums:
            self.ups.append(nn.Sequential(nn.Conv2d(chan, 2 * chan, 1, bias=False),
                                          nn.PixelShuffle(2)))
            chan //= 2
            self.decoders.append(nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))
        self.ending = SeamConv(width, img_channel)
        self.padder_size = 2 ** len(enc_blk_nums)

    def forward(self, inp):
        _, _, h, w = inp.shape
        ph, pw = (-h) % self.padder_size, (-w) % self.padder_size
        inp = F.pad(inp, (0, pw, 0, ph))
        x = self.intro(inp)
        encs = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x)
            encs.append(x)
            x = conv(x, down)
        x = self.middle_blks(x)
        for up, dec, skip in zip(self.ups, self.decoders, encs[::-1]):
            x = F.pixel_shuffle(conv(x, up[0]), 2) + skip
            x = dec(x)
        return (self.ending(x) + inp)[:, :, :h, :w]


class NAFNetSR(nn.Module):
    """``forward(x [B, 3, H, W])`` -> SR [B, 3, 4H, 4W] in [0, 1]."""

    def __init__(self, upscale=4, **kw):
        super().__init__()
        self.upscale = upscale
        self.nafnet = NAFNet(**kw)

    def forward(self, x):
        _, _, h, w = x.shape
        up = resize(x, h * self.upscale, w * self.upscale, "bicubic")
        return self.nafnet(up).clamp(0.0, 1.0)
