"""NAFNet-64 expert on NHWC tensors. Twin of ``freqfusion_tpu/models/nafnet.py``.

Bicubic x4 pre-upsample, then the NAFNet UNet (SIDD width-64 config: width 64, encoder
blocks [2,2,4,8], 12 middle blocks, decoder blocks [2,2,2,2]), then a clamp to [0,1].
Module names follow the reference's state-dict keys (``intro``, ``encoders.i.j``,
``downs.i``, ``middle_blks.j``, ``ups.i.0``, ``decoders.i.j``, ``ending``, ``...sca.1``),
so ``NAFNet.state_dict()`` has the keys of a reference checkpoint and parameters keep
the reference's shapes (OIHW convs, beta/gamma [1,C,1,1]).

Blocks up to 256 channels run the fused NAFBlock (kernels B1/B2) and the HR intro/ending
convs run kernel B3 where the JAX package runs its Pallas kernels; the 512/1024-wide
levels, the 2x2 downs and the 1x1 ups stay plain torch, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.common import pad_to_multiple, pixel_shuffle
from ..ops.kernels.nafblock import fused_naf_block, fused_naf_block_plain
from ..ops.resize import upsample
from .layers import SeamConv

#: Widest block that runs the fused kernels (nafnet.py in the JAX package gates its
#: Pallas kernels the same way).
MAX_FUSED_WIDTH = 256


class LayerNorm2d(nn.Module):
    """The reference's LayerNorm2d (biased variance, eps 1e-6): parameters only, applied
    on the channel axis of NHWC tensors by the fused NAFBlock."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class NAFBlock(nn.Module):
    """dw-conv + SimpleGate + simplified channel attention + gated FFN, with per-channel
    residual scales beta/gamma (init 0, so a fresh block is the identity).

    ``kernels = False`` runs the plain versions on any device, to compare the two."""

    def __init__(self, c: int):
        super().__init__()
        dw = 2 * c
        self.c = c
        self.norm1 = LayerNorm2d(c)
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        # Sequential(pool, conv) only for the reference key `sca.1`; the pooled product
        # runs inside fused_naf_block
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c, 1))
        self.conv3 = nn.Conv2d(c, c, 1)
        self.norm2 = LayerNorm2d(c)
        self.conv4 = nn.Conv2d(c, dw, 1)
        self.conv5 = nn.Conv2d(c, c, 1)
        self.beta = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.gamma = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.kernels = True

    def fused_params(self) -> dict:
        """The parameters in the layouts of ops/kernels/nafblock.py. The 1x1 convs' weights
        are views (OI11 -> [I, O]): the kernels keep their split planes on the weights."""
        c = self.c

        def mat(conv):  # 1x1 conv OI11 -> [I, O], a view of the weight
            return conv.weight.reshape(-1, c).t()

        return dict(
            ln1_w=self.norm1.weight, ln1_b=self.norm1.bias,
            w1=mat(self.conv1), b1=self.conv1.bias,
            wdw=self.conv2.weight.reshape(2 * c, 9).t().contiguous(), bdw=self.conv2.bias,
            sca_w=mat(self.sca[1]), sca_b=self.sca[1].bias,
            w3=mat(self.conv3), b3=self.conv3.bias, beta=self.beta.reshape(c),
            ln2_w=self.norm2.weight, ln2_b=self.norm2.bias,
            w4=mat(self.conv4), b4=self.conv4.bias,
            w5=mat(self.conv5), b5=self.conv5.bias, gamma=self.gamma.reshape(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernels and self.c <= MAX_FUSED_WIDTH:
            return fused_naf_block(x, self.fused_params())
        return fused_naf_block_plain(x, self.fused_params())


class NAFStage(nn.Sequential):
    """NAFBlocks at one width; a Sequential, so block j has the key prefix `j.`."""

    def __init__(self, c: int, num_blocks: int):
        super().__init__(*[NAFBlock(c) for _ in range(num_blocks)])


class NAFNet(nn.Module):
    """NAFNet UNet. Input NHWC with H, W multiples of 2**len(enc_blk_nums)."""

    def __init__(self, width: int = 64, middle_blk_num: int = 12,
                 enc_blk_nums: Sequence[int] = (2, 2, 4, 8),
                 dec_blk_nums: Sequence[int] = (2, 2, 2, 2), img_channel: int = 3):
        super().__init__()
        self.intro = SeamConv(img_channel, width)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(NAFStage(chan, num))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, stride=2))
            chan *= 2
        self.middle_blks = NAFStage(chan, middle_blk_num)
        self.ups = nn.ModuleList()
        self.decoders = nn.ModuleList()
        for num in dec_blk_nums:
            # ModuleList for the reference key `ups.i.0` (Sequential(conv, PixelShuffle));
            # the shuffle is ops.common.pixel_shuffle on NHWC
            self.ups.append(nn.ModuleList([nn.Conv2d(chan, 2 * chan, 1, bias=False)]))
            chan //= 2
            self.decoders.append(NAFStage(chan, num))
        self.ending = SeamConv(width, img_channel)

    def forward(self, inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (output, features entering the `ending` conv [B,H,W,width])."""
        x = self.intro(inp)
        encs = []
        for enc, down in zip(self.encoders, self.downs):
            x = enc(x)
            encs.append(x)
            x = down(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()
        x = self.middle_blks(x)
        for up, dec, skip in zip(self.ups, self.decoders, reversed(encs)):
            w = up[0].weight
            x = pixel_shuffle(x @ w.reshape(w.shape[0], -1).t(), 2) + skip
            x = dec(x)
        feats = x
        return self.ending(x) + inp, feats


class NAFNetSR(nn.Module):
    """Bicubic x`upscale` pre-upsample + NAFNet refinement (the reference's NAFNetSR).

    ``forward(lr [B,H,W,3])`` -> (sr [B,4H,4W,3] clamped to [0,1], feats [B,4H,4W,width]).
    The upsampled image is zero-padded to the UNet's multiple and the outputs cropped."""

    def __init__(self, upscale: int = 4, width: int = 64, middle_blk_num: int = 12,
                 enc_blk_nums: Sequence[int] = (2, 2, 4, 8),
                 dec_blk_nums: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.upscale = upscale
        self.mult = 2 ** len(enc_blk_nums)
        self.nafnet = NAFNet(width, middle_blk_num, enc_blk_nums, dec_blk_nums)

    def unet_input(self, lr: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """The UNet's input for `lr` and the HR size to crop back to."""
        return pad_to_multiple(upsample(lr, self.upscale, "bicubic"), self.mult, "zero")

    def forward(self, lr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x_in, (h, w) = self.unet_input(lr)
        out, feats = self.nafnet(x_in)
        return out[:, :h, :w].clamp(0.0, 1.0), feats[:, :h, :w]
