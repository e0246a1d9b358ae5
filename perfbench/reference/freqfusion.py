"""The plain FreqFusionSR: the three experts and the fusion head, built from a configuration
file's sizes (``perfbench/models/freqfusion_sr.py`` names it to the harness)."""

from __future__ import annotations

from torch import nn

from . import dat, hat, head, nafnet

#: state-dict entries the served forward never reads: the collaborative module runs only
#: when expert features are supplied, and the flat-router weights only with the
#: hierarchical fusion off
UNSERVED = ("fusion.collaborative.", "fusion.expert_weights", "fusion.band_importance")


class Experts(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        up = model_cfg["upscale"]
        self.hat = hat.HAT(upscale=up, **model_cfg["hat"])
        self.dat = dat.DAT(upscale=up, **model_cfg["dat"])
        self.nafnet = nafnet.NAFNetSR(upscale=up, **model_cfg["nafnet"])


class FreqFusionRef(nn.Module):
    """``forward(lr [B, 3, h, w])`` -> dict of NCHW tensors: each expert's output (clamped to
    [0, 1]), the head's guidance bands (LR), its fused image before the refinement and clamp
    (``fused``) and the served output (``sr``)."""

    def __init__(self, model_cfg):
        super().__init__()
        self.upscale = model_cfg["upscale"]
        self.experts = Experts(model_cfg)
        self.fusion = head.FusionHead(upscale=self.upscale, **model_cfg["head"])

    def forward(self, lr):
        e = self.experts
        outs = {"hat": e.hat(lr).clamp(0.0, 1.0), "dat": e.dat(lr).clamp(0.0, 1.0),
                "nafnet": e.nafnet(lr)}
        return {**outs, **self.fusion(lr, outs)}
