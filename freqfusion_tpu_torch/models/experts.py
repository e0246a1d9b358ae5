"""Expert ensemble and the full live model. Twin of ``freqfusion_tpu/models/experts.py``.

The three experts run one after another on the current stream. Their feature taps are
their second return values:
  hat    [B,H,W,180]    (conv_after_body's output)
  dat    [B,H,W,180]    (conv_after_body's output)
  nafnet [B,4H,4W,64]   (the ending conv's input, at HR resolution)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.resize import resize
from ..utils import profiling
from .dat import DAT
from .fusion import FusionConfig, FusionHead
from .hat import HAT
from .nafnet import NAFNetSR


class ExpertEnsemble(nn.Module):
    """Runs HAT-L, DAT and NAFNet-64 on an LR batch whose H and W are multiples of the
    HAT window and of DAT's split sizes (the serving buckets are)."""

    def __init__(self, upscale: int = 4, hat_kwargs: Optional[dict] = None,
                 dat_kwargs: Optional[dict] = None, nafnet_kwargs: Optional[dict] = None):
        super().__init__()
        self.hat = HAT(upscale=upscale, **(hat_kwargs or {}))
        self.dat = DAT(upscale=upscale, **(dat_kwargs or {}))
        self.nafnet = NAFNetSR(upscale=upscale, **(nafnet_kwargs or {}))

    def forward(self, lr: torch.Tensor) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, torch.Tensor]]:
        h, w = lr.shape[1], lr.shape[2]
        with profiling.span("ff.hat"):
            hat_sr, hat_feat = self.hat(lr)
        with profiling.span("ff.dat"):
            dat_sr, dat_feat = self.dat(lr)
        with profiling.span("ff.nafnet"):
            naf_sr, naf_feat = self.nafnet(lr)   # already clamped inside NAFNetSR
        outputs = {"hat": hat_sr.clamp(0.0, 1.0), "dat": dat_sr.clamp(0.0, 1.0),
                   "nafnet": naf_sr}
        # every feature at LR resolution
        features = {"hat": hat_feat, "dat": dat_feat,
                    "nafnet": resize(naf_feat, h, w, "bilinear")}
        return outputs, features


class FreqFusionSR(nn.Module):
    """The complete live model: frozen experts -> fusion head.

    ``forward(lr, with_features=False)`` -> SR [B,4H,4W,3]."""

    def __init__(self, cfg: FusionConfig = FusionConfig(), hat_kwargs: Optional[dict] = None,
                 dat_kwargs: Optional[dict] = None, nafnet_kwargs: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        self.upscale = cfg.upscale
        self.experts = ExpertEnsemble(cfg.upscale, hat_kwargs, dat_kwargs, nafnet_kwargs)
        self.fusion = FusionHead(cfg)

    def forward(self, lr: torch.Tensor, with_features: bool = False) -> torch.Tensor:
        # the experts are frozen: they run without autograd, so no gradient flows back into
        # them, and their kernels (which have no backward) run with grad enabled too
        with torch.no_grad():
            outputs, features = self.experts(lr)
        with profiling.span("ff.head"):
            return self.fusion(lr, outputs, features if with_features else None)
