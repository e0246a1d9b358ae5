"""Model FLOPs of one served forward, counted by ``torch.utils.flop_counter.FlopCounterMode``
on the plain reference at the served shape, on the meta device (shapes only, no memory, no
chip). The count is a property of the configuration and the shape, never of the program."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import models


@functools.lru_cache(maxsize=None)
def forward_flops(cfg_json: str, b: int, h: int, w: int) -> int:
    """FLOPs of a forward of the configuration (JSON, naming its ``"model"``) on [b, 3, h, w]."""
    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        ref = models.load(cfg["model"]).reference(cfg).eval()
        x = torch.empty(b, 3, h, w)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        ref(x)
    return counter.get_total_flops()
