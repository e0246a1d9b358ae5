"""Exponential moving average of a module's trainable parameters. Twin of
``freqfusion_tpu/training/ema.py``: the shadow covers ``named_parameters()`` that require
grad; buffers (BatchNorm's running statistics) are not averaged. The shadow is a copy."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class EMA:
    def __init__(self, module: nn.Module, decay: float = 0.9995):
        self.decay = decay
        self.shadow: Dict[str, torch.Tensor] = {
            k: p.detach().clone() for k, p in module.named_parameters() if p.requires_grad}
        self._backup: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def update(self, module: nn.Module) -> None:
        """shadow = decay * shadow + (1 - decay) * param."""
        for k, p in module.named_parameters():
            if k in self.shadow:
                self.shadow[k].mul_(self.decay).add_(p.detach(), alpha=1.0 - self.decay)

    @torch.no_grad()
    def apply(self, module: nn.Module) -> None:
        """Swaps the shadow in (for evaluation); ``restore`` swaps the parameters back."""
        self._backup = {}
        for k, p in module.named_parameters():
            if k in self.shadow:
                self._backup[k] = p.detach().clone()
                p.copy_(self.shadow[k])

    @torch.no_grad()
    def restore(self, module: nn.Module) -> None:
        for k, p in module.named_parameters():
            if k in self._backup:
                p.copy_(self._backup[k])
        self._backup = {}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.shadow.items()}

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for k, v in state.items():
            if k in self.shadow:
                self.shadow[k] = torch.as_tensor(v).to(self.shadow[k]).clone()
