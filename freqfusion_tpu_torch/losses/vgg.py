"""VGG19 perceptual features and the layer-weighted perceptual loss. Twin of
``freqfusion_tpu/losses/vgg.py``.

Weights: `weights_path` or ``FREQFUSION_VGG19_WEIGHTS`` names a torchvision VGG19 state
dict (``features.N.weight`` keys, or the reference loss module's
``feature_extractor.vgg_layers.N.weight`` keys); without one the loss raises at
construction and ``CombinedLoss`` moves its weight to the FFT loss.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..infer.io import pinned_precision
from ..utils.convert import load_torch_checkpoint, load_tower_state

# torchvision vgg19().features layout: conv indices and their widths
VGG19_CONV_CHANNELS = {0: 64, 2: 64, 5: 128, 7: 128, 10: 256, 12: 256, 14: 256, 16: 256,
                       19: 512, 21: 512, 23: 512, 25: 512, 28: 512, 30: 512, 32: 512, 34: 512}
#: relu layer name -> torchvision features index
LAYER_NAME_MAPPING = {
    "relu1_1": 1, "relu1_2": 3, "relu2_1": 6, "relu2_2": 8,
    "relu3_1": 11, "relu3_2": 13, "relu3_3": 15, "relu3_4": 17,
    "relu4_1": 20, "relu4_2": 22, "relu4_3": 24, "relu4_4": 26,
    "relu5_1": 29, "relu5_2": 31, "relu5_3": 33, "relu5_4": 35,
}
_POOL_INDICES = (4, 9, 18, 27, 36)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DEFAULT_LAYER_WEIGHTS = {"relu1_2": 0.1, "relu2_2": 0.2, "relu3_4": 0.4, "relu4_4": 0.2,
                         "relu5_4": 0.1}


class VGG19Features(nn.Module):
    """VGG19's ``features`` trunk up to the deepest requested relu.
    ``forward(x [B,H,W,3] in [0, 1])`` -> {layer name: [B,C,h,w]}."""

    def __init__(self, feature_layers: Sequence[str] = ("relu2_2", "relu3_4", "relu4_4"),
                 use_input_norm: bool = True):
        super().__init__()
        self.use_input_norm = use_input_norm
        self.want = {LAYER_NAME_MAPPING[name]: name for name in feature_layers}
        layers, cin = [], 3
        for idx in range(max(self.want) + 1):
            if idx in VGG19_CONV_CHANNELS:
                layers.append(nn.Conv2d(cin, VGG19_CONV_CHANNELS[idx], 3, padding=1))
                cin = VGG19_CONV_CHANNELS[idx]
            elif idx in _POOL_INDICES:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        feats = {}
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.want:
                feats[self.want[idx]] = x
        return feats


def load_vgg19(model: VGG19Features, weights_path: str) -> VGG19Features:
    """Loads a torch VGG19 state dict (torchvision ``features.N.*`` or the reference loss
    module's ``feature_extractor.vgg_layers.N.*`` keys) into `model`."""
    pref = "feature_extractor.vgg_layers."
    sd = {(f"features.{k[len(pref):]}" if k.startswith(pref) else k): v
          for k, v in load_torch_checkpoint(weights_path).items()}
    return load_tower_state(model, sd)


class VGGPerceptualLoss(nn.Module):
    """Layer-weighted L1 / L2 distance in VGG19 feature space. ``forward(pred, target)``,
    NHWC: both clamped to [0, 1], the target's features computed without gradient; the
    gradient flows into `pred`. The module follows `pred` to its device on the first call,
    and pins f32 products (TF32 off) around its forward.

    Weights: `model` (a loaded ``VGG19Features``), else `weights_path`, else
    ``FREQFUSION_VGG19_WEIGHTS``; without any the constructor raises."""

    def __init__(self, feature_layers: Optional[List[str]] = None,
                 layer_weights: Optional[Dict[str, float]] = None, criterion: str = "l1",
                 model: Optional[VGG19Features] = None, weights_path: Optional[str] = None):
        super().__init__()
        self.feature_layers = list(feature_layers or ("relu2_2", "relu3_4", "relu4_4"))
        self.layer_weights = dict(layer_weights or DEFAULT_LAYER_WEIGHTS)
        if criterion not in ("l1", "l2"):
            raise ValueError(f"Unknown criterion: {criterion}")
        self.criterion = criterion
        weights_path = weights_path or os.environ.get("FREQFUSION_VGG19_WEIGHTS")
        if model is None and weights_path and os.path.exists(weights_path):
            model = load_vgg19(VGG19Features(tuple(self.feature_layers)), weights_path)
        if model is None:
            raise RuntimeError(
                "VGG19 pretrained weights unavailable (set FREQFUSION_VGG19_WEIGHTS or pass "
                "model/weights_path); CombinedLoss redirects the vgg weight to the FFT loss")
        self.model = model.eval().requires_grad_(False)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        self.model.to(pred.device)
        with pinned_precision("highest"):
            pf = self.model(pred.clamp(0.0, 1.0))
            with torch.no_grad():
                tf = self.model(target.clamp(0.0, 1.0))
        loss, total_w = 0.0, 0.0
        for name in self.feature_layers:
            w = self.layer_weights.get(name, 1.0)
            d = pf[name] - tf[name]
            loss = loss + w * (d.abs().mean() if self.criterion == "l1" else d.square().mean())
            total_w += w
        return loss / total_w
