"""CLIP's image tower (ViT-B/32 by default) and the prompt-similarity quality loss. Twin of
``freqfusion_tpu/losses/clip.py``.

The loss scores the prediction against the reference's positive and negative prompt lists
and penalises quality under a threshold. As in the reference, CLIP encodes the image
without gradient: the loss is a penalty with no gradient through CLIP (the JAX package's
``stop_gradient``). CLIP's MLP activation is QuickGELU, x * sigmoid(1.702 x).

Weights: `weights_path` or ``FREQFUSION_CLIP_WEIGHTS`` names an OpenAI CLIP state dict.
The prompt features come from the checkpoint's ``positive_features`` /
``negative_features`` buffers where it holds them (a vision-only checkpoint), else from the
prompts embedded through the checkpoint's own text tower with the BPE vocabulary of
`bpe_path` or ``FREQFUSION_CLIP_BPE`` (``utils/clipiqa.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..infer.io import pinned_precision
from ..models.layers import TorchMHA
from ..ops.resize import resize
from ..utils.convert import load_torch_checkpoint, load_tower_state

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# The reference's SR-tuned prompt lists
POSITIVE_PROMPTS = (
    "a high quality detailed sharp photograph",
    "a professional clear image with fine details",
    "a sharp high resolution photo with crisp edges",
    "a perfectly focused detailed photograph",
    "an ultra high definition clear image",
)
NEGATIVE_PROMPTS = (
    "a blurry low quality noisy image",
    "an unclear distorted photograph",
    "a low resolution blurry picture",
    "a pixelated degraded image",
    "an out of focus fuzzy photo",
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """CLIP's pre-norm block: ln_1 -> attn (packed in_proj) -> ln_2 -> mlp (QuickGELU)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = TorchMHA(width, heads, dropout=0.0)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), attn_mask=attn_mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """``resblocks``: the key level of OpenAI's ``transformer.resblocks.{i}``."""

    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads)
                                       for _ in range(layers))

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, attn_mask)
        return x


class CLIPVisionTransformer(nn.Module):
    """OpenAI CLIP's visual tower, keys as under ``visual.`` (ViT-B/32 defaults).
    ``forward(x [B,S,S,3] normalised)`` -> [B, output_dim] unnormalised embeddings; the
    positional table fixes S = patch * sqrt(tokens - 1) (224 for ViT-B/32)."""

    def __init__(self, patch: int = 32, width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, image_size: int = 224):
        super().__init__()
        n = (image_size // patch) ** 2
        self.conv1 = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(0.02 * torch.randn(width))
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(n + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(0.02 * torch.randn(width, output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)   # [B, N, width]
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding)
        x = self.ln_post(self.transformer(x)[:, 0])
        return x @ self.proj


def _normalize_rows(f: torch.Tensor) -> torch.Tensor:
    return f / f.norm(dim=-1, keepdim=True)


def clip_input(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,3] in [0, 1] -> CLIP's normalised 224 x 224 input: bicubic resize (A = -0.75,
    no antialias), clamp, per-channel normalisation."""
    x = resize(x, 224, 224, "bicubic").clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class CLIPPerceptualLoss(nn.Module):
    """Prompt-similarity quality penalty (threshold 0.5). ``forward(pred, target=None)``:
    the mean over the batch of relu(threshold - quality + 0.1), quality = (mean cosine to
    the positive prompts - mean cosine to the negative ones + 1) / 2. The module follows
    `pred` to its device on the first call and pins f32 products around its forward.

    Weights: `model` with `pos_features` / `neg_features`, else `weights_path`, else
    ``FREQFUSION_CLIP_WEIGHTS``; without them the constructor raises."""

    def __init__(self, quality_threshold: float = 0.5,
                 model: Optional[CLIPVisionTransformer] = None, pos_features=None,
                 neg_features=None, weights_path: Optional[str] = None,
                 bpe_path: Optional[str] = None, positive_prompts=POSITIVE_PROMPTS,
                 negative_prompts=NEGATIVE_PROMPTS):
        super().__init__()
        self.quality_threshold = float(quality_threshold)
        weights_path = weights_path or os.environ.get("FREQFUSION_CLIP_WEIGHTS")
        if model is None and weights_path and os.path.exists(weights_path):
            model, pos_features, neg_features = load_clip_params(
                weights_path, bpe_path=bpe_path, positive_prompts=positive_prompts,
                negative_prompts=negative_prompts)
        if model is None or pos_features is None or neg_features is None:
            raise RuntimeError(
                "CLIP pretrained weights unavailable (set FREQFUSION_CLIP_WEIGHTS: a stock "
                "OpenAI CLIP state dict, with FREQFUSION_CLIP_BPE to embed the prompts, or "
                "one holding positive_features / negative_features; or pass the model and "
                "prompt features); CombinedLoss redirects the clip weight to the FFT loss")
        self.model = model.eval().requires_grad_(False)
        self.register_buffer("pos", _normalize_rows(torch.as_tensor(pos_features).float()))
        self.register_buffer("neg", _normalize_rows(torch.as_tensor(neg_features).float()))

    def forward(self, pred: torch.Tensor, target: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        self.to(pred.device)
        with torch.no_grad(), pinned_precision("highest"):
            feats = _normalize_rows(self.model(clip_input(pred)).to(self.pos.dtype))
        pos_sim = (feats @ self.pos.T).mean(dim=1)
        neg_sim = (feats @ self.neg.T).mean(dim=1)
        quality = (pos_sim - neg_sim + 1.0) / 2.0
        return F.relu(self.quality_threshold - quality + 0.1).mean()


def load_clip_params(weights_path: str, bpe_path: Optional[str] = None,
                     positive_prompts=POSITIVE_PROMPTS, negative_prompts=NEGATIVE_PROMPTS
                     ) -> Tuple[CLIPVisionTransformer, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """An OpenAI CLIP state dict -> (the loaded vision tower, positive features, negative
    features). The prompt features are the checkpoint's ``positive_features`` /
    ``negative_features`` buffers where it holds both; otherwise, where it holds the text
    tower and a BPE vocabulary is reachable, the prompts embedded through that tower (the
    reference's init-time ``clip.tokenize`` + ``encode_text``); else None. The tower's
    size is read from the checkpoint's own shapes."""
    from ..utils.clipiqa import infer_clip_config   # clipiqa imports this module

    sd = load_torch_checkpoint(weights_path)
    vision, text = infer_clip_config(sd)
    load_tower_state(vision, sd, prefix="visual.")
    pos, neg = sd.get("positive_features"), sd.get("negative_features")
    if pos is None or neg is None:
        bpe_path = bpe_path or os.environ.get("FREQFUSION_CLIP_BPE")
        if text is not None and bpe_path and os.path.exists(bpe_path):
            pos, neg = _embed_prompts(sd, text, bpe_path, positive_prompts, negative_prompts)
    return vision.eval(), pos, neg


def _embed_prompts(sd, text, bpe_path: str, positive_prompts, negative_prompts):
    """The prompt lists embedded through the checkpoint's own text tower, on the CPU."""
    from ..utils.clipiqa import SimpleBPETokenizer

    load_tower_state(text, sd).eval()
    ids = torch.from_numpy(SimpleBPETokenizer(bpe_path).tokenize(
        list(positive_prompts) + list(negative_prompts), text.context)).long()
    with torch.no_grad():
        feats = text(ids)
    return feats[: len(positive_prompts)], feats[len(positive_prompts):]
