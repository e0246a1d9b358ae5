"""CLIP-IQA: the antonym-prompt CLIP quality score, with CLIP's text tower and byte-pair
tokenizer. Twin of ``freqfusion_tpu/utils/clipiqa.py``.

CLIP-IQA (Wang et al. 2023) scores an image by the softmax over its CLIP similarities to a
prompt pair ("Good photo." against "Bad photo."), scaled by the checkpoint's learned logit
scale. The image tower is ``losses/clip.py``'s ViT, on a bicubic resize to 224 x 224.

- ``FREQFUSION_CLIPIQA_WEIGHTS`` names an OpenAI CLIP state dict (``visual.*`` plus the
  text side: ``token_embedding``, ``positional_embedding``, ``transformer.*``,
  ``ln_final``, ``text_projection``, ``logit_scale``);
- ``FREQFUSION_CLIP_BPE`` names ``bpe_simple_vocab_16e6.txt.gz`` (or the plain text).

Tokenizer: CLIP's byte-level BPE. CLIP writes its split pattern for the ``regex`` package
(``\\p{L}``, ``\\p{N}``); here it is written for ``re``, with the letter and number classes
spelled out as code-point ranges from ``unicodedata`` (every category L* and N*). The two
agree wherever Python's ``unicodedata`` and the ``regex`` package were built on the same
Unicode version; they can differ only on code points assigned in one version and not the
other. ftfy's mojibake repair is skipped, as in the JAX package.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..infer.io import pinned_precision
from ..infer.tiling import require_device
from ..losses.clip import (CLIPVisionTransformer, Transformer, _normalize_rows, clip_input)
from .convert import load_torch_checkpoint, load_tower_state

DEFAULT_PROMPTS = ("Good photo.", "Bad photo.")


# ---------------------------------------------------------------------------
# byte-pair tokenizer (CLIP's SimpleTokenizer recipe)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode():
    """The reversible byte <-> printable-unicode map of GPT-2 and CLIP: printable ASCII and
    Latin-1 bytes map to themselves, the rest to code points from 256 up, so that the BPE
    merges act on visible characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


@lru_cache()
def _category_class(major: str) -> str:
    """The code points whose Unicode general category starts with `major` ("L": letters,
    "N": numbers), as the body of an ``re`` character class."""
    parts, start = [], None
    for cp in range(sys.maxunicode + 1):
        hit = unicodedata.category(chr(cp))[0] == major
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            parts.append(f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    if start is not None:
        parts.append(f"\\U{start:08x}-\\U{sys.maxunicode:08x}")
    return "".join(parts)


@lru_cache()
def split_pattern() -> "re.Pattern":
    """CLIP's pre-tokenizer split, ``regex``'s ``\\p{L}`` and ``\\p{N}`` spelled out."""
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        rf"""|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+""", re.IGNORECASE)


class SimpleBPETokenizer:
    """CLIP's byte-level BPE. `bpe_path` is the official ``bpe_simple_vocab_16e6.txt.gz``
    (gzip or plain text; the first line is a version comment). Vocabulary: 256 byte
    symbols + their 256 ``</w>`` variants + one token per merge + the two specials (49408
    for the official file)."""

    MAX_MERGES = 49152 - 256 - 2   # the official vocabulary's budget

    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and (lines[0].startswith("#") or " " not in lines[0]):
            lines = lines[1:]
        merges = [tuple(line.split()) for line in lines if line.strip()]
        merges = [m for m in merges if len(m) == 2][: self.MAX_MERGES]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)
        self._cache = {}
        self._pat = split_pattern()

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        ids: List[int] = []
        for tok in self._pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def tokenize(self, texts: Sequence[str], context: int = 77) -> np.ndarray:
        """[len(texts), context] int32: SOT + ids + EOT, zero-padded."""
        out = np.zeros((len(texts), context), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: context - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# text transformer
# ---------------------------------------------------------------------------

class CLIPTextTransformer(nn.Module):
    """OpenAI CLIP's text tower, with its top-level keys (``token_embedding``,
    ``positional_embedding``, ``transformer.resblocks.*``, ``ln_final``,
    ``text_projection``). ``forward(ids [B, context] int64)`` -> [B, output_dim]
    unnormalised embeddings: token + positional embedding, causally masked blocks,
    ln_final, the features at the EOT position (the argmax of the ids: EOT has the highest
    id), projected by ``text_projection``."""

    def __init__(self, vocab_size: int = 49408, width: int = 512, heads: int = 8,
                 layers: int = 12, context: int = 77, output_dim: int = 512):
        super().__init__()
        self.context = context
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(context, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(0.02 * torch.randn(width, output_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(ids) + self.positional_embedding
        n = self.context
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        x = self.ln_final(self.transformer(x, causal))
        x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return x @ self.text_projection


def infer_clip_config(sd) -> Tuple[CLIPVisionTransformer, Optional[CLIPTextTransformer]]:
    """The towers built from the state dict's own shapes, as OpenAI's ``build_model``: any
    ViT CLIP size (and the small checkpoints of the tests). Heads follow CLIP's width // 64
    rule, floored at 1. A vision-only checkpoint gives no text tower (None)."""
    vw, _, patch, _ = sd["visual.conv1.weight"].shape
    v_layers = len({k.split(".")[3] for k in sd
                    if k.startswith("visual.transformer.resblocks.")})
    side = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vision = CLIPVisionTransformer(patch=patch, width=vw, layers=v_layers,
                                   heads=max(1, vw // 64),
                                   output_dim=sd["visual.proj"].shape[1],
                                   image_size=side * patch)
    if "token_embedding.weight" not in sd:
        return vision, None
    vocab, tw = sd["token_embedding.weight"].shape
    t_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")})
    text = CLIPTextTransformer(vocab_size=vocab, width=tw, heads=max(1, tw // 64),
                               layers=t_layers, context=sd["positional_embedding"].shape[0],
                               output_dim=sd["text_projection"].shape[1])
    return vision, text


def load_clip_full(weights_path: str):
    """An OpenAI CLIP state dict -> (loaded vision tower, loaded text tower, logit scale
    exp(logit_scale), 1 / 0.07 where the checkpoint has none)."""
    sd = load_torch_checkpoint(weights_path)
    vision, text = infer_clip_config(sd)
    if text is None:
        raise RuntimeError("CLIP checkpoint has no text tower (vision-only state dict): the "
                           "clipiqa metric needs encode_text")
    load_tower_state(vision, sd, prefix="visual.")
    load_tower_state(text, sd)
    scale = float(np.exp(np.asarray(sd.get("logit_scale", np.log(1.0 / 0.07)))))
    return vision.eval(), text.eval(), scale


class NativeCLIPIQA:
    """CLIP-IQA score on uint8 HWC RGB images (higher is better, in (0, 1)), on `device`
    (the card unless the caller names another; without a card the default raises).

    Weights: `weights_path` or ``FREQFUSION_CLIPIQA_WEIGHTS``, and the vocabulary
    `bpe_path` or ``FREQFUSION_CLIP_BPE``; without both the constructor raises and the
    clipiqa column stays NaN. `dtype` is the one the tower computes in (float64: a
    reference)."""

    def __init__(self, weights_path: Optional[str] = None, bpe_path: Optional[str] = None,
                 prompts: Sequence[str] = DEFAULT_PROMPTS, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.device, self.dtype = require_device(device), dtype
        weights_path = weights_path or os.environ.get("FREQFUSION_CLIPIQA_WEIGHTS")
        bpe_path = bpe_path or os.environ.get("FREQFUSION_CLIP_BPE")
        if not (weights_path and os.path.exists(weights_path)
                and bpe_path and os.path.exists(bpe_path)):
            raise RuntimeError("CLIP-IQA needs FREQFUSION_CLIPIQA_WEIGHTS (OpenAI CLIP state "
                               "dict) and FREQFUSION_CLIP_BPE (BPE vocab)")
        vision, text, self.logit_scale = load_clip_full(weights_path)
        self.vision, self.text = vision.to(self.device, dtype), text.to(self.device, dtype)
        ids = SimpleBPETokenizer(bpe_path).tokenize(list(prompts), text.context)
        with torch.inference_mode(), pinned_precision("highest"):
            self.tfeat = _normalize_rows(
                self.text(torch.from_numpy(ids).long().to(self.device)))

    def __call__(self, output: np.ndarray, target=None) -> float:
        with torch.inference_mode(), pinned_precision("highest"):
            x = torch.from_numpy(np.asarray(output, np.float32)[None]).to(self.device, self.dtype)
            x = x / 255.0
            f = _normalize_rows(self.vision(clip_input(x)))
            logits = self.logit_scale * (f @ self.tfeat.T)        # [1, n_prompts]
            return float(torch.softmax(logits, dim=-1)[0, 0])
