"""LR/HR pair datasets (numpy on the host). Twin of ``freqfusion_tpu/data/dataset.py``:
directory-layout detection (5 DF2K/DIV2K patterns), stem-based pair matching with LR-suffix
stripping, a repeat factor, an optional in-RAM cache, the patch-sampling training dataset
and the full-image validation dataset (LR clamped to a size, resized by the port's
``ops/resize.py``: torch bicubic, antialias off, as the JAX resize). Images load through
``utils/imageio.py`` (PIL, RGB float32 in [0,1]).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..ops.resize import resize
from ..utils.imageio import load_image
from .augment import TrainAugmentation

_LR_SUFFIXES_SCALE = ("x4", "x2", "x3", "x8")
_LR_SUFFIXES_NAME = ("_LR", "_lr", "LR", "lr", "_bicubic", "_BICUBIC")
_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def list_image_paths(directory) -> List[Path]:
    d = Path(directory)
    return sorted(p for p in d.iterdir() if p.suffix.lower() in _IMG_EXTS)


def clean_lr_stem(stem: str) -> str:
    for s in _LR_SUFFIXES_SCALE:
        stem = stem.replace(s, "")
    for s in _LR_SUFFIXES_NAME:
        stem = stem.replace(s, "")
    return stem.rstrip("_")


def match_pairs(lr_paths: List[Path], hr_paths: List[Path]) -> List[Tuple[Path, Path]]:
    hr_by_stem = {p.stem: p for p in hr_paths}
    lr_by_clean = {clean_lr_stem(p.stem): p for p in lr_paths}
    pairs = [(lr_by_clean[stem], hr) for stem, hr in hr_by_stem.items()
             if stem in lr_by_clean]
    if not pairs:  # fall back to exact stems
        lr_by_stem = {p.stem: p for p in lr_paths}
        pairs = [(lr_by_stem[s], hr) for s, hr in hr_by_stem.items()
                 if s in lr_by_stem]
    return sorted(pairs, key=lambda t: t[1].stem)


def find_split_dirs(root, split: str, scale: int = 4) -> Tuple[Path, Path]:
    root = Path(root)
    if split == "train":
        patterns = [
            (root / "train_LR", root / "train_HR"),
            (root / f"DIV2K_train_LR_bicubic" / f"X{scale}", root / "DIV2K_train_HR"),
            (root / "LR" / "train", root / "HR" / "train"),
            (root / "LR_train", root / "HR_train"),
            (root / f"DF2K_train_LR_bicubic" / f"X{scale}", root / "DF2K_train_HR"),
        ]
    else:
        patterns = [
            (root / "val_LR", root / "val_HR"),
            (root / f"DIV2K_valid_LR_bicubic" / f"X{scale}", root / "DIV2K_valid_HR"),
            (root / "LR" / "val", root / "HR" / "val"),
            (root / "LR_val", root / "HR_val"),
            (root / f"DF2K_valid_LR_bicubic" / f"X{scale}", root / "DF2K_valid_HR"),
            (root / "test_LR", root / "test_HR"),
        ]
    for lr_dir, hr_dir in patterns:
        if lr_dir.is_dir() and hr_dir.is_dir():
            return lr_dir, hr_dir
    tried = "\n".join(f"  LR: {a}  HR: {b}" for a, b in patterns)
    raise FileNotFoundError(f"no {split} split found under {root}; tried:\n{tried}")


class SRDataset:
    """Patch-sampling LR/HR training dataset."""

    def __init__(self, lr_dir, hr_dir, lr_patch: int = 64, scale: int = 4,
                 repeat: int = 1, cache_in_ram: bool = False,
                 augment: Optional[TrainAugmentation] = None, seed: int = 0):
        self.pairs = match_pairs(list_image_paths(lr_dir), list_image_paths(hr_dir))
        if not self.pairs:
            raise FileNotFoundError(f"no LR/HR pairs matched in {lr_dir} / {hr_dir}")
        self.scale = scale
        self.repeat = repeat
        self.augment = augment or TrainAugmentation(lr_patch, scale, seed=seed)
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        if cache_in_ram:
            for i in range(len(self.pairs)):
                self._cache[i] = self._load(i)

    def _load(self, idx: int):
        lr_path, hr_path = self.pairs[idx]
        return load_image(str(lr_path)), load_image(str(hr_path))

    def __len__(self):
        return len(self.pairs) * self.repeat

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        base = idx % len(self.pairs)
        lr, hr = self._cache.get(base) or self._load(base)
        lr, hr = self.augment(lr, hr)
        return {"lr": lr, "hr": hr, "name": self.pairs[base][1].stem}


def create_dataloaders(root, scale: int = 4, lr_patch: int = 64,
                       batch_size: int = 14, repeat: int = 1, seed: int = 0,
                       val_max_lr_size: int = 128):
    """Loader factory (reference create_dataloaders, dataset.py:509-599):
    returns (train_dataset, val_dataset, train_iter_fn) with layout
    autodetection for both splits. `train_iter_fn(epoch)` yields stacked
    {lr, hr} numpy batches, reshuffled per epoch."""
    tr_lr, tr_hr = find_split_dirs(root, "train", scale)
    va_lr, va_hr = find_split_dirs(root, "val", scale)
    train_ds = SRDataset(tr_lr, tr_hr, lr_patch, scale, repeat=repeat, seed=seed)
    val_ds = ValidationDataset(va_lr, va_hr, scale, val_max_lr_size)

    def train_iter(epoch: int = 0):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(train_ds))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [train_ds[int(j)] for j in order[i:i + batch_size]]
            yield {"lr": np.stack([it["lr"] for it in items]),
                   "hr": np.stack([it["hr"] for it in items])}

    return train_ds, val_ds, train_iter


class ValidationDataset:
    """Full-image validation pairs, LR clamped to `max_lr_size` (the
    reference resizes at 512 HR, dataset.py:438-506). Center-crops HR to
    exactly scale×LR when sizes drift."""

    def __init__(self, lr_dir, hr_dir, scale: int = 4, max_lr_size: int = 128):
        self.pairs = match_pairs(list_image_paths(lr_dir), list_image_paths(hr_dir))
        self.scale = scale
        self.max_lr_size = max_lr_size

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        lr = load_image(str(self.pairs[idx][0]))
        hr = load_image(str(self.pairs[idx][1]))
        s = self.scale
        h, w = lr.shape[:2]
        if max(h, w) > self.max_lr_size:
            scale_f = self.max_lr_size / max(h, w)
            nh, nw = max(int(h * scale_f), 8), max(int(w * scale_f), 8)
            lr = resize(torch.from_numpy(lr[None]), nh, nw, "bicubic")[0].numpy()
            hr = resize(torch.from_numpy(hr[None]), nh * s, nw * s, "bicubic")[0].numpy()
            h, w = nh, nw
        hr = hr[: h * s, : w * s]
        return {"lr": np.clip(lr, 0, 1), "hr": np.clip(hr, 0, 1),
                "name": self.pairs[idx][1].stem}
