"""The cached expert-feature dataset of cached-mode training. Twin of
``freqfusion_tpu/data/cached.py``. Two storage formats:

1. ``.npz``, one file a crop (``data/extract.py``, in either package): lr [h,w,3],
   hr [4h,4w,3], out_{hat,dat,nafnet} [4h,4w,3], feat_{hat,dat} [h,w,180],
   feat_nafnet [h,w,64];
2. the reference's ``.pt`` pairs ({stem}_hat_part.pt + {stem}_rest_part.pt, CHW tensors),
   read by ``torch.load``, with the drct -> hat and grl -> dat key remaps.

Augmentation is geometric only, the same flip and rotation for every array of a sample.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .augment import geometric_augment_group

_KEY_REMAP = {"drct": "hat", "grl": "dat"}


def _remap(name: str) -> str:
    return _KEY_REMAP.get(name, name)


def _chw_to_hwc(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    if a.ndim == 4:
        a = a[0]
    return np.transpose(a, (1, 2, 0))


class CachedFeatureDataset:
    def __init__(self, cache_dir, augment: bool = True, seed: int = 0):
        self.dir = Path(cache_dir)
        self.augment = augment
        self.rng = np.random.default_rng(seed)
        self.samples = self._index()
        if not self.samples:
            raise FileNotFoundError(f"no cached samples under {cache_dir}")

    def _index(self) -> List[Dict]:
        npz = sorted(self.dir.glob("*.npz"))
        if npz:
            return [{"fmt": "npz", "path": p} for p in npz]
        hat_parts = sorted(self.dir.glob("*_hat_part.pt")) + \
            sorted(self.dir.glob("*_drct_part.pt"))
        out = []
        for hp in hat_parts:
            stem = hp.name.replace("_hat_part.pt", "").replace("_drct_part.pt", "")
            for rest_name in (f"{stem}_rest_part.pt",):
                rp = self.dir / rest_name
                if rp.exists():
                    out.append({"fmt": "pt", "hat": hp, "rest": rp})
        return out

    def __len__(self):
        return len(self.samples)

    def _load_npz(self, path) -> Dict[str, np.ndarray]:
        with np.load(path) as z:
            return {k: np.asarray(z[k], np.float32) for k in z.files}

    def _load_pt(self, rec) -> Dict[str, np.ndarray]:
        hat = torch.load(rec["hat"], map_location="cpu", weights_only=True)
        rest = torch.load(rec["rest"], map_location="cpu", weights_only=True)
        sample = {
            "lr": np.transpose(np.asarray(hat["lr"], np.float32), (1, 2, 0)),
            "hr": np.transpose(np.asarray(hat["hr"], np.float32), (1, 2, 0)),
        }
        for part in (hat, rest):
            for name, t in part.get("outputs", {}).items():
                sample[f"out_{_remap(name)}"] = _chw_to_hwc(t)
            for name, t in part.get("features", {}).items():
                sample[f"feat_{_remap(name)}"] = _chw_to_hwc(t)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rec = self.samples[idx % len(self.samples)]
        sample = (self._load_npz(rec["path"]) if rec["fmt"] == "npz"
                  else self._load_pt(rec))
        if self.augment:
            keys = [k for k in sample if k != "name"]
            arrays = geometric_augment_group([sample[k] for k in keys], self.rng)
            sample = dict(zip(keys, arrays))
        return sample


def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue: host-side batch
    assembly (decode, stack) overlaps the device's work, as the reference's prefetching
    DataLoader workers do."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        yield item


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True):
    """Simple epoch iterator yielding stacked numpy batches in the train-step
    layout {lr, hr, expert_outputs{...}, expert_features{...}}."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    end = len(order) - (len(order) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        items = [dataset[int(j)] for j in order[i:i + batch_size]]
        if not items:
            continue
        batch = {
            "lr": np.stack([it["lr"] for it in items]),
            "hr": np.stack([it["hr"] for it in items]),
        }
        if "out_hat" in items[0]:
            batch["expert_outputs"] = {
                n: np.stack([it[f"out_{n}"] for it in items])
                for n in ("hat", "dat", "nafnet")}
        if "feat_hat" in items[0]:
            batch["expert_features"] = {
                n: np.stack([it[f"feat_{n}"] for it in items])
                for n in ("hat", "dat", "nafnet")}
        yield batch
