"""Checkpoint management. Twin of ``freqfusion_tpu/training/checkpoint.py``, with the JAX
package's behaviour:
- atomic writes (a temporary file, then ``os.replace``);
- ``latest.ckpt``, written at every save;
- best-K retention under ``best_epoch{E:04d}_{metric}{V:.2f}.ckpt``, the worst evicted;
- ``training_history.json``, from which the best-K entries are restored on resume.

A checkpoint is one ``torch.save`` file of a dict: epoch, metrics, ``model`` (the head's
state dict under the reference's torch keys, BatchNorm statistics included),
``opt_state`` (the optimizer's state dict), step and ``ema_state``. ``infer/io.py``
serves the head from it. The JAX package writes flax msgpack instead; the port reads those
too (``infer/io.py``), and writes only its own format.
"""

from __future__ import annotations

import io
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, checkpoint_dir: str, max_best: int = 3, save_every: int = 10,
                 metric_name: str = "psnr", higher_is_better: bool = True):
        self.dir = checkpoint_dir
        self.max_best = max_best
        self.save_every = save_every
        self.metric_name = metric_name
        self.higher = higher_is_better
        os.makedirs(self.dir, exist_ok=True)
        self.best: List[Dict[str, Any]] = []   # [{epoch, value, path}]
        self.history: List[Dict[str, Any]] = []
        self._load_history()

    # -- history ----------------------------------------------------------
    @property
    def _history_path(self) -> str:
        return os.path.join(self.dir, "training_history.json")

    def _load_history(self) -> None:
        if not os.path.exists(self._history_path):
            return
        with open(self._history_path) as f:
            data = json.load(f)
        self.history = data.get("history", [])
        # the best-K entries whose files still exist, restored on resume
        self.best = [b for b in data.get("best", []) if os.path.exists(b.get("path", ""))]

    def _save_history(self) -> None:
        _atomic_write(self._history_path, json.dumps(
            {"history": self.history, "best": self.best}, indent=2).encode())

    # -- queries ----------------------------------------------------------
    def _order(self, b: Dict[str, Any]) -> float:
        return -b["value"] if self.higher else b["value"]

    def best_value(self) -> Optional[float]:
        if not self.best:
            return None
        values = [b["value"] for b in self.best]
        return max(values) if self.higher else min(values)

    def is_best(self, value: float) -> bool:
        bv = self.best_value()
        if bv is None:
            return True
        return value > bv if self.higher else value < bv

    def should_save(self, epoch: int) -> bool:
        return (epoch + 1) % self.save_every == 0

    def get_best_checkpoint(self) -> Optional[str]:
        if not self.best:
            return None
        return sorted(self.best, key=self._order)[0]["path"]

    def latest_path(self) -> str:
        return os.path.join(self.dir, "latest.ckpt")

    # -- save / load ------------------------------------------------------
    def save_checkpoint(self, epoch: int, payload: Dict[str, Any], metrics: Dict[str, float],
                        is_best: bool = False) -> None:
        """payload: {model, opt_state, step, ema_state, ...}, tensors on any device."""
        record = {"epoch": epoch, "metrics": dict(metrics), **_to_cpu(payload)}
        buf = io.BytesIO()
        torch.save(record, buf)
        latest = self.latest_path()
        _atomic_write(latest, buf.getvalue())

        if is_best:
            value = float(metrics.get(self.metric_name, 0.0))
            name = f"best_epoch{epoch:04d}_{self.metric_name}{value:.2f}.ckpt"
            path = os.path.join(self.dir, name)
            shutil.copyfile(latest, path)
            self.best.append({"epoch": epoch, "value": value, "path": path})
            self.best.sort(key=self._order)
            while len(self.best) > self.max_best:
                evicted = self.best.pop()
                if os.path.exists(evicted["path"]):
                    os.remove(evicted["path"])

        self.history.append({"epoch": epoch, "metrics": dict(metrics)})
        self._save_history()

    def load(self, path: Optional[str] = None,
             map_location="cpu") -> Optional[Dict[str, Any]]:
        """The record of `path` (``latest.ckpt`` by default), or None if there is none."""
        path = path or self.latest_path()
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)
