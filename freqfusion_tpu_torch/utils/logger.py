"""Training observability. Twin of ``freqfusion_tpu/utils/logger.py``:

- ``MetricsLogger``: scalars, histograms and LR|SR|HR strips to TensorBoard where
  ``torch.utils.tensorboard`` imports (imported when a logger is made, never at module
  import), always mirrored to a JSON-lines file (``metrics.jsonl``);
- ``ProgressLogger``: per-epoch wall-clock, images a second and ETA;
- ``get_file_logger``: a file and stream logger.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


def get_file_logger(name: str, log_path: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_path:
        os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def scalars(self, tag_values: Dict[str, float], step: int, prefix: str = ""):
        rec = {"step": step}
        for k, v in tag_values.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self._tb:
                self._tb.add_scalar(name, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def histograms(self, named, step: int, prefix: str = "grads/", max_leaves: int = 16):
        """Histograms by top-level module of `named` ({dotted name: tensor}, such as a
        state dict); the largest `max_leaves` groups, to bound the cost."""
        if self._tb is None:
            return
        try:
            groups = {}
            for name, leaf in named.items():
                groups.setdefault(name.split(".")[0], []).append(
                    np.asarray(torch.as_tensor(leaf).detach().cpu()).ravel())
            items = sorted(groups.items(), key=lambda kv: -sum(a.size for a in kv[1]))
            for name, arrs in items[:max_leaves]:
                self._tb.add_histogram(prefix + str(name), np.concatenate(arrs), step)
        except Exception:
            pass  # observability must never break training

    def images(self, tag: str, lr: np.ndarray, sr: np.ndarray, hr: np.ndarray,
               step: int, max_side: int = 256):
        """LR|SR|HR comparison strip (logger.py:111 equivalent)."""
        if self._tb is None:
            return

        def prep(img):
            img = np.clip(np.asarray(torch.as_tensor(img).detach().cpu(), np.float32), 0, 1)
            img = img[:max_side, :max_side]
            return img

        sr, hr = prep(sr), prep(hr)
        h = min(sr.shape[0], hr.shape[0])
        lr_up = np.repeat(np.repeat(prep(lr), 4, 0), 4, 1)[:h]
        strip = np.concatenate(
            [a[:h, :min(a.shape[1], sr.shape[1])] for a in (lr_up, sr, hr)], axis=1)
        self._tb.add_image(tag, torch.from_numpy(strip.transpose(2, 0, 1)), step)

    def close(self):
        self._jsonl.close()
        if self._tb:
            self._tb.close()


class ProgressLogger:
    def __init__(self, total_epochs: int):
        self.total = total_epochs
        self.t_start = time.time()
        self.t_epoch = self.t_start

    def epoch_summary(self, epoch: int, images: int, extra: str = "") -> str:
        now = time.time()
        dt = now - self.t_epoch
        self.t_epoch = now
        done = epoch + 1
        eta = (now - self.t_start) / done * (self.total - done)
        rate = images / max(dt, 1e-9)
        return (f"epoch {epoch}: {dt:.1f}s, {rate:.1f} imgs/s, "
                f"ETA {eta/60:.1f} min {extra}")
