"""Perceptual quality evaluation: which tower columns are configured, the shared tower
loader and ``PerceptualEvaluator``. Twin of ``freqfusion_tpu/utils/perceptual_metrics.py``.

PSNR and SSIM (Y, border 4), a gradient sharpness proxy and NIQE (``utils/niqe.py``, once a
pristine model is fit or found) are always available. The five towers, LPIPS, DISTS,
CLIP-IQA, MUSIQ and MANIQA, are live when their variables (``TOWER_ENV``) name existing
files; an unavailable column is NaN and the perceptual score sums what is available.
The towers run on `device`, the card unless the caller names another.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict

import numpy as np

from .metrics import psnr_ssim_files

# tower column -> the variables that gate it (all must name existing files)
TOWER_ENV = {"lpips": ("FREQFUSION_LPIPS_WEIGHTS",),
             "dists": ("FREQFUSION_DISTS_WEIGHTS",),
             "clipiqa": ("FREQFUSION_CLIPIQA_WEIGHTS", "FREQFUSION_CLIP_BPE"),
             "musiq": ("FREQFUSION_MUSIQ_WEIGHTS",),
             "maniqa": ("FREQFUSION_MANIQA_WEIGHTS",)}


def configured_tower_columns():
    """The columns whose variables name existing files: a probe that builds nothing."""
    return sorted(k for k, envs in TOWER_ENV.items()
                  if all(os.environ.get(e) and os.path.exists(os.environ[e]) for e in envs))


def load_native_towers(device="cuda") -> Dict[str, object]:
    """The towers whose variables resolve, as {column: callable(output, target=None) ->
    float}, on `device`. Missing weights: the column is absent, silently; weights that are
    configured but fail to load: absent, with a warning (a silent NaN column would hide the
    misconfiguration). The eval CLI and ``PerceptualEvaluator`` share this policy."""
    from .clipiqa import NativeCLIPIQA
    from .dists import NativeDISTS
    from .lpips import NativeLPIPS
    from .maniqa import NativeMANIQA
    from .musiq import NativeMUSIQ

    makers = {"lpips": NativeLPIPS, "dists": NativeDISTS, "clipiqa": NativeCLIPIQA,
              "musiq": NativeMUSIQ, "maniqa": NativeMANIQA}
    towers = {}
    for name, maker in makers.items():
        env = TOWER_ENV[name][0]
        try:
            towers[name] = maker(device=device)
        except Exception as e:
            if os.environ.get(env):
                warnings.warn(f"{name} weights configured via {env} but failed to load "
                              f"({e}); column stays NaN")
    return towers


class PerceptualEvaluator:
    """Every column for a pair of uint8 HWC RGB images, NaN where unavailable."""

    def __init__(self, device="cuda"):
        from .niqe import load_pristine
        self._niqe_pristine = load_pristine()
        self._towers = load_native_towers(device)

    @property
    def available_metrics(self):
        out = ["psnr", "ssim", "sharpness"]
        if self._niqe_pristine is not None:
            out.append("niqe")
        return out + [k for k in ("lpips", "dists", "clipiqa", "musiq", "maniqa")
                      if k in self._towers]

    def fit_pristine(self, images) -> None:
        """Fits the NIQE pristine model from a corpus of clean images (usually the
        ground-truth set): activates the niqe column."""
        from .niqe import fit_pristine
        self._niqe_pristine = fit_pristine(images)

    @staticmethod
    def sharpness(img: np.ndarray) -> float:
        """Mean gradient magnitude, a no-reference sharpness proxy."""
        g = img.astype(np.float64)
        return float(np.mean(np.abs(np.diff(g, axis=0))) + np.mean(np.abs(np.diff(g, axis=1))))

    def evaluate_pair(self, output: np.ndarray, target: np.ndarray,
                      border: int = 4) -> Dict[str, float]:
        """uint8 HWC RGB pair -> {metric: value}, NaN for the unavailable ones."""
        p, s = psnr_ssim_files(output, target, border)
        res = {"psnr": p, "ssim": s, "sharpness": self.sharpness(output),
               **{k: float("nan") for k in ("lpips", "dists", "niqe", "musiq", "maniqa",
                                            "clipiqa")}}
        if self._niqe_pristine is not None:
            from .niqe import niqe
            res["niqe"] = niqe(output, self._niqe_pristine)
        for name, tower in self._towers.items():
            res[name] = tower(output, target)
        return res

    @staticmethod
    def perceptual_score(means: Dict[str, float]) -> float:
        """(1 - LPIPS) + (1 - DISTS) + CLIPIQA + MANIQA + MUSIQ / 100 + max(0, (10 - NIQE) /
        10), over the available (non-NaN) terms."""
        score = 0.0
        for k, term in (("lpips", lambda v: 1.0 - v), ("dists", lambda v: 1.0 - v),
                        ("clipiqa", lambda v: v), ("maniqa", lambda v: v),
                        ("musiq", lambda v: v / 100.0),
                        ("niqe", lambda v: max(0.0, (10.0 - v) / 10.0))):
            v = means.get(k, float("nan"))
            if not math.isnan(v):
                score += term(v)
        return score
