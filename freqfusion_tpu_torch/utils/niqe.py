"""NIQE (no-reference IQA, Mittal, Soundararajan & Bovik 2013) in host numpy. Twin of
``freqfusion_tpu/utils/niqe.py``, of which it is a copy: the port imports nothing of the JAX
package, and the JAX package too computes NIQE on the host.

  MSCN coefficients (local mean / variance normalisation, 7x7 Gaussian, sigma 7/6) -> a GGD
  fit of the MSCN map and AGGD fits of its 4 pairwise products (H, V, D1, D2) -> 18
  features a scale x 2 scales = 36-dim patch features -> sharpness-selected patches when
  fitting the pristine model -> MVG fit -> Mahalanobis-type distance between the test and
  pristine models.

The pristine model is fit from a corpus of clean images (the eval CLI uses the ground-truth
directory) or loaded from ``model_zoo/niqe_pristine.npz`` (keys mu, cov). Scores compare
within a run and grow with distortion; they are not the MATLAB release's constants.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# precomputed lookup for the GGD/AGGD shape solver: r(α) = Γ(2/α)²/(Γ(1/α)Γ(3/α))
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (np.exp(2 * np.vectorize(math.lgamma)(2.0 / _GAM)
                 - np.vectorize(math.lgamma)(1.0 / _GAM)
                 - np.vectorize(math.lgamma)(3.0 / _GAM)))


def _gauss_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    half = (size - 1) / 2.0
    x = np.arange(size) - half
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy.ndimage import correlate
    return correlate(img, kernel, mode="nearest")


def mscn(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Gray [H,W] float → (MSCN coefficients, local σ map)."""
    win = _gauss_window()
    mu = _filter2(gray, win)
    sigma = np.sqrt(np.maximum(_filter2(gray * gray, win) - mu * mu, 0.0))
    return (gray - mu) / (sigma + 1.0), sigma


def _ggd_fit(x: np.ndarray) -> Tuple[float, float]:
    """x → (alpha, sigma^2) by moment matching."""
    sigma_sq = float(np.mean(x ** 2))
    e_abs = float(np.mean(np.abs(x)))
    if sigma_sq <= 0 or e_abs <= 0:
        return 10.0, 0.0
    rho = (e_abs ** 2) / sigma_sq
    alpha = float(_GAM[np.argmin((_R_GAM - rho) ** 2)])
    return alpha, sigma_sq


def _aggd_fit(x: np.ndarray) -> Tuple[float, float, float, float]:
    """x → (alpha, mean η, σl², σr²) of the asymmetric GGD."""
    left = x[x < 0]
    right = x[x > 0]
    sig_l = math.sqrt(float(np.mean(left ** 2))) if left.size else 1e-6
    sig_r = math.sqrt(float(np.mean(right ** 2))) if right.size else 1e-6
    gamma_hat = sig_l / max(sig_r, 1e-6)
    e_abs = float(np.mean(np.abs(x)))
    e_sq = float(np.mean(x ** 2))
    r_hat = (e_abs ** 2) / e_sq if e_sq > 0 else 0.0
    rn = r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / \
        max((gamma_hat ** 2 + 1) ** 2, 1e-12)
    alpha = float(_GAM[np.argmin((_R_GAM - rn) ** 2)])
    g1 = math.gamma(1.0 / alpha)
    g2 = math.gamma(2.0 / alpha)
    g3 = math.gamma(3.0 / alpha)
    # η = (βr − βl)·Γ(2/α)/Γ(1/α) with β = σ·sqrt(Γ(1/α)/Γ(3/α)) — the
    # published AGGD mean (MATLAB estimateaggdparam), keeping the feature
    # scale compatible with pristine models fit by the official pipeline
    eta = (sig_r - sig_l) * (g2 / g1) * math.sqrt(g1 / g3)
    return alpha, eta, sig_l ** 2, sig_r ** 2


_SHIFTS = ((0, 1), (1, 0), (1, 1), (1, -1))  # H, V, D1, D2 product pairs


def _patch_features(m: np.ndarray) -> List[float]:
    """18 features of one MSCN patch (GGD pair + 4 AGGD quads)."""
    feats = list(_ggd_fit(m))
    for dy, dx in _SHIFTS:
        shifted = np.roll(np.roll(m, dy, axis=0), dx, axis=1)
        feats.extend(_aggd_fit((m * shifted).ravel()))
    return feats


def _to_gray(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype == np.uint8:
        a = a.astype(np.float64)
    elif a.dtype != np.float64:
        a = a.astype(np.float64)
        if a.max() <= 1.0 + 1e-6:
            a = a * 255.0
    if a.ndim == 3:
        a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return a


def niqe_features(img: np.ndarray, patch: int = 96,
                  sharpness_frac: Optional[float] = None
                  ) -> Optional[np.ndarray]:
    """Image (HWC uint8/float or gray) → [n_patches, 36] feature rows, or
    None when the image is too small.

    `sharpness_frac` keeps only patches with local σ ≥ frac·max — the
    published pipeline applies this ONLY when fitting the pristine model
    (the paper's patch selection step); test images are scored on ALL
    patches, else blurred regions (the main NIQE signal) would be dropped
    and distorted images scored optimistically."""
    gray = _to_gray(img)
    h, w = gray.shape
    ny, nx = h // patch, w // patch
    if ny == 0 or nx == 0:
        return None
    gray = gray[: ny * patch, : nx * patch]
    m1, sig1 = mscn(gray)
    # scale 2: 2× average-pool then renormalize
    half = (gray[0::2, 0::2] + gray[1::2, 0::2] +
            gray[0::2, 1::2] + gray[1::2, 1::2]) / 4.0
    m2, _ = mscn(half)

    if sharpness_frac is None:
        keep = np.ones((ny, nx), bool)
    else:
        sharp = np.zeros((ny, nx))
        for i in range(ny):
            for j in range(nx):
                sharp[i, j] = sig1[i * patch:(i + 1) * patch,
                                   j * patch:(j + 1) * patch].mean()
        keep = sharp >= sharpness_frac * sharp.max()

    p2 = patch // 2
    rows = []
    for i in range(ny):
        for j in range(nx):
            if not keep[i, j]:
                continue
            f = _patch_features(m1[i * patch:(i + 1) * patch,
                                   j * patch:(j + 1) * patch])
            f += _patch_features(m2[i * p2:(i + 1) * p2,
                                    j * p2:(j + 1) * p2])
            rows.append(f)
    if not rows:
        return None
    return np.asarray(rows, np.float64)


def fit_mvg(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Feature rows → (mu [36], cov [36,36]) with NaN rows dropped."""
    rows = rows[~np.isnan(rows).any(axis=1)]
    mu = rows.mean(axis=0)
    cov = np.cov(rows, rowvar=False)
    return mu, np.atleast_2d(cov)


def fit_pristine(images: Sequence[np.ndarray], patch: int = 96,
                 sharpness_frac: float = 0.75):
    """Corpus of clean images → pristine (mu, cov) model (with the paper's
    sharpness-based patch selection, training-side only)."""
    rows = [r for img in images
            for r in (niqe_features(img, patch, sharpness_frac),)
            if r is not None]
    if not rows:
        raise ValueError("no image in the corpus is large enough for NIQE "
                         f"(needs >= {patch}x{patch})")
    return fit_mvg(np.concatenate(rows, axis=0))


def load_pristine(path: Optional[str] = None):
    """model_zoo/niqe_pristine.npz (keys mu, cov) → (mu, cov) or None."""
    path = path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "model_zoo", "niqe_pristine.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return np.asarray(z["mu"], np.float64), np.asarray(z["cov"], np.float64)


def niqe(img: np.ndarray, pristine: Tuple[np.ndarray, np.ndarray],
         patch: int = 96) -> float:
    """NIQE score of `img` against a pristine (mu, cov) model (lower is
    better). NaN when the image is too small for one patch."""
    rows = niqe_features(img, patch)
    if rows is None:
        return float("nan")
    mu_t, cov_t = fit_mvg(rows)
    mu_p, cov_p = pristine
    d = mu_p - mu_t
    mid = (cov_p + cov_t) / 2.0
    sol = np.linalg.pinv(mid) @ d
    return float(math.sqrt(max(float(d @ sol), 0.0)))
