"""Paired training augmentations (numpy, on the host). Twin of
``freqfusion_tpu/data/augment.py``: paired random crop (LR coordinates scaled to HR), flips,
90-degree rotations, identical-factor colour jitter, Gaussian blur on LR, CutBlur, composed
by ``TrainAugmentation``; the deterministic ``CenterCrop`` of live-mode validation; the
block-DCT ``FrequencyAugmentation``; and ``geometric_augment_group`` for cached samples. The
same ``np.random.Generator`` draws happen in the same order as in the JAX package, so one
seed gives the same arrays. All take float32 HWC arrays in [0,1].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def paired_random_crop(lr: np.ndarray, hr: np.ndarray, lr_patch: int,
                       scale: int, rng: np.random.Generator):
    h, w = lr.shape[:2]
    if h < lr_patch or w < lr_patch:
        raise ValueError(f"LR image {h}x{w} smaller than patch {lr_patch}")
    y = int(rng.integers(0, h - lr_patch + 1))
    x = int(rng.integers(0, w - lr_patch + 1))
    lr_c = lr[y:y + lr_patch, x:x + lr_patch]
    hr_c = hr[y * scale:(y + lr_patch) * scale, x * scale:(x + lr_patch) * scale]
    return lr_c, hr_c


def paired_flip(lr, hr, rng, p: float = 0.5):
    if rng.random() < p:
        lr, hr = lr[:, ::-1], hr[:, ::-1]
    if rng.random() < p:
        lr, hr = lr[::-1], hr[::-1]
    return np.ascontiguousarray(lr), np.ascontiguousarray(hr)


def paired_rot90(lr, hr, rng, p: float = 0.5):
    if rng.random() < p:
        k = int(rng.integers(1, 4))
        lr = np.rot90(lr, k)
        hr = np.rot90(hr, k)
    return np.ascontiguousarray(lr), np.ascontiguousarray(hr)


def color_jitter(lr, hr, rng, brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1, p: float = 0.3):
    """Identical jitter factors applied to both images
    (augmentations.py:178-265 semantics)."""
    if rng.random() >= p:
        return lr, hr

    def apply(img, b, c, s):
        img = img * b
        mean = img.mean(axis=(0, 1), keepdims=True)
        img = (img - mean) * c + mean
        gray = img.mean(axis=-1, keepdims=True)
        img = (img - gray) * s + gray
        return np.clip(img, 0.0, 1.0)

    b = 1.0 + float(rng.uniform(-brightness, brightness))
    c = 1.0 + float(rng.uniform(-contrast, contrast))
    s = 1.0 + float(rng.uniform(-saturation, saturation))
    return apply(lr, b, c, s), apply(hr, b, c, s)


def gaussian_blur_lr(lr, hr, rng, sigma_range=(0.2, 1.0), p: float = 0.1):
    """Blur only the LR input (simulates softer degradations)."""
    if rng.random() >= p:
        return lr, hr
    sigma = float(rng.uniform(*sigma_range))
    radius = max(1, int(3 * sigma))
    coords = np.arange(-radius, radius + 1)
    k = np.exp(-coords**2 / (2 * sigma**2))
    k /= k.sum()
    for axis in (0, 1):
        lr = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, lr)
    return lr.astype(np.float32), hr


def cutblur(lr, hr, rng, scale: int = 4, alpha: float = 0.7, p: float = 0.3):
    """CutBlur: paste a downsampled-HR region into HR (or vice versa)."""
    if rng.random() >= p:
        return lr, hr
    h, w = hr.shape[:2]
    ch, cw = int(h * alpha * rng.random()), int(w * alpha * rng.random())
    if ch < scale or cw < scale:
        return lr, hr
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    hr = hr.copy()
    # replace HR region with nearest-upsampled LR content (the "blur")
    lr_region = lr[y // scale:(y + ch) // scale, x // scale:(x + cw) // scale]
    up = np.repeat(np.repeat(lr_region, scale, axis=0), scale, axis=1)
    # the pasted block is clipped to the region and the image: where the upsampled LR
    # region is larger than the region, the JAX package's assignment raises instead
    nh, nw = min(up.shape[0], ch, h - y), min(up.shape[1], cw, w - x)
    hr[y:y + nh, x:x + nw] = up[:nh, :nw]
    return lr, hr


class TrainAugmentation:
    """Crop + geometric + photometric pipeline (augmentations.py:373-464)."""

    def __init__(self, lr_patch: int = 64, scale: int = 4,
                 use_color_jitter: bool = False, use_cutblur: bool = False,
                 use_blur: bool = False, seed: Optional[int] = None):
        self.lr_patch = lr_patch
        self.scale = scale
        self.use_color_jitter = use_color_jitter
        self.use_cutblur = use_cutblur
        self.use_blur = use_blur
        self.rng = np.random.default_rng(seed)

    def __call__(self, lr: np.ndarray, hr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        lr, hr = paired_random_crop(lr, hr, self.lr_patch, self.scale, self.rng)
        lr, hr = paired_flip(lr, hr, self.rng)
        lr, hr = paired_rot90(lr, hr, self.rng)
        if self.use_color_jitter:
            lr, hr = color_jitter(lr, hr, self.rng)
        if self.use_blur:
            lr, hr = gaussian_blur_lr(lr, hr, self.rng)
        if self.use_cutblur:
            lr, hr = cutblur(lr, hr, self.rng, self.scale)
        return lr, hr


class CenterCrop:
    """Deterministic paired center crop: live-mode validation at one fixed shape, as the
    JAX package validates (where the reference validates full images with a max-size
    clamp, dataset.py:438-506). Images smaller than the patch are reflect-padded first."""

    def __init__(self, lr_patch: int = 64, scale: int = 4):
        self.lr_patch, self.scale = lr_patch, scale

    def __call__(self, lr: np.ndarray, hr: np.ndarray):
        p, s = self.lr_patch, self.scale
        pad_h = max(p - lr.shape[0], 0)
        pad_w = max(p - lr.shape[1], 0)
        if pad_h or pad_w:
            lr = np.pad(lr, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
            hr = np.pad(hr, ((0, pad_h * s), (0, pad_w * s), (0, 0)),
                        mode="reflect")
        y = (lr.shape[0] - p) // 2
        x = (lr.shape[1] - p) // 2
        return (lr[y:y + p, x:x + p],
                hr[y * s:(y + p) * s, x * s:(x + p) * s])


class FrequencyAugmentation:
    """Train-time random per-band DCT coefficient scaling
    (frequency_decomposition.py:549-616): with probability `prob`, the 8×8
    block-DCT low/mid/high coefficients of both images are scaled by factors
    drawn from (0.9,1.1)/(0.85,1.15)/(0.8,1.2). Host-side numpy."""

    def __init__(self, block_size: int = 8,
                 low_range=(0.9, 1.1), mid_range=(0.85, 1.15),
                 high_range=(0.8, 1.2), prob: float = 0.5,
                 seed: Optional[int] = None):
        from ..ops.dct import band_masks_ratio, dct_matrix

        self.n = block_size
        self.ranges = (low_range, mid_range, high_range)
        self.prob = prob
        self.rng = np.random.default_rng(seed)
        self.d = dct_matrix(block_size).astype(np.float64)
        self.masks = band_masks_ratio(block_size, 0.25, 0.25)

    def _apply(self, img: np.ndarray, scales) -> np.ndarray:
        n = self.n
        h, w, c = img.shape
        ph, pw = (n - h % n) % n, (n - w % n) % n
        x = np.pad(img, [(0, ph), (0, pw), (0, 0)], mode="reflect")
        hp, wp = x.shape[:2]
        blocks = x.reshape(hp // n, n, wp // n, n, c).transpose(0, 2, 4, 1, 3)
        coeffs = np.einsum("ka,...ab,lb->...kl", self.d, blocks, self.d)
        scale_map = sum(s * m for s, m in zip(scales, self.masks))
        coeffs = coeffs * scale_map
        out = np.einsum("ka,...kl,lb->...ab", self.d, coeffs, self.d)
        out = out.transpose(0, 3, 1, 4, 2).reshape(hp, wp, c)
        return np.clip(out[:h, :w], 0.0, 1.0).astype(np.float32)

    def __call__(self, lr: np.ndarray, hr: np.ndarray):
        if self.rng.random() >= self.prob:
            return lr, hr
        scales = [float(self.rng.uniform(*r)) for r in self.ranges]
        return self._apply(lr, scales), self._apply(hr, scales)


def geometric_augment_group(arrays, rng):
    """Apply ONE consistent flip/rotation to a group of arrays at possibly
    different resolutions (cached-mode augmentation, cached_dataset.py:214-268)."""
    fh = rng.random() < 0.5
    fv = rng.random() < 0.5
    k = int(rng.integers(0, 4))

    def apply(a):
        if fh:
            a = a[:, ::-1]
        if fv:
            a = a[::-1]
        if k:
            a = np.rot90(a, k)
        return np.ascontiguousarray(a)

    return [apply(a) for a in arrays]
