"""NTIRE-style SR quality metrics (PSNR / SSIM on the BT.601 Y channel). Twin of
``freqfusion_tpu/utils/metrics.py``, with its two protocols:

1. Training-time metrics, on tensors: inputs in [0,1], clamped, a border cropped,
   studio-swing Y (65.481 R + 128.553 G + 24.966 B + 16) / 255, MSE -> PSNR; SSIM with an
   11x11 sigma 1.5 gaussian window (valid filtering).
2. File-based evaluation, in numpy: uint8 PNGs, a border cropped, full-range luma
   (Y = 0.299 R + 0.587 G + 0.114 B), PSNR on [0,255], and skimage's SSIM, through a numpy
   re-implementation where skimage is absent.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.common import gaussian_1d


# ---------------------------------------------------------------------------
# tensor protocol: training and validation
# ---------------------------------------------------------------------------

def rgb_to_y(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 studio-swing luma of NHWC RGB in [0,1] -> NHW1 in [0,1]."""
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0


def _prep(img1, img2, crop_border, y_channel):
    img1 = torch.as_tensor(img1).clamp(0.0, 1.0)
    img2 = torch.as_tensor(img2).to(img1).clamp(0.0, 1.0)
    if crop_border > 0:
        img1 = img1[..., crop_border:-crop_border, crop_border:-crop_border, :]
        img2 = img2[..., crop_border:-crop_border, crop_border:-crop_border, :]
    if y_channel and img1.shape[-1] == 3:
        img1, img2 = rgb_to_y(img1), rgb_to_y(img2)
    return img1, img2


def psnr(img1, img2, crop_border: int = 0, y_channel: bool = False) -> torch.Tensor:
    """PSNR over the whole (batched) tensor, range [0,1]: a scalar in dB."""
    img1, img2 = _prep(img1, img2, crop_border, y_channel)
    mse = (img1 - img2).square().mean()
    return 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))


def ssim(img1, img2, crop_border: int = 0, y_channel: bool = True) -> torch.Tensor:
    """Mean SSIM with an 11x11 sigma 1.5 gaussian window (valid filtering), [0,1] data:
    per-channel windowed statistics with C1 = 0.01^2, C2 = 0.03^2."""
    img1, img2 = _prep(img1, img2, crop_border, y_channel)
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[-1]
    g = torch.from_numpy(gaussian_1d(11, 1.5)).to(img1)
    win = (g[:, None] * g[None, :]).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), win, groups=c)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    smap = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return smap.mean()


class MetricCalculator:
    """Accumulates per-image PSNR and SSIM (crop_border 4, Y channel, mean over images)."""

    def __init__(self, crop_border: int = 4, y_channel: bool = True):
        self.crop_border = crop_border
        self.y_channel = y_channel
        self.reset()

    def reset(self) -> None:
        self._psnr, self._ssim, self._n = 0.0, 0.0, 0

    @torch.no_grad()
    def update(self, sr, hr) -> None:
        """sr, hr: NHWC or HWC in [0,1], tensors or numpy arrays."""
        sr, hr = torch.as_tensor(sr), torch.as_tensor(hr)
        if sr.dim() == 3:
            sr, hr = sr[None], hr[None]
        for i in range(sr.shape[0]):
            self._psnr += float(psnr(sr[i], hr[i], self.crop_border, self.y_channel))
            self._ssim += float(ssim(sr[i], hr[i], self.crop_border, self.y_channel))
            self._n += 1

    def compute(self) -> Dict[str, float]:
        n = max(self._n, 1)
        return {"psnr": self._psnr / n, "ssim": self._ssim / n, "count": self._n}


# ---------------------------------------------------------------------------
# host-side (numpy, uint8) protocol: file-based evaluation
# ---------------------------------------------------------------------------

def luma_fullrange_uint8(img: np.ndarray) -> np.ndarray:
    """cv2 RGB→YCrCb Y channel of a uint8 HWC image, as float64 (full range)."""
    img = img.astype(np.float64)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def psnr_ssim_files(output_img: np.ndarray, target_img: np.ndarray,
                    border: int = 4):
    """PSNR+SSIM of two uint8 HWC RGB arrays per utils_image.cal_psnr_ssim."""
    if border > 0:
        output_img = output_img[border:-border, border:-border, :]
        target_img = target_img[border:-border, border:-border, :]
    oy = luma_fullrange_uint8(output_img)
    ty = luma_fullrange_uint8(target_img)
    mse = np.mean((oy - ty) ** 2)
    p = float("inf") if mse == 0 else 10 * math.log10(255.0**2 / mse)
    try:
        from skimage.metrics import structural_similarity
        s = structural_similarity(oy, ty, data_range=255.0)
    except ImportError:
        s = _ssim_skimage_compat(oy, ty, data_range=255.0)
    return p, s


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """scipy.ndimage.uniform_filter equivalent ('reflect' boundary)."""
    pad = size // 2
    xp = np.pad(x, pad, mode="reflect")
    for ax in range(x.ndim):
        c = np.cumsum(xp, axis=ax, dtype=np.float64)
        lead = np.take(c, range(size - 1, xp.shape[ax]), axis=ax)
        lag = np.concatenate(
            [np.zeros_like(np.take(c, [0], axis=ax)),
             np.take(c, range(0, xp.shape[ax] - size), axis=ax)], axis=ax)
        xp = (lead - lag) / size
    return xp


def _ssim_skimage_compat(im1: np.ndarray, im2: np.ndarray,
                         data_range: float) -> float:
    """skimage.metrics.structural_similarity defaults for 2-D float inputs:
    win_size=7 uniform filter, sample covariance (N/(N-1)), K1=.01, K2=.03,
    mean over the `pad`-cropped SSIM map.
    """
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    win = 7
    npix = win ** im1.ndim
    cov_norm = npix / (npix - 1)
    ux = _uniform_filter(im1, win)
    uy = _uniform_filter(im2, win)
    uxx = _uniform_filter(im1 * im1, win)
    uyy = _uniform_filter(im2 * im2, win)
    uxy = _uniform_filter(im1 * im2, win)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())
