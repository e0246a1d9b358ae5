"""Block DCT-II utilities (8x8, JPEG-style zigzag banding) on NHWC tensors.

Twin of ``freqfusion_tpu/ops/dct.py``: each fixed band projection is one precomputed
64x64 operator  M_b = (D⊗D)^T diag(mask_b) (D⊗D), and all bands of an image come from one
[..,64] x [64, bands*64] product over its 8x8 blocks.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def zigzag_indices(n: int = 8) -> np.ndarray:
    """JPEG zigzag scan order of an n x n block, [n,n] int32 (0 = DC)."""
    out = np.zeros((n, n), dtype=np.int32)
    i = j = 0
    for idx in range(n * n):
        out[i, j] = idx
        if (i + j) % 2 == 0:  # moving up-right
            if j == n - 1:
                i += 1
            elif i == 0:
                j += 1
            else:
                i -= 1
                j += 1
        else:  # moving down-left
            if i == n - 1:
                j += 1
            elif j == 0:
                i += 1
            else:
                i += 1
                j -= 1
    return out


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II matrix, [n,n] float32 (D^T = D^-1)."""
    d = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        for i in range(n):
            if k == 0:
                d[k, i] = 1.0 / math.sqrt(n)
            else:
                d[k, i] = math.sqrt(2.0 / n) * math.cos(math.pi * k * (2 * i + 1) / (2 * n))
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def band_masks_thirds(n: int = 8):
    """(low, mid, high) zigzag-third masks."""
    z = zigzag_indices(n)
    total = n * n
    low = (z < total // 3).astype(np.float32)
    high = (z >= 2 * total // 3).astype(np.float32)
    mid = 1.0 - low - high
    return low, mid, high


@functools.lru_cache(maxsize=None)
def band_masks_ratio(n: int, low_ratio: float, high_ratio: float):
    """(low, mid, high) masks: idx < total*low -> low, idx >= total*(1-high) -> high."""
    z = zigzag_indices(n)
    total = n * n
    lo_t = int(total * low_ratio)
    hi_t = int(total * (1.0 - high_ratio))
    low = (z < lo_t).astype(np.float32)
    high = (z >= hi_t).astype(np.float32)
    mid = (1.0 - low - high).clip(0.0)
    return low, mid, high


@functools.lru_cache(maxsize=None)
def band_operator(n: int, masks_key: str, low_ratio: float = 0.25,
                  high_ratio: float = 0.25) -> np.ndarray:
    """Fused [n², bands*n²] operator: vec(block) -> concat of the per-band blocks, each
    reconstructed in the spatial domain."""
    if masks_key == "thirds":
        masks = band_masks_thirds(n)
    else:
        masks = band_masks_ratio(n, low_ratio, high_ratio)
    d = dct_matrix(n).astype(np.float64)
    kmat = np.kron(d, d)  # vec(D X D^T) = (D⊗D) vec(X), row-major vec
    ops = [kmat.T @ np.diag(m.reshape(-1).astype(np.float64)) @ kmat for m in masks]
    return np.concatenate(ops, axis=1).astype(np.float32)


def blockify(x: torch.Tensor, n: int = 8) -> torch.Tensor:
    """NHWC (H, W multiples of n) -> [B, nH, nW, C, n²] row-major blocks."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // n, n, w // n, n, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // n, w // n, c, n * n)


def unblockify(xb: torch.Tensor, n: int = 8) -> torch.Tensor:
    """[B, nH, nW, C, n²] -> NHWC."""
    b, nh, nw, c, _ = xb.shape
    x = xb.reshape(b, nh, nw, c, n, n).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, nh * n, nw * n, c)


def reflect_pad_to_block(x: torch.Tensor, n: int = 8) -> Tuple[torch.Tensor, Tuple[int, int]]:
    h, w = x.shape[1], x.shape[2]
    ph = (n - h % n) % n
    pw = (n - w % n) % n
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect").permute(0, 2, 3, 1)
    return x, (h, w)


def block_dct_bands(x: torch.Tensor, operator: np.ndarray, n: int = 8,
                    num_bands: int = 3) -> List[torch.Tensor]:
    """Decompose NHWC into `num_bands` spatial band images with one product."""
    xp, (h, w) = reflect_pad_to_block(x, n)
    op = torch.from_numpy(operator).to(device=x.device, dtype=x.dtype)
    out = blockify(xp, n) @ op
    return [unblockify(out[..., k * n * n:(k + 1) * n * n], n)[:, :h, :w, :].contiguous()
            for k in range(num_bands)]


def _dct_mat(like: torch.Tensor, n: int) -> torch.Tensor:
    return torch.from_numpy(dct_matrix(n)).to(device=like.device, dtype=like.dtype)


def dct2d(blocks: torch.Tensor, n: int = 8) -> torch.Tensor:
    """Forward 2-D DCT of [..., n, n] blocks: D X D^T."""
    d = _dct_mat(blocks, n)
    return d @ blocks @ d.t()


def idct2d(coeffs: torch.Tensor, n: int = 8) -> torch.Tensor:
    """Inverse 2-D DCT of [..., n, n] coefficients: D^T Y D."""
    d = _dct_mat(coeffs, n)
    return d.t() @ coeffs @ d
