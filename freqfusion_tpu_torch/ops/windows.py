"""Window-attention utilities shared by the DAT and HAT experts. Twin of
``freqfusion_tpu/ops/windows.py``.

Tables and masks are numpy constants built once per shape (``lru_cache``) and returned
read-only; tensors keep the JAX package's NHWC layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, hs*ws, C] (row-major windows, torch ordering)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // hs, hs, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, hs * ws, c)


def window_reverse(wins: torch.Tensor, hs: int, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nW, hs*ws, C] -> [B,H,W,C]."""
    c = wins.shape[-1]
    b = wins.shape[0] // ((h // hs) * (w // ws))
    x = wins.reshape(b, h // hs, w // ws, hs, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)   # cached and shared: nobody may edit it in place
    return a


@functools.lru_cache(maxsize=None)
def relative_position_index(hs: int, ws: int) -> np.ndarray:
    """Swin-style relative position index, [hs*ws, hs*ws] int64 into a (2hs-1)(2ws-1)
    bias table; ordering of torch's meshgrid(indexing='ij') + flatten construction."""
    coords = np.stack(np.meshgrid(np.arange(hs), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += hs - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return _frozen(rel.sum(-1).astype(np.int64))


@functools.lru_cache(maxsize=None)
def relative_coords_table(hs: int, ws: int) -> np.ndarray:
    """All relative (dy,dx) offsets, [(2hs-1)*(2ws-1), 2] float32: the input the DAT
    DynamicPosBias MLP is evaluated on."""
    grid = np.stack(np.meshgrid(np.arange(1 - hs, hs), np.arange(1 - ws, ws),
                                indexing="ij"))
    return _frozen(grid.reshape(2, -1).T.astype(np.float32))


def swin_bias_from_table(table: torch.Tensor, hs: int, ws: int,
                         index: torch.Tensor | None = None) -> torch.Tensor:
    """[(2hs-1)(2ws-1), nh] bias table -> [nh, hs*ws, hs*ws] bias matrix.

    A plain index gather: it selects the same table entries as the JAX package's
    one-hot Toeplitz einsum (a TPU gather workaround), exactly. `index` is
    relative_position_index(hs, ws) already on the table's device, when the caller keeps
    one."""
    n = hs * ws
    if index is None:
        index = torch.from_numpy(relative_position_index(hs, ws).copy()).to(table.device)
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def oca_relative_position_index(ws: int, wse: int) -> np.ndarray:
    """OCAB relative position index, [ws*ws, wse*wse] int64 into a (ws+wse-1)^2 bias table:
    query coordinates in the ws x ws window against key coordinates in the wse x wse
    extended window. The reference's construction lets offsets go negative and wrap around
    the table's end; here they are already taken modulo the table's length."""
    ori = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ext = np.stack(np.meshgrid(np.arange(wse), np.arange(wse), indexing="ij")).reshape(2, -1)
    rel = (ext[:, None, :] - ori[:, :, None]).transpose(1, 2, 0) + (ws - wse + 1)
    d = ws + wse - 1
    return _frozen((rel[:, :, 0] * d + rel[:, :, 1]).astype(np.int64) % (d * d))


def oca_bias_from_table(table: torch.Tensor, ws: int, wse: int,
                        index: torch.Tensor | None = None) -> torch.Tensor:
    """[(ws+wse-1)^2, nh] OCAB bias table -> [nh, ws*ws, wse*wse] bias matrix: a plain index
    gather, which selects the entries that the JAX package's roll-and-slice construction
    selects. `index` is oca_relative_position_index(ws, wse) already on the table's device,
    when the caller keeps one."""
    if index is None:
        index = torch.from_numpy(oca_relative_position_index(ws, wse).copy()).to(table.device)
    return table[index.reshape(-1)].reshape(ws * ws, wse * wse, -1).permute(2, 0, 1).contiguous()


def extract_overlapping_windows(x: torch.Tensor, win: int, overlap: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, (win+overlap)^2, C] overlapping windows at stride `win`, the image
    zero-padded by overlap/2 on each side: the reference OCAB's nn.Unfold. Windows are in
    row-major order, each laid out [owh, oww, C]."""
    b, h, w, c = x.shape
    ows, p = win + overlap, overlap // 2
    xp = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    wins = xp.unfold(1, ows, win).unfold(2, ows, win)      # [B, nh, nw, C, owh, oww]
    return wins.permute(0, 1, 2, 4, 5, 3).reshape(-1, ows * ows, c)


@functools.lru_cache(maxsize=8)   # O(image) * N^2 floats each: keep few
def shift_attn_mask(h: int, w: int, hs: int, ws: int, sh: int, sw: int) -> np.ndarray:
    """Shifted-window attention mask, [nW, hs*ws, hs*ws] float32 {0,-100}.

    Labels image regions by shift boundary, partitions into (hs,ws) windows, and masks
    cross-region pairs: the Swin/DAT mask construction."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hsl in (slice(0, h - hs), slice(h - hs, h - sh), slice(h - sh, h)):
        for wsl in (slice(0, w - ws), slice(w - ws, w - sw), slice(w - sw, w)):
            img[hsl, wsl] = cnt
            cnt += 1
    wins = img.reshape(h // hs, hs, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, hs * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return _frozen(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


def shift_mask_types(hs: int, ws: int, sh: int, sw: int) -> np.ndarray:
    """The 4 kinds of window in any image's shift mask, [4, hs*ws, hs*ws]: 0 interior,
    1 last column, 2 last row, 3 corner. A window's mask depends only on whether it lies
    in the last row and the last column of windows, so the mask of a 2 x 2-window image
    lists them all, in this order."""
    return shift_attn_mask(2 * hs, 2 * ws, hs, ws, sh, sw)
