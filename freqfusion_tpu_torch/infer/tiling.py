"""Tiled full-resolution inference. Twin of ``freqfusion_tpu/infer/tiling.py``.

An image that the whole-image plan refuses (too many pixels, smaller than its reflect
padding) streams through the model as fixed-shape tiles: every forward sees
[batch, tile, tile, 3]. The plans (``tile_grid``, ``plan_grid``, ``num_tiles``) and the
seam ramp (``_ramp_profile``) are the JAX package's, kept here as the port's own copy: each
tile is weighted by a ramp that falls from 1 to ~0 across the `overlap` border (only on
sides that have a neighbour), accumulated, and normalised.

Where the JAX package stitches on the host (numpy, or its C++ library), the port stitches
with torch ops on the device the tiles come from, in the same tile order: the padded LR
image and the ramps are uploaded once before the loop, tiles are cut on the device, and
nothing in the chunk loop copies between host and device or waits for the device: each
chunk's forward and stitch are enqueued while the device still runs the chunks before it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils import profiling


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises if it names the card and there is none (nothing
    here falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: serving runs on the card unless the "
                           "caller asks for another device (device=\"cpu\")")
    return device


def _ramp_profile(size: int, overlap: int, has_lo: bool, has_hi: bool) -> np.ndarray:
    w = np.ones(size, dtype=np.float32)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1, dtype=np.float32)) / (overlap + 1)
        if has_lo:
            w[:overlap] = ramp
        if has_hi:
            w[-overlap:] = ramp[::-1]
    return w


def tile_grid(size: int, tile: int, stride: int):
    """Start offsets covering [0, size) with a final clamped tile."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile + 1, stride))
    if starts[-1] + tile < size:
        starts.append(size - tile)
    return starts


def _even_starts(size: int, tile: int, n: int):
    """n evenly-spread tile starts covering [0, size)."""
    if n <= 1:
        return [0]
    return [round(i * (size - tile) / (n - 1)) for i in range(n)]


def plan_grid(h: int, w: int, tile: int, overlap: int, batch: int):
    """Per-image tile plan: (ys, xs, ov_y, ov_x).

    Starts from the target-overlap grid, then considers +1 tile per axis and picks the
    layout with the fewest *executed* forwards (ceil(total/batch)*batch): a grid whose tile
    count divides the batch beats padding the last chunk with duplicate tiles. Extra tiles
    raise the effective overlap, never lower it.
    """
    stride = tile - overlap
    nh0 = len(tile_grid(max(h, tile), tile, stride))
    nw0 = len(tile_grid(max(w, tile), tile, stride))
    best = None
    for nh in (nh0, nh0 + 1):
        for nw in (nw0, nw0 + 1):
            if (nh > 1 and nh0 == 1) or (nw > 1 and nw0 == 1):
                continue  # never split an axis that fits in one tile
            total = nh * nw
            executed = -(-total // batch) * batch
            key = (executed, total)
            if best is None or key < best[0]:
                best = (key, nh, nw)
    _, nh, nw = best
    ys = _even_starts(h, tile, nh)
    xs = _even_starts(w, tile, nw)

    def eff_overlap(starts):
        if len(starts) < 2:
            return 0
        return tile - max(b - a for a, b in zip(starts, starts[1:]))

    return ys, xs, eff_overlap(ys), eff_overlap(xs)


def num_tiles(h: int, w: int, tile: int = 128, overlap: int = 32, batch: int = 1) -> int:
    ys, xs, _, _ = plan_grid(max(h, tile), max(w, tile), tile, overlap, batch)
    return len(ys) * len(xs)


def tiled_sr(lr: np.ndarray, forward_batch: Callable[[torch.Tensor], torch.Tensor],
             tile: int = 128, overlap: int = 32, batch: int = 1, scale: int = 4,
             device="cuda") -> torch.Tensor:
    """x`scale` SR of an HWC float image of any size through fixed-shape tiles.

    `forward_batch`: [batch, tile, tile, 3] float32 on `device` -> [batch, s*tile, s*tile, 3]
    on `device` (float32 or bfloat16: the stitch accumulates in f32), enqueued without
    waiting. A small image is reflect-padded up to one tile
    (with numpy on the host, whose reflect folds as often as the pad needs); the last chunk
    is padded to `batch` by repeating its last tile. Returns [s*H, s*W, 3] float32 on
    `device`: the card unless the caller names another, and without a card the default
    raises.
    """
    device = require_device(device)
    h, w, _ = lr.shape
    ph, pw = max(tile - h, 0), max(tile - w, 0)
    if ph or pw:
        lr = np.pad(lr, [(0, ph), (0, pw), (0, 0)], mode="reflect")
    hp, wp, _ = lr.shape

    ys, xs, ov_y, ov_x = plan_grid(hp, wp, tile, overlap, batch)
    coords = [(y, x) for y in ys for x in xs]
    t_hr = tile * scale

    # everything the loop needs from the host goes up before it: the image, and one ramp
    # per tile row and per tile column
    with profiling.span("ff.upload"):
        x_dev = torch.from_numpy(np.ascontiguousarray(lr, dtype=np.float32)).to(device)
        wys = torch.from_numpy(np.stack([
            _ramp_profile(t_hr, ov_y * scale, y > 0, y + tile < hp) for y in ys])).to(device)
        wxs = torch.from_numpy(np.stack([
            _ramp_profile(t_hr, ov_x * scale, x > 0, x + tile < wp) for x in xs])).to(device)
    row, colm = {y: i for i, y in enumerate(ys)}, {x: i for i, x in enumerate(xs)}
    out = torch.zeros((hp * scale, wp * scale, 3), dtype=torch.float32, device=device)
    acc = torch.zeros((hp * scale, wp * scale, 1), dtype=torch.float32, device=device)

    def make_tiles(chunk):
        tiles = [x_dev[y:y + tile, x:x + tile] for (y, x) in chunk]
        tiles += [tiles[-1]] * (batch - len(chunk))   # the static batch shape
        return torch.stack(tiles)

    def accumulate(sr_tile, y, x):
        wmap = (wys[row[y]][:, None] * wxs[colm[x]][None, :])[:, :, None]
        ys_hr, xs_hr = y * scale, x * scale
        out[ys_hr:ys_hr + t_hr, xs_hr:xs_hr + t_hr] += sr_tile * wmap
        acc[ys_hr:ys_hr + t_hr, xs_hr:xs_hr + t_hr] += wmap

    # each chunk is stitched after its forward, in the JAX package's tile order; nothing
    # here waits for the device
    for ci in range(0, len(coords), batch):
        chunk = coords[ci:ci + batch]
        with profiling.span("ff.chunk", chunk=ci // batch):
            sr = forward_batch(make_tiles(chunk))
            for j, (y, x) in enumerate(chunk):
                accumulate(sr[j].float(), y, x)

    with profiling.span("ff.normalize"):
        out = out / torch.clamp(acc, min=1e-8)
    return out[: h * scale, : w * scale]


def whole_image_sr(lr: np.ndarray, forward_img: Callable[[torch.Tensor], torch.Tensor],
                   scale: int = 4, multiple: int = 16, device="cuda",
                   bucket=None) -> torch.Tensor:
    """Single-dispatch x`scale` SR of one HWC float image: reflect-padded to the `bucket`
    (Hp, Wp) its caller chose, or else up to a multiple of `multiple`, run as [1, Hp, Wp, 3]
    on `device` (the card unless the caller names another), cropped. Returns [s*H, s*W, 3]
    on `device`."""
    device = require_device(device)
    h, w, _ = lr.shape
    ph, pw = (bucket[0] - h, bucket[1] - w) if bucket else ((-h) % multiple, (-w) % multiple)
    lrp = np.pad(lr, [(0, ph), (0, pw), (0, 0)], mode="reflect") if (ph or pw) else lr
    x = torch.from_numpy(np.ascontiguousarray(lrp, dtype=np.float32)[None]).to(device)
    return forward_img(x)[0, : h * scale, : w * scale]
