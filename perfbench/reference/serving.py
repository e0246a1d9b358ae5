"""The reference's serving of an image, as the serving docs of the system under test describe
it, written here and not imported: whole at a 32-px bucket, or as tiles stitched with ramp
weights; and the filling of a reference model from a state dict.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def build(ref: nn.Module, state_dict, device, unserved=()) -> nn.Module:
    """`ref` (made on the meta device) on `device`, every parameter and statistic taken from
    `state_dict` (float32; integer step counters are not read); raises if one is missing, or
    if an entry whose name starts with none of `unserved` is left over."""
    ref = ref.to_empty(device=device)
    want = {k: t for k, t in ref.state_dict().items() if t.is_floating_point()}
    given = {k: v for k, v in state_dict.items() if not k.startswith(tuple(unserved))}
    missing = sorted(set(want) - set(given))
    extra = sorted(set(given) - set(want))
    if missing or extra:
        raise KeyError(f"reference and state dict differ: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    for k, t in want.items():
        src = given[k]
        if src.shape != t.shape:
            raise ValueError(f"{k}: {tuple(src.shape)} for {tuple(t.shape)}")
        t.copy_(src.to(device=device, dtype=t.dtype))
    return ref.eval()


def bucket(h: int, w: int, step: int = 32, least: int = 64):
    """The whole-image bucket of an h x w frame: each side at least `least`, rounded up to
    a multiple of `step`."""
    return -(-max(h, least) // step) * step, -(-max(w, least) // step) * step


def whole_bucket(h: int, w: int, mix: dict):
    """The bucket an h x w frame is served whole at, or None where it takes tiles: past the
    mix's whole-image budget (``whole_image_px``, 280,000 px by default), or where a side's
    padding would reach the frame's own size (reflection cannot fill it)."""
    hp, wp = bucket(h, w)
    if hp * wp <= mix.get("whole_image_px", 280000) and hp - h < h and wp - w < w:
        return hp, wp
    return None


def reflect_pad(lr: np.ndarray, hp: int, wp: int) -> np.ndarray:
    """HWC float image reflect-padded at the bottom and right to hp x wp."""
    return np.pad(lr, [(0, hp - lr.shape[0]), (0, wp - lr.shape[1]), (0, 0)], mode="reflect")


def to_u8(sr: torch.Tensor) -> torch.Tensor:
    return torch.round(sr.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def tile_starts(size: int, tile: int, count: int):
    if count <= 1:
        return [0]
    return [round(i * (size - tile) / (count - 1)) for i in range(count)]


def tile_plan(h: int, w: int, tile: int, overlap: int, batch: int):
    """(row starts, column starts, overlap along rows, overlap along columns): the grid of
    tiles at stride tile - overlap that covers the frame, or one more row or column where
    that makes the tile count fill whole batches, whichever runs the fewest forwards (then
    the fewest tiles); the starts spread evenly, the overlap is what the widest step leaves."""
    stride = tile - overlap

    def grid(size):
        if size <= tile:
            return 1
        n = len(range(0, size - tile + 1, stride))
        return n + 1 if (n - 1) * stride + tile < size else n

    nh0, nw0 = grid(h), grid(w)
    best = None
    for nh in (nh0, nh0 + 1):
        for nw in (nw0, nw0 + 1):
            if (nh > 1 and nh0 == 1) or (nw > 1 and nw0 == 1):
                continue
            key = (-(-nh * nw // batch) * batch, nh * nw)
            if best is None or key < best[0]:
                best = (key, nh, nw)
    ys, xs = tile_starts(h, tile, best[1]), tile_starts(w, tile, best[2])

    def eff(starts):
        return 0 if len(starts) < 2 else tile - max(b - a for a, b in zip(starts, starts[1:]))

    return ys, xs, eff(ys), eff(xs)


def ramp(size: int, overlap: int, lo: bool, hi: bool) -> np.ndarray:
    """Stitch weight along one side of a tile: 1 inside, rising from 1/(overlap+1) over the
    overlap on each side that has a neighbour."""
    wgt = np.ones(size, dtype=np.float32)
    if overlap > 0:
        r = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
        if lo:
            wgt[:overlap] = r
        if hi:
            wgt[-overlap:] = r[::-1]
    return wgt


def tiles_of(lr: np.ndarray, tile: int, overlap: int, batch: int):
    """The frame's tiles in serving order, as chunks of `batch` HWC tiles (the last chunk
    filled by repeating its last tile), with the plan: (chunks, coords, plan)."""
    h, w, _ = lr.shape
    ys, xs, ov_y, ov_x = tile_plan(h, w, tile, overlap, batch)
    coords = [(y, x) for y in ys for x in xs]
    chunks = []
    for i in range(0, len(coords), batch):
        part = [lr[y:y + tile, x:x + tile] for y, x in coords[i:i + batch]]
        part += [part[-1]] * (batch - len(part))
        chunks.append(np.stack(part))
    return chunks, coords, (ys, xs, ov_y, ov_x)


def stitch(srs, coords, plan, h, w, tile, scale, device):
    """Ramp-weighted sum of the SR tiles [th, tw, 3] (in `coords` order), normalised."""
    ys, xs, ov_y, ov_x = plan
    t = tile * scale
    out = torch.zeros((h * scale, w * scale, 3), dtype=torch.float64, device=device)
    acc = torch.zeros((h * scale, w * scale, 1), dtype=torch.float64, device=device)
    for sr, (y, x) in zip(srs, coords):
        wy = ramp(t, ov_y * scale, y > 0, y + tile < h)
        wx = ramp(t, ov_x * scale, x > 0, x + tile < w)
        wgt = torch.as_tensor(np.outer(wy, wx)[:, :, None], device=device, dtype=torch.float64)
        out[y * scale:y * scale + t, x * scale:x * scale + t] += sr.double() * wgt
        acc[y * scale:y * scale + t, x * scale:x * scale + t] += wgt
    return (out / acc).float()
