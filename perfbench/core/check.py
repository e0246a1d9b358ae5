"""The comparison that decides ``correct``: the plain reference recomputes each sampled request
from the same frame and weights, after the window, and every number is held to its limit.

Numbers, each the worst over the sampled requests (and over a tiled frame's chunks):

* each name of the model file's ``NUMBERS`` (``models/<name>.py``: what the model's taps keep
  of each row), by its comparison in ``COMPARE``;
* ``u8``: the mean |program - reference| in levels of the served uint8 image (in the tiled
  cell, of the stitched frame);
* ``u8_exact`` (whole images): the share of served values that differ from the uint8 of the
  program's own output (clamp, rounding, copy to the host, gather, crop): exact, limit 0.

A cell's ``limits/<workload>.json`` names the numbers it compares: each one that separates
the program's readings from its control's (``tools/control.py``), and the exact one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import serving
from perfbench.reference.ops import exact_float32, operand_rounding


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def rel_q999(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.float() - want).abs().flatten()
    k = max(1, math.ceil(0.999 * d.numel()))
    return float(d.kthvalue(k).values / want.abs().max().clamp_min(1e-30))


def mean_levels(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.int16) - want.astype(np.int16)).mean())


#: the comparisons a model file's ``NUMBERS`` name
COMPARE = {"rel_max": rel_max, "rel_q999": rel_q999}


def _row_numbers(cap: dict, ref: dict, row: int, numbers: dict) -> dict:
    """cap: the program's tensors of one row (laid out as the reference's); ref: the
    reference's batched outputs."""
    dev = ref["sr"].device
    return {n: COMPARE[how](cap[n].to(dev), ref[n][row]) for n, how in numbers.items()}


def _worst(acc: dict, nums: dict) -> None:
    for k, v in nums.items():
        acc[k] = max(acc.get(k, 0.0), v)


def serve_reference(ref, s: int, rid, lr: np.ndarray, mix: dict):
    """The reference (of scale `s`) serving one frame as the program serves it: whole at its
    bucket, or as chunks of tiles stitched. Returns ([(key, outputs, row)] of every forward
    row, keyed as the program's hooks key them, and the served HWC uint8 image)."""
    dev = next(ref.parameters()).device
    h, w, _ = lr.shape
    whole = serving.whole_bucket(h, w, mix)
    if whole is not None:
        x = torch.as_tensor(serving.reflect_pad(lr, *whole), device=dev)
        out = ref(x.permute(2, 0, 1)[None])
        sr = out["sr"][0, :, : h * s, : w * s].permute(1, 2, 0)
        return [(rid, out, 0)], serving.to_u8(sr).cpu().numpy()
    tile, ov, tb = mix["tile"], mix["overlap"], mix["tile_batch"]
    chunks, coords, plan = serving.tiles_of(lr, tile, ov, tb)
    rows, srs = [], []
    for c, chunk in enumerate(chunks):
        out = ref(torch.as_tensor(chunk, device=dev).permute(0, 3, 1, 2))
        rows += [((rid, c, j), out, j) for j in range(len(chunk))]
        srs += list(out["sr"].permute(0, 2, 3, 1))
    sr = serving.stitch(srs[: len(coords)], coords, plan, h, w, tile, s, dev)
    return rows, serving.to_u8(sr).cpu().numpy()


def reference_numbers(ref, numbers: dict, s: int, frames: dict, captured: dict, served: dict,
                      mix: dict) -> dict:
    """The numbers of the sampled requests: the model's `numbers` ({name: comparison}) and
    the served image's, at scale `s`. `frames`: id -> HWC float32 LR frame; `captured`:
    the program's images by request id (whole) or (id, chunk, row) (tiled); `served`: id ->
    the program's HWC uint8 output. The reference runs in float32 with TF32 off."""
    worst = {}
    with torch.inference_mode(), exact_float32():
        for rid, lr in sorted(frames.items()):
            if rid not in served:
                continue
            rows, u8 = serve_reference(ref, s, rid, lr, mix)
            for key, out, j in rows:
                if key in captured:
                    _worst(worst, _row_numbers(captured[key], out, j, numbers))
            _worst(worst, {"u8": mean_levels(served[rid], u8)})
            if len(rows) == 1 and rid in captured:   # a whole image: its uint8 stage
                own = serving.to_u8(captured[rid]["sr"].float()[: u8.shape[0], : u8.shape[1]])
                _worst(worst, {"u8_exact": float((own.cpu().numpy() != served[rid]).mean())})
    return worst


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limit held, and every number present."""
    rows = [(n, numbers.get(n), limits[n]) for n in limits]
    ok = all(v is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows


def reference_as_program(ref, numbers: dict, s: int, frames: dict, mix: dict, rounding: str):
    """(captured, served) as the program's hooks and window would hold them, computed by the
    reference at operand `rounding` in the program's place: the control of the check."""
    captured, served = {}, {}
    with torch.inference_mode(), exact_float32(), operand_rounding(rounding):
        for rid, lr in sorted(frames.items()):
            rows, served[rid] = serve_reference(ref, s, rid, lr, mix)
            for key, out, j in rows:
                captured[key] = {n: out[n][j] for n in numbers}
                captured[key]["sr"] = out["sr"][j].permute(1, 2, 0)
    return captured, served
