"""IQA evaluator of the port. Twin of the repository's root ``eval.py``.

    python -m freqfusion_tpu_torch.cli.eval --output <SR PNG dir> --target <GT PNG dir>
        [--border 4] [--workers N] [--csv-dir DIR] [--no-niqe] [--niqe-corpus 20]
        [--device cuda]

Writes ``{parent}--{folder}.csv`` and ``.txt`` beside the output directory (or in
``--csv-dir``): per image PSNR and SSIM (Y channel, border 4), NIQE (``utils/niqe.py``, its
pristine model fit from up to ``--niqe-corpus`` ground-truth images unless
``model_zoo/niqe_pristine.npz`` exists) and each live tower column (LPIPS, DISTS, CLIP-IQA,
MUSIQ, MANIQA: live when their ``FREQFUSION_*`` variables name checkpoints, see
``utils/perceptual_metrics.py``), then a MEAN row; the ``.txt`` holds the means, NaN for
the columns that are not live, and ``total_score`` = (1 - LPIPS) + (1 - DISTS) + CLIPIQA +
MANIQA + MUSIQ / 100 + max(0, (10 - NIQE) / 10) over the available terms.

The towers are built once and run on ``--device`` (the card unless ``--device cpu`` is
given; without a card the default raises) in this process. A pool of ``--workers``
processes, started with ``spawn`` (a forked child of a process that holds a CUDA context
is not usable), does the host work meanwhile: PNG decode, PSNR / SSIM and NIQE. Rows stay
in the order of the sorted file names. A script that calls ``main`` runs its body under
``if __name__ == "__main__":``: the spawned workers import the caller's main module.
"""

from __future__ import annotations

import argparse
import csv
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

PERCEPTUAL_COLUMNS = ("lpips", "dists", "niqe", "musiq", "maniqa", "clipiqa")


def _decode_pair(out_path: str, tgt_path: str):
    from PIL import Image

    out = np.asarray(Image.open(out_path).convert("RGB"))
    tgt = Image.open(tgt_path).convert("RGB")
    if tgt.size != (out.shape[1], out.shape[0]):   # resized to the output's size
        tgt = tgt.resize((out.shape[1], out.shape[0]))
    return out, np.asarray(tgt)


def _host_row(job):
    """(name, PSNR, SSIM, NIQE) of one pair: the pool's numpy work."""
    from ..utils.metrics import psnr_ssim_files
    from ..utils.niqe import niqe

    out_path, tgt_path, border, pristine = job
    out, tgt = _decode_pair(out_path, tgt_path)
    p, s = psnr_ssim_files(out, tgt, border)
    nq = niqe(out, pristine) if pristine is not None else float("nan")
    return os.path.basename(out_path), p, s, nq


def _pristine(target_dir: str, tgts, corpus: int):
    from PIL import Image

    from ..utils.niqe import fit_pristine, load_pristine

    pristine = load_pristine()
    if pristine is None:
        images = [np.asarray(Image.open(os.path.join(target_dir, t)).convert("RGB"))
                  for t in tgts[:corpus]]
        try:
            pristine = fit_pristine(images)
        except ValueError:
            pristine = None   # images too small: the column stays NaN
    return pristine


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Parses `argv` (the process's arguments if None), writes the CSV and TXT, and returns
    {"means": {column: mean}, "seconds": {"total": s, "host": s, column: s}, "stem": path}:
    the seconds of the whole run, of the host work not hidden behind the towers, and of
    each tower over all images."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", required=True, help="SR output PNG dir")
    ap.add_argument("--target", required=True, help="ground-truth PNG dir")
    ap.add_argument("--border", type=int, default=4)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--csv-dir", default=None,
                    help="where to write the csv/txt (default: beside the output dir)")
    ap.add_argument("--no-niqe", action="store_true", help="skip the NIQE column")
    ap.add_argument("--niqe-corpus", type=int, default=20,
                    help="ground-truth images fit for the pristine NIQE model when "
                         "model_zoo/niqe_pristine.npz is absent")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the towers; the default raises without a card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    from ..infer.tiling import require_device
    from ..utils import perceptual_metrics as pm

    device = require_device(args.device)
    outs = sorted(f for f in os.listdir(args.output) if f.lower().endswith(".png"))
    tgts = sorted(f for f in os.listdir(args.target) if f.lower().endswith(".png"))
    if len(outs) != len(tgts):
        raise ValueError(f"count mismatch: {len(outs)} outputs vs {len(tgts)} targets")
    pristine = None if args.no_niqe else _pristine(args.target, tgts, args.niqe_corpus)
    pairs = [(os.path.join(args.output, o), os.path.join(args.target, t))
             for o, t in zip(outs, tgts)]
    jobs = [(o, t, args.border, pristine) for o, t in pairs]

    pool = None
    if args.workers > 1 and len(jobs) > 1:
        pool = ProcessPoolExecutor(min(args.workers, len(jobs)),
                                   mp_context=multiprocessing.get_context("spawn"))
    try:
        pending = pool.map(_host_row, jobs) if pool is not None else None
        towers = pm.load_native_towers(device) if pm.configured_tower_columns() else {}
        seconds = dict.fromkeys(towers, 0.0)
        fr_cols = {k: [] for k in towers}
        if towers:
            for out_path, tgt_path in pairs:
                out, tgt = _decode_pair(out_path, tgt_path)
                for k, fn in towers.items():
                    t = time.perf_counter()
                    fr_cols[k].append(fn(out, tgt))   # a float: the device has finished
                    seconds[k] += time.perf_counter() - t
        t_host = time.perf_counter()
        rows = list(pending) if pending is not None else [_host_row(j) for j in jobs]
        seconds["host"] = time.perf_counter() - t_host
    finally:
        if pool is not None:
            pool.shutdown()

    psnr_mean = float(np.mean([r[1] for r in rows if math.isfinite(r[1])]))
    ssim_mean = float(np.mean([r[2] for r in rows]))
    niqe_vals = [r[3] for r in rows if math.isfinite(r[3])]
    means = {"psnr": psnr_mean, "ssim": ssim_mean,
             **{k: float("nan") for k in PERCEPTUAL_COLUMNS}}
    if niqe_vals:
        means["niqe"] = float(np.mean(niqe_vals))
    for k, vals in fr_cols.items():
        means[k] = float(np.mean(vals))
    means["total_score"] = pm.PerceptualEvaluator.perceptual_score(means)

    parent = os.path.basename(os.path.dirname(os.path.abspath(args.output)))
    folder = os.path.basename(os.path.abspath(args.output))
    csv_dir = args.csv_dir or os.path.dirname(os.path.abspath(args.output))
    stem = os.path.join(csv_dir, f"{parent}--{folder}")
    live = sorted(fr_cols)
    with open(stem + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "psnr", "ssim", "niqe"] + live)
        for i, (name, p, s, nq) in enumerate(rows):
            w.writerow([name, f"{p:.4f}", f"{s:.5f}", f"{nq:.4f}"]
                       + [f"{fr_cols[k][i]:.5f}" for k in live])
        w.writerow(["MEAN", f"{psnr_mean:.4f}", f"{ssim_mean:.5f}", f"{means['niqe']:.4f}"]
                   + [f"{means[k]:.5f}" for k in live])
    with open(stem + ".txt", "w") as f:
        for k, v in means.items():
            f.write(f"{k}: {v}\n")
    seconds["total"] = time.perf_counter() - t0
    print(f"PSNR {psnr_mean:.4f} dB  SSIM {ssim_mean:.5f}  (n={len(rows)}) -> {stem}.csv")
    print("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return {"means": means, "seconds": seconds, "stem": stem}


if __name__ == "__main__":
    main()
