"""NTIRE-style submission runner of the port. Twin of the repository's root ``test.py``.

    python -m freqfusion_tpu_torch.cli.test --input <LR PNG directory> [--save_dir results]
        [--split valid|test] [--model_id 29] [--device cuda]
        [--precision highest|high|default]
        [--dtype float32|bfloat16] [--n_devices N]

Selects the team model, times the whole ``model_func`` call (model build, checkpoint
loading, PNG decode and encode included) on the host clock after the device has finished,
and writes the SR PNGs to ``<save_dir>/<model_name>/<split>`` and the runtime to
``<save_dir>/results.json``. The model directory is ``$FREQFUSION_MODEL_DIR`` or
``model_zoo/team29``. The device is the card; without one the default raises. Without
``--precision`` or ``--dtype`` the model reads ``FREQFUSION_PRECISION`` and
``FREQFUSION_DTYPE`` (and the JAX ``main``'s other switches: ``infer/io.py:serving_options``).
``--n_devices`` is the number of cards that serve together, one replica a card (default:
every card present).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import torch

MODEL_NAME = "29_FreqFusion_torch"


def select_model(model_id: int):
    if model_id == 29:
        from ..infer.io import main as model_func
        model_dir = os.environ.get("FREQFUSION_MODEL_DIR", "model_zoo/team29")
        return model_func, model_dir, MODEL_NAME
    raise ValueError(f"unknown model id {model_id}")


def run(model_func, model_dir: str, input_path: str, output_path: str, device: str,
        **model_kwargs) -> float:
    """Milliseconds of the whole `model_func` call, the device's work included."""
    t0 = time.time()
    n = model_func(model_dir, input_path, output_path, device, **model_kwargs)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    elapsed = (time.time() - t0) * 1000.0
    print(f"------> Runtime (including IO) of {n} images: {elapsed:.1f} ms "
          f"({elapsed / max(n, 1):.1f} ms/image)")
    return elapsed


def main(argv: Optional[Sequence[str]] = None, **model_kwargs) -> float:
    """Parses `argv` (the process's arguments if None) and runs the model; `model_kwargs`
    go to ``model_func`` (``expert_kwargs=``, ``tile=``, ...: a caller's way to a smaller
    model or another tiling). Returns the runtime in milliseconds."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model_id", type=int, default=29)
    ap.add_argument("--input", type=str, required=True, help="LR PNG directory")
    ap.add_argument("--save_dir", type=str, default="results")
    ap.add_argument("--split", type=str, default="valid", choices=["valid", "test"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the default raises without a card")
    ap.add_argument("--precision", type=str, default=None,
                    choices=["highest", "high", "default"],
                    help="highest = f32, high = TF32 allowed, default = the kernels' matmul "
                         "operands in bf16 on f32 storage, TF32 allowed (default: "
                         "$FREQFUSION_PRECISION, else highest)")
    ap.add_argument("--dtype", type=str, default=None, choices=["float32", "bfloat16"],
                    help="serving dtype (default: $FREQFUSION_DTYPE, else float32)")
    ap.add_argument("--n_devices", type=int, default=None,
                    help="cards serving together, one replica each (default: every card)")
    args = ap.parse_args(argv)

    model_func, model_dir, name = select_model(args.model_id)
    out_dir = os.path.join(args.save_dir, name, args.split)
    for k in ("precision", "dtype", "n_devices"):
        if getattr(args, k) is not None:
            model_kwargs.setdefault(k, getattr(args, k))
    elapsed = run(model_func, model_dir, args.input, out_dir, args.device, **model_kwargs)

    results_path = os.path.join(args.save_dir, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    results[name] = {"runtime_ms": elapsed, "split": args.split}
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2)
    return elapsed


if __name__ == "__main__":
    main()
