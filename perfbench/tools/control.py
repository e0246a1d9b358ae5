"""The control of the check: the plain reference in the program's place, its products rounded
to the next precision below the configuration's (``core/precision.py``: TF32 for float32 at
``highest``, the 3-bit mantissa of fp8 e4m3 for bf16 products: bfloat16, and float32 at
``default``), judged by the cell's own numbers and limits on the requests a run of that seed
would check. A correct check fails it.

    python3 perfbench/tools/control.py --workload ff-f32.div2k --seeds 11 12 13

Prints one JSON line a seed with the numbers, and whether the limits failed them. Needs a
card; the program is built only to read its parameter plan (names, shapes, init ranges).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def control(spec, workload: str, seed: int, device, overrides=None, rounding=None):
    """(numbers, rows, correct) of the control for `seed`."""
    import torch

    from perfbench import models
    from perfbench.core import cell, check, traffic, weights
    from perfbench.core.precision import numerics
    from perfbench.reference import serving

    wl = spec.workload(workload)
    cfg, mix = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    model = models.load(cfg["model"])
    dtype = cell.DTYPES[cfg["dtype"]]
    leaves = weights.plan(model.build(cfg, device))
    shapes = traffic.schedule(mix)

    def bucket_of(s):
        return serving.whole_bucket(s[1], s[0], mix) or "tiled"

    sampled = traffic.sample(mix, seed, shapes, traffic.group_size(mix), bucket_of)
    frames = {i: traffic.frame(seed, i, shapes[i]) for i in sampled}
    ref = models.reference(model, cfg, weights.make(leaves, seed, device, dtype), device)
    s = cfg["upscale"]
    rounding = rounding or numerics(cfg["dtype"], cfg["precision"]).control
    captured, served = check.reference_as_program(ref, model.NUMBERS, s, frames, mix, rounding)
    numbers = check.reference_numbers(ref, model.NUMBERS, s, frames, captured, served, mix)
    ok, rows = check.judge(numbers, spec.limits(workload))
    return numbers, rows, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import cell
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    spec = cell.Spec(ROOT)
    for seed in args.seeds:
        numbers, rows, ok = control(spec, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": numbers,
                          "passes_limits": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
