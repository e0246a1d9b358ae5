"""Readings of the check for setting a cell's limits: the program's numbers over many seeds
and the control's, in one process (the kernels are built once), each seed a short run of the
cell at its own load, long enough to serve the frames the check samples.

    python3 perfbench/tools/readings.py --workload ff-bf16.div2k --seconds 20 --first 21 \\
        --seeds 1 2 3 4 5 6 7 8 9 10 11 12 --control-seeds 13 14 15

``--first`` draws the sample among the stream's first frames (21: one cycle of the three
shapes). Prints one JSON line a seed: ``{"seed", "side": "program" | "control", "numbers",
"correct"}`` against the cell's current limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import cell
    from perfbench.tools.control import control
    if not torch.cuda.is_available():
        print("readings are taken on a card", file=sys.stderr)
        return 2
    spec = cell.Spec(ROOT)
    mix = spec.traffic(spec.workload(args.workload)["traffic"])
    overrides = {"traffic": {"sample": {**mix["sample"], "first": args.first}}}
    for seed in args.seeds:
        result, _, numbers = cell.run(spec, args.workload, seed, args.seconds, False,
                                      time.perf_counter(),
                                      log=lambda m: print(m, file=sys.stderr),
                                      overrides=overrides)
        print(json.dumps({"seed": seed, "side": "program", "numbers": numbers,
                          "correct": result["correct"]}), flush=True)
    for seed in args.control_seeds:
        numbers, _, ok = control(spec, args.workload, seed, torch.device("cuda", 0),
                                 overrides=overrides)
        print(json.dumps({"seed": seed, "side": "control", "numbers": numbers,
                          "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
