"""Spreads of the end-to-end metrics over result lines, as the bounds are set from them.

    python3 perfbench/tools/spread.py RESULTS_A.jsonl [RESULTS_B.jsonl ...]

Each file is one set of runs (one JSON result line a run, as ``run.py`` prints it). For each
metric and set: the median and the spread, the distance between the first and third
quartiles of ``statistics.quantiles(values, n=4)`` over the median; then the widest spread
over the sets and five times it, the bound that spread suggests (never under 1%).
"""

import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths):
    sets = []
    for p in paths:
        with open(p) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        widest = 0.0
        for p, s in zip(paths, sets):
            vals = [r["metrics"][name]["value"] for r in s if name in r["metrics"]]
            if len(vals) < 2:
                continue
            sp = spread(vals)
            widest = max(widest, sp)
            print(f"{name:22s} {p}: n={len(vals)} median={statistics.median(vals):.6g} "
                  f"spread={100 * sp:.3f}%")
        print(f"{name:22s} widest {100 * widest:.3f}%  5x {max(1.0, 500 * widest):.2f}%")


if __name__ == "__main__":
    main(sys.argv[1:])
