"""Percent: model FLOPs of the requests served in the window (``FlopCounterMode`` on the plain
reference at each served shape: a request's bucket, or its chunks of tiles) over the window's
seconds, over the dense tensor-core peak of the cell's numerics (``core/precision.py``: its
dtype and precision) times the cards."""

import json

from perfbench.core.flops import forward_flops
from perfbench.core.precision import numerics
from perfbench.reference.serving import tile_plan, whole_bucket


def read(run):
    if run.trace is None or not run.requests:
        return None
    cfg = json.dumps(run.cfg, sort_keys=True)
    mix = run.mix
    total = 0
    for _, (h, w), _, _ in run.requests:
        whole = whole_bucket(h, w, mix)
        if whole is not None:
            total += forward_flops(cfg, 1, *whole)
        else:
            tile, tb = mix["tile"], mix["tile_batch"]
            ys, xs, _, _ = tile_plan(h, w, tile, mix["overlap"], tb)
            chunks = -(-len(ys) * len(xs) // tb)
            total += chunks * forward_flops(cfg, tb, tile, tile)
    peak = numerics(run.dtype, run.cfg["precision"]).tensor_core * run.n_devices
    return 100.0 * total / run.window_s / peak
