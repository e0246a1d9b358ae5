"""Every reader of the cells measured before configurations named their precision, given one
fixed recorded run of each of those cells, reads what the readers read then
(``recorded_readings.json``, written by those readers from the same runs); and each of those
cells reports the same set of metrics. The run is made up, not measured: its requests, forwards,
device times, trace and program records are fixed numbers in the cell's own shapes, so that the
check covers every reader's arithmetic, the model file's launches and the precision's peaks."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from conftest import ROOT
from perfbench import models
from perfbench.core import cell, traffic
from perfbench.reference import serving

SPEC = cell.Spec(ROOT)
READINGS = json.loads((Path(__file__).parent / "recorded_readings.json").read_text())

#: launches of one recorded run, as the program's ``launches`` counter keys them
LAUNCHES = {
    ("cab_chain", (1, 352, 512, 180, 60)): 72,
    ("fused_hab_block", (1, 352, 512, 180, 360, 6, 16, True)): 36,
    ("fused_band_mha", (1, 352, 512, 9, 64, 4)): 1,
    ("fused_window_attention_qkv", (1, 352, 512, 90, 3, 8, 32, True)): 36,
    ("fused_window_attention", (1, 352, 512, 180, 6, 16, 16, False)): 12,
}


def recorded_run(workload: str, profiling):
    """(run, records) of `workload`: the reader's ``run`` of a fixed window of the cell's
    first frames, and the program's records of it (``profiling.Span`` a span)."""
    wl = SPEC.workload(workload)
    cfg, mix = SPEC.config(wl["config"]), SPEC.traffic(wl["traffic"])
    s = cfg["upscale"]
    shapes = traffic.schedule(mix)[:40]
    requests, forwards, dispatch, spans = [], [], [], []
    t, ns = 0.0, 1_000_000

    def span(name, start, end, parent, request, **attrs):
        spans.append(profiling.Span(name, start, end, len(spans) + 1, parent, request, 1, attrs))
        return len(spans)

    for i, (w, h) in enumerate(shapes):
        whole = serving.whole_bucket(h, w, mix)
        start = int(t * 1e9)
        if whole is not None:
            dur = 1.05 + 0.013 * (i % 7)
            forwards.append((1, *whole))
            dispatch.append((0.9 * dur, 1))
            d = span("ff.dispatch", start, start + int(0.9 * dur * 1e9), None, i, images=1)
            span("ff.upload", start + ns, start + (5 + i % 3) * ns, d, i)
            span("ff.forward", start + 6 * ns, start + (900 + i) * ns, d, i, replica=0)
        else:
            tile, tb = mix["tile"], mix["tile_batch"]
            ys, xs, _, _ = serving.tile_plan(h, w, tile, mix["overlap"], tb)
            chunks = -(-len(ys) * len(xs) // tb)
            dur = 7.2 + 0.04 * i
            forwards += [(tb, tile, tile)] * chunks
            f = span("ff.tiled", start, start + int(dur * 1e9), None, i)
            span("ff.upload", start + ns, start + 3 * ns, f, i)
            for c in range(chunks):
                at = start + (4 + 600 * c) * ns
                k = span("ff.chunk", at, at + 590 * ns, f, i, chunk=c)
                span("ff.forward", at + ns, at + (580 + c) * ns, k, i, replica=0)
        requests.append((i, (h, w), t, t + dur))
        t += dur
    lr_px = sum(b * h * w for b, h, w in forwards)
    rec = {"spans": spans,
           "counts": {"launches": dict(LAUNCHES),
                      "weights_made": {"f32": 257 * len(forwards)} if cfg["dtype"] == "bfloat16"
                      else {}}}
    trace = {"window_s": t, "busy_s": {0: 0.981 * t},
             "kernel_s": {"xqkv_attention_kernel": 0.2 * t, "cutlass_gemm": 0.3 * t},
             "port_s": 0.67 * t, "device_s": 0.96 * t, "idle_gaps": [["nothing traced", 0.004]]}
    run = SimpleNamespace(
        model=models.load(cfg["model"]), cfg=cfg, mix=mix, dtype=cfg["dtype"],
        precision=cfg["precision"], window_s=t, requests=requests,
        hr_px=sum(h * w * s * s for _, (h, w), _, _ in requests),
        latencies=[t1 - t0 + 0.01 * math.sin(i) for i, _, t0, t1 in requests],
        dispatch=dispatch, forwards=forwards,
        timed={"hat": (0.31 * lr_px / 1e3, lr_px), "dat": (0.14 * lr_px / 1e3, lr_px),
               "head": (0.05 * lr_px / 1e3, lr_px)},
        setup_s=16.25, n_devices=1, trace=trace)
    return run, rec


def readings(workload: str, profiling, monkeypatch) -> dict:
    """{metric: value} of every reader the cell reports, traced and untraced, on its
    recorded run."""
    run, rec = recorded_run(workload, profiling)
    monkeypatch.setattr(profiling, "records", lambda: rec)
    names = [m["name"] for traced in (False, True) for m in SPEC.metrics(workload, traced)]
    return {n: cell.reader(n)(run) for n in names}


@pytest.mark.parametrize("workload", sorted(READINGS))
def test_readers_read_as_before(workload, monkeypatch):
    from freqfusion_tpu_torch.utils import profiling

    got = readings(workload, profiling, monkeypatch)
    want = READINGS[workload]
    assert set(got) == set(want)
    for name, value in want.items():
        assert value is not None and got[name] == pytest.approx(value, rel=1e-12), name
