"""The program's recorder (``freqfusion_tpu_torch/utils/profiling.py``) on the card, as the
per-layer readers ``kernels.launched_roofline``, ``kernels.weights_made``,
``serve.upload_wait_ms`` and ``serve.enqueue_ms`` read it: one whole forward of each served
configuration at 512x352 under a profiler counts exactly the launches the model file lists,
family by family, with the model file's bound; the warm forward makes no weight planes or
fragments (at bf16 it makes the f32 copies of the tensors the model derives from its bf16
parameters inside the forward, which the cache cannot keep: PERF.md names them); and every
``ff.*`` record starts within 100 us of its range in the profiler's trace. B13 and B14, which
no served cell launches, are counted with their shapes too, and bounded by the model file's
``BOUNDS``. A traced short window of every cell reads every metric the cell reports.

    python -m pytest perfbench/tests/test_pb_tracing.py -m cuda -q -s
"""

import importlib.util
import json
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT
from perfbench import models
from perfbench.core import bounds, cell

pytestmark = pytest.mark.cuda
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled(fn, device):
    """(the records fn left, the trace's ff.* host events), fn run under a CPU and CUDA
    profile that ends with the card idle."""
    from freqfusion_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("ff.") and str(e.device_type()).endswith("CPU")]
    rec = profiling.records()
    return rec, events


def _same_clock(rec, events):
    """Each record's start within 100 us of its range's, name by name in order."""
    assert len(events) == len(rec["spans"])
    worst = 0
    for name in {s.name for s in rec["spans"]}:
        mine = sorted((s for s in rec["spans"] if s.name == name), key=lambda s: s.start_ns)
        evs = sorted((e for e in events if e.name() == name), key=lambda e: e.start_ns())
        assert len(mine) == len(evs), name
        for s, e in zip(mine, evs):
            worst = max(worst, abs(s.start_ns - e.start_ns()))
    assert worst < 100_000, worst
    return worst


@pytest.mark.parametrize("config", ["freqfusion-f32", "freqfusion-bf16",
                                    "freqfusion-default"])
def test_one_forward_counts_the_model_files_launches(card, config):
    from freqfusion_tpu_torch.infer.io import InferencePipeline

    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())
    model = models.load(cfg["model"])
    pipe = InferencePipeline(model.build(cfg, card), device=card, dtype=DTYPES[cfg["dtype"]],
                             precision=cfg["precision"])
    lr = np.random.default_rng(0).uniform(size=(352, 512, 3)).astype(np.float32)

    def serve():
        pipe.materialize_u8(pipe.dispatch_batch_u8([lr], (352, 512)))

    serve()   # warm: the kernels built, the weights laid out
    rec, events = _profiled(serve, card)
    run = SimpleNamespace(trace={"port_s": 1.0}, dtype=cfg["dtype"])
    made = _reader("kernels.weights_made").read(run)
    upload = _reader("serve.upload_wait_ms").read(run)
    enqueue = _reader("serve.enqueue_ms").read(run)
    roofline = _reader("kernels.launched_roofline")
    launches = rec["counts"]["launches"]
    families = {**roofline.FAMILIES, **model.BOUNDS}
    counted = Counter()
    for (wrapper, _), n in launches.items():
        counted[families[wrapper].__name__] += n
    listed = model.launches(cfg, 1, 352, 512)
    least = bounds.forward_bound(model, cfg, 1, 352, 512, cfg["dtype"], cfg["precision"])
    worst = _same_clock(rec, events)
    dispatch = next(s for s in rec["spans"] if s.name == "ff.dispatch")
    split = {s.name: (s.end_ns - s.start_ns) / 1e6 for s in rec["spans"]
             if s.parent == dispatch.id}
    print(json.dumps({"config": config, "weights_made": made,
                      "weights_made_kinds": rec["counts"].get("weights_made", {}),
                      "upload_ms": upload,
                      "enqueue_ms": enqueue, "dispatch_ms": (dispatch.end_ns
                                                             - dispatch.start_ns) / 1e6,
                      "split_ms": split, "worst_clock_us": worst / 1e3,
                      "launches": dict(counted)}))
    assert counted == Counter(f for f, _ in listed)
    assert roofline.least_s(launches, cfg["dtype"], cfg["precision"],
                            model.BOUNDS) == pytest.approx(least, rel=1e-9)
    kinds = rec["counts"].get("weights_made", {})
    if cfg["dtype"] == "float32":
        assert made == 0
    else:
        assert set(kinds) == {"f32"}, kinds


def test_b13_and_b14_count_their_shapes(card):
    """B13 and B14 launched once each, shifted, at a DAT branch's and a HAT width: counted
    with the shapes their bounds take."""
    from freqfusion_tpu_torch.ops import windows
    from freqfusion_tpu_torch.ops.kernels import wattn

    gen = torch.Generator(card).manual_seed(0)

    def r(*shape, std=1.0):
        return std * torch.randn(*shape, generator=gen, device=card)

    hs, ws, heads = 8, 32, 3
    mask = torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).to(card)
    q, k, v = r(1, 32, 64, 90), r(1, 32, 64, 90), r(1, 32, 64, 90)
    c, wh = 180, 12
    x = r(1, 48, 72, c)
    wargs = (x, r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1), r(c, c, std=c ** -0.5),
             r(c, std=0.1), r(6, wh * wh, wh * wh, std=0.5), None, (wh, wh), 6)

    def launch():
        with torch.no_grad():
            wattn.fused_window_attention_qkv(q, k, v, r(heads, hs * ws, hs * ws, std=0.5), mask,
                                             (hs, ws), heads)
            wattn.fused_window_attention(*wargs)

    rec, _ = _profiled(launch, card)
    want = {("fused_window_attention_qkv", (1, 32, 64, 90, heads, hs, ws, True)): 1,
            ("fused_window_attention", (1, 48, 72, c, 6, wh, wh, False)): 1}
    assert rec["counts"]["launches"] == want
    roofline = _reader("kernels.launched_roofline")
    assert roofline.least_s(want, "float32") is None
    b13_b14 = models.load("freqfusion_sr").BOUNDS
    assert roofline.least_s(want, "float32", model_bounds=b13_b14) > 0


@pytest.mark.parametrize("workload", [w["name"] for w in cell.Spec(ROOT).bench["workloads"]])
def test_a_traced_window_reads_every_metric(card, workload):
    """A traced window of a few seconds of the cell at its own size: every per-layer metric
    the cell reports reads a number, and the trace saw the card busy."""
    spec = cell.Spec(ROOT)
    result, _, _ = cell.run(spec, workload, 4100000001, 3.0, True, time.perf_counter(),
                            log=lambda m: None)
    want = {m["name"] for m in spec.metrics(workload, True)}
    print(json.dumps({"workload": workload, "metrics": result["metrics"],
                      "device": result["device"], "correct": result["correct"]}))
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        assert isinstance(m["value"], (int, float)) and m["value"] >= 0, name
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    # the window's own records only, though this process served windows before
    metrics = {k: m["value"] for k, m in result["metrics"].items()}
    assert metrics["kernels.launched_roofline"] == pytest.approx(
        metrics["kernels.port_roofline"], rel=1e-3)
    if spec.config(spec.workload(workload)["config"])["dtype"] == "float32":
        assert metrics["kernels.weights_made"] == 0
