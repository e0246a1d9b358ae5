"""One run of one cell: set-up, the measured window, the check, and the metrics.

Everything that belongs to one model, configuration, traffic mix, cell or metric is a file
found by its name: ``models/<model>.py`` (the configuration's ``"model"``: the program's
model, its reference, what the check compares; ``models/__init__.py``),
``configs/<config>.json``, ``traffic/<traffic>.json``, ``limits/<workload>.json`` (the limits
of the check) and ``metrics/<metric>.py`` (a reader: ``read(run) -> number or None``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import models
from perfbench.core import check, records, serve, trace, traffic, weights

HERE = Path(__file__).resolve().parents[1]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files its names point to."""

    def __init__(self, root: Path):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(HERE / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(HERE / "limits" / f"{workload}.json")

    def metrics(self, workload: str, traced: bool):
        """The metric entries the cell reports: end-to-end ones untraced, per-layer ones
        traced; an entry without ``workloads`` in every cell that reports what it moves."""
        e2e = [m for m in self.bench["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(spec: Spec, workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device=None, log=print, overrides=None):
    """Runs the cell once. Returns (result dict, check rows, every number of the check).
    `device` None means the cards
    (the caller has checked they are there); tests pass "cpu" and small `overrides` of the
    config and mix."""
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    mix = spec.traffic(wl["traffic"])
    limits = spec.limits(workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    dtype_name = cfg["dtype"]
    dtype = DTYPES[dtype_name]
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    model = models.load(cfg["model"])
    split = {}

    t = time.perf_counter()
    split["import_s"] = t - t_start

    def fill(module):
        leaves = weights.plan(module)
        weights.load(module, weights.make(leaves, seed, dev, dtype))
        return leaves

    pipe, leaves = serve.build(model, cfg, dev, dtype, mix, fill)
    group_max = traffic.group_size(mix)
    serve.synchronize(pipe)
    split["weights_s"], t = time.perf_counter() - t, time.perf_counter()

    shapes = traffic.schedule(mix)
    pool = traffic.frames(mix, seed)

    def frame_of(i):
        return pool[i]

    def bucket_of(s):
        return pipe._whole_image_plan(s[1], s[0]) or "tiled"

    sampled = traffic.sample(mix, seed, shapes, group_max, bucket_of)
    split["inputs_s"], t = time.perf_counter() - t, time.perf_counter()

    hooks = serve.Hooks(pipe, model, sampled, traced and dev.type == "cuda")
    serve.warm(pipe, shapes, group_max, frame_of)
    split["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup " + json.dumps({k: round(v, 3) for k, v in split.items()}
                              | {"setup_s": round(setup_s, 3)}))

    prof = None
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        records.reset_program_records()
        prof.start()
    with torch.profiler.record_function(trace.WINDOW):
        win = serve.serve_window(pipe, hooks, shapes, frame_of, seconds, group_max)
    if prof is not None:
        serve.synchronize(pipe)
        prof.stop()
    window_s = win.t1 - win.t0

    devices = [d.index for d in pipe.devices] if dev.type == "cuda" else [None]
    peak = (max(torch.cuda.max_memory_allocated(d) for d in pipe.devices)
            if dev.type == "cuda" else 0)
    timed = {n: hooks.device_ms(n) for n in hooks.events} if traced and dev.type == "cuda" \
        else {}
    forwards = list(hooks.forwards)
    n_devices = pipe.n_devices
    captured, served = hooks.captured, win.outputs
    hooks.remove()
    del pipe, hooks
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference, on the first card, with the weights made again
    t = time.perf_counter()
    ref = models.reference(model, cfg, weights.make(leaves, seed, dev, dtype), dev)
    sampled_frames = {i: pool[i] for i in sampled}
    numbers = check.reference_numbers(ref, model.NUMBERS, cfg["upscale"], sampled_frames,
                                      captured, served, mix)
    del ref, captured
    gc.collect()
    ok, rows = check.judge(numbers, limits)
    checked = sorted(i for i in sampled if i in served)
    log(f"check: {len(checked)} requests {checked} in {time.perf_counter() - t:.1f} s; "
        f"numbers {json.dumps(numbers)}")

    reqs = win.requests
    scale = cfg["upscale"]
    # what the run learned, for the metric readers
    ctx = SimpleNamespace(
        model=model, cfg=cfg, mix=mix, dtype=dtype_name, precision=cfg["precision"],
        window_s=window_s, requests=reqs,
        hr_px=sum(h * w * scale * scale for _, (h, w), _, _ in reqs),
        latencies=[t1 - t0 for _, _, t0, t1 in reqs], dispatch=win.dispatch,
        forwards=forwards, timed=timed, setup_s=setup_s, n_devices=n_devices,
        trace=None)
    if prof is not None:
        names = trace.port_kernel_names(spec.root / "freqfusion_tpu_torch" / "csrc")
        ctx.trace = trace.reduce(prof.profiler.kineto_results.events(), names, devices)
    metrics = {}
    for m in spec.metrics(workload, traced):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else dev.type,
                   "count": n_devices, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and len(checked) > 0), "attempted": len(reqs), "failed": 0,
              "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        tr = ctx.trace
        busy = [tr["busy_s"][d] for d in devices]
        device_info["busy_s"] = float(np.mean(busy))
        device_info["window_s"] = tr["window_s"]
        top = sorted(tr["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows, numbers
