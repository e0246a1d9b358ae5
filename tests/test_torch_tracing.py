"""The port's recorder (``utils/profiling.py``): the spans of the serving path, the launch and
weight-cache counters, the benchmark's four readers of them, and the kernel library's one
build. A tiny FreqFusionSR on the CPU; the card's half is ``perfbench/tests/test_pb_tracing.py``.
"""

import importlib.util
import stat
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from freqfusion_tpu_torch.infer.io import InferencePipeline
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig
from freqfusion_tpu_torch.ops.kernels import _build, _mma
from freqfusion_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
EXPERTS = dict(
    hat_kwargs=dict(embed_dim=24, depths=(1,), num_heads=(4,), window=8, compress=3,
                    squeeze=6, conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16),
    dat_kwargs=dict(embed_dim=32, depths=(2,), num_heads=(4,), split_size=(4, 16),
                    expansion=2.0),
    nafnet_kwargs=dict(width=8, middle_blk_num=1, enc_blk_nums=(1,), dec_blk_nums=(1,)))
HEAD = dict(fusion_dim=16, num_heads=2, refine_depth=1, refine_channels=8, block_size=8)
DISPATCH_CHILDREN = {"ff.pad", "ff.upload", "ff.forward", "ff.to_u8", "ff.host_copy"}
EXPERT_SPANS = {"ff.hat", "ff.dat", "ff.nafnet", "ff.head"}


def _model():
    torch.manual_seed(0)
    return FreqFusionSR(FusionConfig(**HEAD), **EXPERTS).eval()


@pytest.fixture(scope="module")
def pipe():
    return InferencePipeline(_model(), "cpu", tile=32, overlap=8, tile_batch=2)


def _frames(n, h=40, w=50, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(h, w, 3)).astype(np.float32) for _ in range(n)]


def _profiled(fn):
    """(fn's result, the records it left, the profiler's host events named ff.*)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("ff.")]
    rec = profiling.records()
    profiling.reset()
    return out, rec, events


def _serve(pipe, frames):
    return [pipe.materialize_u8(pipe.dispatch_batch_u8([f])) for f in frames]


def _children(rec, parent):
    return [s for s in rec["spans"] if s.parent == parent.id]


def _only(rec, name):
    found = [s for s in rec["spans"] if s.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nothing_is_recorded_without_a_profiler(pipe):
    """A served window, a tiled frame, a launch count and a weight-cache miss, with no
    profiler on: no record; the launches dicts count as they always did."""
    profiling.reset()
    _serve(pipe, _frames(3))
    pipe.run_tiled_u8(_frames(1, 40, 50)[0])
    counts = {"k": 0}
    _build.count(counts, "k", (1, 2))
    _mma.planes(torch.randn(8, 8), 8, 8)
    assert counts == {"k": 1}
    assert profiling.records() == {"spans": [], "counts": {}}


def test_dispatch_spans_form_the_tree(pipe):
    """Each dispatch is one request: ff.dispatch with its five children, the experts and the
    head under ff.forward, and ff.materialize (a root, later) under the same request."""
    frames = _frames(2, seed=1)
    _serve(pipe, frames[:1])   # warm
    outs, rec, _ = _profiled(lambda: _serve(pipe, frames))
    want = _serve(pipe, frames)
    for a, b in zip(outs, want):   # what the handle's caller reads is unchanged
        np.testing.assert_array_equal(a[0], b[0])
    dispatches = [s for s in rec["spans"] if s.name == "ff.dispatch"]
    assert len(dispatches) == 2 and len({d.request for d in dispatches}) == 2
    for d in dispatches:
        assert d.parent is None and d.attrs["images"] == 1
        kids = _children(rec, d)
        assert sorted(k.name for k in kids) == sorted(DISPATCH_CHILDREN)
        forward = next(k for k in kids if k.name == "ff.forward")
        assert forward.attrs == {"replica": 0}
        assert {s.name for s in _children(rec, forward)} == EXPERT_SPANS
        mine = [s for s in rec["spans"] if s.request == d.request]
        assert len(mine) == 1 + len(DISPATCH_CHILDREN) + len(EXPERT_SPANS) + 1
        mat = next(s for s in mine if s.name == "ff.materialize")
        assert mat.parent is None and mat.start_ns >= d.end_ns
        for s in mine:
            assert d.start_ns <= s.start_ns <= s.end_ns and s.thread == d.thread
            if s.name != "ff.materialize":
                assert s.end_ns <= d.end_ns


def test_tiled_spans_form_the_tree(pipe):
    """A tiled frame of 4 tiles in 2 chunks is one request: ff.tiled > ff.upload, one
    ff.chunk a chunk (each holding its ff.forward), ff.normalize."""
    lr = _frames(1, 40, 50, seed=2)[0]
    out, rec, _ = _profiled(lambda: pipe.run_tiled_u8(lr))
    np.testing.assert_array_equal(out, pipe.run_tiled_u8(lr))
    tiled = _only(rec, "ff.tiled")
    assert tiled.parent is None
    kids = sorted(_children(rec, tiled), key=lambda s: s.start_ns)
    assert [k.name for k in kids] == ["ff.upload", "ff.chunk", "ff.chunk", "ff.normalize"]
    assert [k.attrs.get("chunk") for k in kids[1:3]] == [0, 1]
    for chunk in kids[1:3]:
        assert [s.name for s in _children(rec, chunk)] == ["ff.forward"]
    assert {s.request for s in rec["spans"]} == {tiled.request}


def test_replica_spans_carry_their_parent():
    """On 2 CPU replicas each thread's upload and forward sit under the dispatch, in its
    request, with their replica index; the gather follows in the caller's thread."""
    two = InferencePipeline(_model(), "cpu", n_devices=2)
    frames = _frames(2, seed=3)
    two.materialize_u8(two.dispatch_batch_u8(frames))
    _, rec, _ = _profiled(lambda: two.materialize_u8(two.dispatch_batch_u8(frames)))
    d = _only(rec, "ff.dispatch")
    kids = _children(rec, d)
    assert sorted(k.name for k in kids) == sorted(
        ["ff.pad", "ff.upload", "ff.upload", "ff.forward", "ff.forward", "ff.gather",
         "ff.to_u8", "ff.host_copy"])
    for name in ("ff.upload", "ff.forward"):
        assert sorted(k.attrs["replica"] for k in kids if k.name == name) == [0, 1]
    for k in kids:
        if k.name in ("ff.upload", "ff.forward"):
            assert k.thread != d.thread
        else:
            assert k.thread == d.thread
    assert {s.request for s in rec["spans"]} == {d.request}
    assert sum(s.name == "ff.hat" for s in rec["spans"]) == 2


def test_records_match_the_profilers_events(pipe):
    """Each record has its record_function event, started within 100 us of it: one clock."""
    lr = _frames(1, 40, 50, seed=4)[0]

    def served():
        _serve(pipe, _frames(2, seed=4))
        pipe.run_tiled_u8(lr)

    served()
    _, rec, events = _profiled(served)
    assert len(events) == len(rec["spans"]) > 20
    by_name = {}
    for e in events:
        by_name.setdefault(e.name(), []).append(e)
    for name, evs in by_name.items():
        mine = sorted((s for s in rec["spans"] if s.name == name), key=lambda s: s.start_ns)
        evs = sorted(evs, key=lambda e: e.start_ns())
        assert len(mine) == len(evs), name
        for s, e in zip(mine, evs):
            assert abs(s.start_ns - e.start_ns()) < 100_000, (name, s.start_ns - e.start_ns())
            assert e.start_ns() <= s.start_ns and s.end_ns <= e.end_ns()


def test_launch_counter_tallies_shapes_only_while_recording():
    counts = {"k": 0}
    _build.count(counts, "k", (1, 2))
    _, rec, _ = _profiled(lambda: [_build.count(counts, "k", s) for s in ((1, 2), (1, 2), (3,))])
    _build.count(counts, "k", (1, 2))
    assert counts == {"k": 5}
    assert rec["counts"] == {"launches": {("k", (1, 2)): 2, ("k", (3,)): 1}}
    assert rec["spans"] == []


def test_weight_cache_counts_a_miss_and_not_a_hit():
    w = torch.randn(16, 8)
    b = torch.randn(8)
    _mma.planes(w, 16, 8)

    def use():
        _mma.planes(w, 16, 8)          # hit
        _mma.planes(w, 16, 16)         # another spec: a miss
        _mma.fragments(w)              # a miss
        _mma.fragments(w)              # hit
        _mma.f32(b)                    # float32: no cache
        _mma.f32(b.to(torch.bfloat16))  # a new tensor: a miss
        with torch.no_grad():
            w.add_(0)                  # a new version: the next call makes again
        _mma.planes(w, 16, 8)

    _, rec, _ = _profiled(use)
    assert rec["counts"] == {"weights_made": {"planes": 2, "fragments": 1, "f32": 1}}


def _span(name, start, end, id_, parent, request, **attrs):
    return profiling.Span(name, start, end, id_, parent, request, 1, attrs)


def test_readers_need_records(monkeypatch):
    """Each of the four readers leaves its metric out without records (as on a program
    without the recorder), and reads a hand-built window right."""
    run = SimpleNamespace(trace={"port_s": 2.0}, dtype="float32")
    names = ("serve.upload_wait_ms", "serve.enqueue_ms", "kernels.launched_roofline",
             "kernels.weights_made")
    profiling.reset()
    for name in names:
        assert _reader(name).read(run) is None, name
    monkeypatch.setattr(profiling, "records", None)   # a program without the recorder
    for name in names:
        assert _reader(name).read(run) is None, name

    ms = 1_000_000
    spans = [
        _span("ff.dispatch", 0, 100 * ms, 1, None, 1, images=2),
        _span("ff.upload", 1 * ms, 31 * ms, 2, 1, 1),
        _span("ff.forward", 31 * ms, 41 * ms, 3, 1, 1, replica=0),
        _span("ff.dispatch", 200 * ms, 300 * ms, 4, None, 2, images=1),
        _span("ff.upload", 201 * ms, 251 * ms, 5, 4, 2),
        _span("ff.forward", 251 * ms, 271 * ms, 6, 4, 2, replica=0),
        _span("ff.tiled", 400 * ms, 500 * ms, 7, None, 3),
        _span("ff.upload", 401 * ms, 402 * ms, 8, 7, 3),           # not a dispatch's
        _span("ff.chunk", 402 * ms, 450 * ms, 9, 7, 3, chunk=0),
        _span("ff.forward", 403 * ms, 433 * ms, 10, 9, 3, replica=0),
    ]
    launch = ("lka_gate", (9, 4, 8, 16))
    from perfbench.core import bounds
    least = bounds.launch_s(*bounds.lka_gate(9, 4, 8, 16), "float32")
    rec = {"spans": spans, "counts": {"launches": {launch: 3},
                                      "weights_made": {"planes": 4, "f32": 2}}}
    monkeypatch.setattr(profiling, "records", lambda: rec)
    assert _reader("serve.upload_wait_ms").read(run) == pytest.approx((30 + 50) / 3)
    assert _reader("serve.enqueue_ms").read(run) == pytest.approx((10 + 20 + 30) / 3)
    assert _reader("kernels.launched_roofline").read(run) == pytest.approx(
        100 * 3 * least / 2.0, rel=1e-12)
    assert _reader("kernels.weights_made").read(run) == pytest.approx(2.0)
    assert _reader("kernels.launched_roofline").read(
        SimpleNamespace(trace=None, dtype="float32")) is None
    rec["counts"]["launches"][("a_wrapper_without_a_bound", (1,))] = 1
    assert _reader("kernels.launched_roofline").read(run) is None
    rec["counts"] = {}
    assert _reader("kernels.weights_made").read(run) == 0.0


@pytest.mark.parametrize("config", ["freqfusion-f32", "freqfusion-bf16"])
def test_launched_bound_equals_the_model_files(config):
    """For every family of the model file's launches of one 512x352 forward, the launched
    reader's bound of the same launches, as the wrappers count them, is ``forward_bound``'s
    to 1e-9."""
    import json

    from perfbench import models
    from perfbench.core import bounds

    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())
    model = models.load(cfg["model"])
    roofline = _reader("kernels.launched_roofline")
    wrapper_of = {fn.__name__: name for name, fn in roofline.FAMILIES.items()}
    calls = []

    def spy(fn):
        def call(*args):
            calls.append((wrapper_of[fn.__name__], args))
            return fn(*args)
        return call

    listed = model.launches(cfg, 1, 352, 512)
    patched = {n: spy(getattr(bounds, n)) for n in {fn.__name__ for fn in
                                                     roofline.FAMILIES.values()}
               if hasattr(bounds, n)}
    saved = {n: getattr(bounds, n) for n in patched}
    try:
        for n, fn in patched.items():
            setattr(bounds, n, fn)
        assert model.launches(cfg, 1, 352, 512) == listed
    finally:
        for n, fn in saved.items():
            setattr(bounds, n, fn)
    assert len(calls) == len(listed) > 100
    dtype = cfg["dtype"]
    for family in {f for f, _ in listed}:
        want = sum(bounds.launch_s(*work, dtype) for f, work in listed if f == family)
        counted = {}
        for wrapper, shape in calls:
            if roofline.FAMILIES[wrapper].__name__ == family:
                counted[(wrapper, shape)] = counted.get((wrapper, shape), 0) + 1
        assert roofline.least_s(counted, dtype) == pytest.approx(want, rel=1e-9), family
    counted = {}
    for key in calls:
        counted[key] = counted.get(key, 0) + 1
    assert roofline.least_s(counted, dtype) == pytest.approx(
        bounds.forward_bound(model, cfg, 1, 352, 512, dtype), rel=1e-9)


def test_library_is_built_once_from_threads(monkeypatch):
    """Replica threads make their first launches together: 16 threads calling library()
    build and load it once (a build of 0.2 s, a switch interval of 1 us)."""
    built, loaded = [], []

    def slow_build():
        built.append(threading.get_ident())
        time.sleep(0.2)
        return Path("libfake.so"), 0.2, ""

    def load(path):
        loaded.append(path)
        return object()

    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_load", load)
    got = []
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(_build.library()))
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(before)
    assert len(built) == 1 and len(loaded) == 1
    assert len(got) == 16 and all(g is got[0] for g in got)


FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-shared" in args:
    objs = [a for a in args[args.index("-o") + 2:]]
    missing = [o for o in objs if not os.path.exists(o)]
    if missing:
        sys.exit("nvlink fatal: Could not open input file " + missing[0])
    data = b"".join(open(o, "rb").read() for o in objs)
else:
    time.sleep(0.3)
    data = args[-1].encode()
with open(out, "wb") as f:
    f.write(data)
"""


def test_two_builds_share_no_object_file(monkeypatch, tmp_path):
    """Two builds at once in one process (so one process id) into one build directory each
    link their own objects: the library is whole and no object is left behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    results, errors = [], []

    def one():
        try:
            results.append(_build.build())
        except RuntimeError as e:   # nvcc's failure, as the build reports it
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert errors == [] and len(results) == 2
    lib = results[0][0]
    assert lib == results[1][0] and lib.exists()
    sources = sorted(_build.CSRC.glob("*.cu"))
    assert lib.read_bytes() == "".join(str(s) for s in sources).encode()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert _build.build()[1] == 0.0   # now cached


def _tiny_overrides(workload):
    spec = importlib.util.spec_from_file_location("perfbench_tests_conftest",
                                                  ROOT / "perfbench" / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    over = mod.tiny(workload)
    # one shape and one sampled frame: a short set-up and check
    over["traffic"] = {**over["traffic"], "shapes": over["traffic"]["shapes"][:1],
                       "sample": {"first": 1}}
    return over


@pytest.mark.parametrize("traced", [False, True])
def test_a_window_of_the_benchmark(traced):
    """A tiny whole-image cell through the benchmark's harness on the CPU: untraced, the
    recorder holds nothing after the window; traced, the cell reports the program's spans
    and counters (the launched roofline needs the card's kernels, so it is left out)."""
    from perfbench.core import cell

    profiling.reset()
    torch.manual_seed(0)
    spec = cell.Spec(ROOT)
    result, _, _ = cell.run(spec, "ff-f32.div2k", 2950001001, 1.0, traced, time.perf_counter(),
                            device="cpu", log=lambda m: None,
                            overrides=_tiny_overrides("ff-f32.div2k"))
    metrics = result["metrics"]
    if not traced:
        assert profiling.records() == {"spans": [], "counts": {}}
        assert "serve.enqueue_ms" not in metrics
        return
    rec = profiling.records()
    profiling.reset()
    dispatches = [s for s in rec["spans"] if s.name == "ff.dispatch"]
    assert len(dispatches) == result["attempted"]
    assert metrics["serve.upload_wait_ms"]["unit"] == "ms"
    assert 0 < metrics["serve.upload_wait_ms"]["value"] < metrics["serve.dispatch_ms"]["value"]
    assert 0 < metrics["serve.enqueue_ms"]["value"] < metrics["serve.dispatch_ms"]["value"]
    assert metrics["kernels.weights_made"]["value"] == 0.0
    assert "kernels.launched_roofline" not in metrics
