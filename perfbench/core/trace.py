"""Reduction of a ``torch.profiler`` trace of the window to device time.

The window is the host annotation ``perfbench.window``. Device activity is every CUDA event
of the trace that is not an annotation (kernels, copies, sets), clipped to the window. Busy
time is the union of a card's intervals; idle gaps are the holes between them, each named by
what the host was doing when it began: the benchmark's own span (``serve.*``) and the
innermost host operation open at that moment.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

WINDOW = "perfbench.window"


def port_kernel_names(csrc: Path) -> set:
    """Names of the program's hand-written kernels: every ``__global__`` function of its CUDA
    sources."""
    names = set()
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = re.sub(r"__launch_bounds__\([^)]*\)", "", f.read_text())
        names.update(re.findall(r"__global__[^;{(]*?\b(\w+)\s*\(", text))
    return names


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template and arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = base[5:] if base.startswith("void ") else base
    base = re.sub(r"<.*", "", base.split("(")[0]).strip()
    return base.split("::")[-1][:100] or name[:100]


def _union(iv):
    """Sorted, merged intervals and their total length."""
    if not iv:
        return [], 0
    iv = sorted(iv)
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def reduce(events, port_names: set, devices) -> dict:
    """events: the profiler's kineto events. Returns the window (s), busy seconds per card,
    device seconds by kernel, the port's kernel seconds, all device seconds, and the ten
    longest idle gaps of the first card with what the host was doing."""
    win = None
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            if e.name() == WINDOW:
                win = (e.start_ns(), e.end_ns())
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind.endswith("CUDA") and not e.is_user_annotation() and e.duration_ns() > 0:
            dev.append((e.device_index(), e.start_ns(), e.end_ns(), e.name()))
    if win is None:
        raise RuntimeError("the trace holds no window annotation")
    t0, t1 = win
    by_kernel, port_ns, all_ns, busy, merged0 = {}, 0, 0, {}, []
    per_dev = {d: [] for d in devices}
    for d, s, e, name in dev:
        s, e = max(s, t0), min(e, t1)
        if e <= s or d not in per_dev:
            continue
        per_dev[d].append((s, e))
        k = short_name(name)
        by_kernel[k] = by_kernel.get(k, 0) + (e - s)
        all_ns += e - s
        if k in port_names:
            port_ns += e - s
    for d, iv in per_dev.items():
        merged, busy[d] = _union(iv)
        if d == devices[0]:
            merged0 = merged
    gaps = []
    edges = [t0] + [x for m in merged0 for x in m] + [t1]
    for i in range(0, len(edges), 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i + 1] - edges[i], edges[i]))
    gaps = sorted(gaps, reverse=True)[:10]
    hs = np.array([h[0] for h in host], dtype=np.int64) if host else np.zeros(0, np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64) if host else np.zeros(0, np.int64)
    idle = []
    for length, start in gaps:
        at = start + 1
        open_ = np.nonzero((hs <= at) & (he > at))[0]
        spans = [host[i] for i in open_]
        ours = [h for h in spans if h[2].startswith("serve.")]
        inner = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "nothing traced"
        label = f"{ours[0][2]} > {inner}" if ours and ours[0][2] != inner else inner
        idle.append([label[:120], length / 1e9])
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": {d: v / 1e9 for d, v in busy.items()},
            "kernel_s": {k: v / 1e9 for k, v in by_kernel.items()},
            "port_s": port_ns / 1e9, "device_s": all_ns / 1e9, "idle_gaps": idle}
