"""Tracing and timing helpers. Twin of ``freqfusion_tpu/utils/profiling.py``.

The reference times submissions with CUDA events and prints per-epoch images a second and
peak GPU memory. Here: a ``torch.profiler`` trace written as a Chrome trace, a step timer
that waits for the device, the allocator's memory statistics per card, and the program's
own recorder of spans and counters.

The recorder records exactly while a ``torch.profiler`` is profiling (the profiler's
own flag); otherwise a span site costs that one flag read and records nothing. A span
(``span``) is also a ``record_function`` range, so it lands in the profiler's trace beside
the kernels it launched, and its record is stamped with the clock of the profiler's host
events (Unix-epoch ns), taken once inside the range. Each span record holds its name, start
and end, the id of the span that encloses it, a request id shared by every span of one
served dispatch or tiled frame, and its thread. Counters (``count``) tally keys by name. The
records stay in memory until ``reset``; ``records`` reads them.

Spans the serving path opens (``infer/io.py``, ``infer/tiling.py``, ``models/experts.py``):
``ff.dispatch`` > ``ff.pad``, ``ff.upload``, ``ff.forward`` (> ``ff.hat``, ``ff.dat``,
``ff.nafnet``, ``ff.head``), ``ff.gather``, ``ff.to_u8``, ``ff.host_copy``; ``ff.materialize``
under its dispatch's request; ``ff.tiled`` > ``ff.upload``, ``ff.chunk`` (> ``ff.forward``),
``ff.normalize``. Counters: ``launches`` by (kernel wrapper, shape of its launch)
(``ops/kernels/_build.py:count``) and ``weights_made`` by the kind of what the weight cache
made (``ops/kernels/_mma.py:kept``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _torch_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class Span(NamedTuple):
    """One span's record: times in Unix-epoch ns, the profiler's host clock."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]     # the enclosing span's id
    request: int              # shared by every span of one dispatch or tiled frame
    thread: int
    attrs: dict


_SPANS: list = []
_COUNTS: Dict[str, Dict] = {}
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_REQUESTS = itertools.count(1)
_LOCAL = threading.local()     # .stack: [(span id, request id)] of this thread's open spans
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current() -> Optional[tuple]:
    """(span id, request id) of this thread's innermost open span, or None: what a span
    opened in another thread takes as ``within``."""
    stack = _stack()
    return stack[-1] if stack else None


class _Recorded:
    __slots__ = ("name", "within", "attrs", "range", "start", "id", "parent", "request")

    def __init__(self, name, within, attrs):
        self.name, self.within, self.attrs = name, within, attrs

    def __enter__(self):
        stack = _stack()
        self.parent, self.request = self.within or (stack[-1] if stack else (None, None))
        if self.request is None:
            self.request = next(_REQUESTS)
        self.id = next(_IDS)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        stack.append((self.id, self.request))
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        self.range.__exit__(*exc)
        record = Span(self.name, self.start, end, self.id, self.parent, self.request,
                      threading.get_ident(), self.attrs)
        with _LOCK:
            _SPANS.append(record)
        return False


def span(name: str, within: Optional[tuple] = None, **attrs):
    """A context manager: a recorded span `name` with `attrs` while a profiler is
    profiling, else nothing. It nests under this thread's innermost open span, and a span
    with no enclosing one opens a new request. `within` = (span id or None, request id or
    None) puts it under that span and request instead: ``current()`` taken in the thread
    that hands work to this one, or (None, a request) to continue a request later."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, within, attrs)


def count(name: str, key, n: int = 1) -> None:
    """Adds n to counter `name` at `key` while a profiler is profiling."""
    if not _torch_profiler._is_profiler_enabled:
        return
    with _LOCK:
        table = _COUNTS.setdefault(name, {})
        table[key] = table.get(key, 0) + n


def records() -> dict:
    """{"spans": [Span] in the order they closed, "counts": {name: {key: n}}}: a copy of
    what was recorded since the last ``reset``."""
    with _LOCK:
        return {"spans": list(_SPANS),
                "counts": {name: dict(table) for name, table in _COUNTS.items()}}


def reset() -> None:
    """Forgets every record."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profiles the enclosed block (the CPU, and the card where there is one) and writes
    its Chrome trace to `log_dir`/trace_<pid>_<ns>.json (``chrome://tracing``, Perfetto).
    The trace holds the program's ``ff.*`` spans as host ranges, on the clock of the
    kernels they launched; the recorder keeps their records too (``records``)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock step timer that waits for the device: ``stop(result)`` synchronises
    every card that holds a tensor of `result` before it reads the clock (the CUDA-event
    analog of the JAX twin's ``block_until_ready``)."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {"mean_s": sum(ts) / len(ts), "p50_s": ts[len(ts) // 2],
                "min_s": ts[0], "max_s": ts[-1], "n": len(ts)}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} from the caching allocator of each
    card (the bytes of live tensors, not the allocator's reserve); empty without a card."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
    return out
