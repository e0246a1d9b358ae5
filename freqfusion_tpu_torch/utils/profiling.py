"""Tracing and timing helpers. Twin of ``freqfusion_tpu/utils/profiling.py``.

The reference times submissions with CUDA events and prints per-epoch images a second and
peak GPU memory. Here: a ``torch.profiler`` trace written as a Chrome trace, a step timer
that waits for the device, and the allocator's memory statistics per card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profiles the enclosed block (the CPU, and the card where there is one) and writes
    its Chrome trace to `log_dir`/trace_<pid>_<ns>.json (``chrome://tracing``, Perfetto)."""
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
