"""The program's own records of a traced window: the spans and counters of
``freqfusion_tpu_torch.utils.profiling``, which records exactly while a ``torch.profiler``
is profiling (the harness starts one right before the window and stops it after).

A program without that recorder gives nothing to read, and the readers that use this leave
their metric out.
"""

from __future__ import annotations


def program_records():
    """{"spans": [...], "counts": {name: {key: n}}} as the program recorded them, or None
    where it has no recorder or recorded nothing."""
    try:
        from freqfusion_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    rec = read()
    return rec if rec["spans"] or rec["counts"] else None


def reset_program_records() -> None:
    """Forgets what the program recorded before, so that a run reads only its own window
    (a process that runs several windows, as the tests and ``tools/readings.py`` do)."""
    try:
        from freqfusion_tpu_torch.utils import profiling
    except ImportError:
        return
    reset = getattr(profiling, "reset", None)
    if reset is not None:
        reset()


def spans(rec: dict, name: str) -> list:
    """The recorded spans named `name`."""
    return [s for s in rec["spans"] if s.name == name]


def duration_ns(span) -> int:
    return span.end_ns - span.start_ns
