"""Host milliseconds the program takes to enqueue one forward: the mean of its ``ff.forward``
spans in the window (the module call of one replica's forward, a whole-image batch or a
tiled chunk; the card runs it later)."""

from perfbench.core.records import duration_ns, program_records, spans


def read(run):
    rec = program_records()
    forwards = [] if rec is None else spans(rec, "ff.forward")
    if not forwards:
        return None
    return sum(duration_ns(s) for s in forwards) / 1e6 / len(forwards)
