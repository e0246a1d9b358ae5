"""Weights the program's weight cache made in the window (``_mma.kept``'s misses: planes,
fragments, f32 copies and the like, counted under ``weights_made``), per forward
(``ff.forward`` spans). A warm program makes none."""

from perfbench.core.records import program_records, spans


def read(run):
    rec = program_records()
    if rec is None:
        return None
    forwards = len(spans(rec, "ff.forward"))
    if not forwards:
        return None
    return sum(rec["counts"].get("weights_made", {}).values()) / forwards
