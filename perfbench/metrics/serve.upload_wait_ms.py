"""Host milliseconds a frame waits in its dispatch's upload: the program's ``ff.upload`` spans
inside its ``ff.dispatch`` spans (the copy of the padded batch from pageable host memory to
the card, which waits for the forward in flight), summed over the window's dispatches, over
the frames they carried."""

from perfbench.core.records import duration_ns, program_records, spans


def read(run):
    rec = program_records()
    if rec is None:
        return None
    dispatches = {s.request: s for s in spans(rec, "ff.dispatch")}
    frames = sum(s.attrs["images"] for s in dispatches.values())
    if not frames:
        return None
    wait = sum(duration_ns(s) for s in spans(rec, "ff.upload") if s.request in dispatches)
    return wait / 1e6 / frames
