"""Percent: the least time the card could take for the program's hand-written kernel launches
of the window's forwards (``core/bounds.py``: each launch's bound from its shape and the
published peaks of the cell's numerics, the launches from the model's file), over the device
time of those kernels in the trace."""

from perfbench.core.bounds import forward_bound


def read(run):
    if run.trace is None or not run.trace["port_s"]:
        return None
    least = sum(forward_bound(run.model, run.cfg, b, h, w, run.dtype, run.cfg["precision"])
                for b, h, w in run.forwards)
    return 100.0 * least / run.trace["port_s"]
