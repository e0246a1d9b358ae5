"""Percent of the traced window in which no operation ran on a card, the mean over the cards
the cell uses."""


def read(run):
    if run.trace is None:
        return None
    tr = run.trace
    busy = sum(tr["busy_s"].values()) / len(tr["busy_s"])
    return 100.0 * (1.0 - busy / tr["window_s"])
