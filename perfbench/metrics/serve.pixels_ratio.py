"""LR pixels through the model's forwards (every replica's, padding and tile overlap
included) over the LR pixels of the requests served."""


def read(run):
    served = sum(h * w for _, (h, w), _, _ in run.requests)
    through = sum(b * h * w for b, h, w in run.forwards)
    return through / served if served and through else None
