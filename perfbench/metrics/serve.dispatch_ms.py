"""Host milliseconds a frame spends in ``dispatch_batch_u8`` (padding, upload, the enqueue of
the forward on every replica, the gather), from the benchmark's spans around each call."""


def read(run):
    images = sum(n for _, n in run.dispatch)
    return 1e3 * sum(s for s, _ in run.dispatch) / images if images else None
