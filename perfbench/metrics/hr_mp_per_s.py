"""HR output megapixels of every request completed in the window, over the window's seconds."""


def read(run):
    return run.hr_px / 1e6 / run.window_s
