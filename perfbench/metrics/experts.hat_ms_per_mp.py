"""Device milliseconds of the HAT expert (CUDA events around each replica's forward of
``model.experts.hat``) per HR megapixel it computed."""


def read(run):
    if "hat" not in run.timed:
        return None
    ms, lr_px = run.timed["hat"]
    return ms / (lr_px * run.cfg["upscale"] ** 2 / 1e6) if lr_px else None
