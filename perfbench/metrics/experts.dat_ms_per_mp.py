"""Device milliseconds of the DAT expert (CUDA events around each replica's forward of
``model.experts.dat``) per HR megapixel it computed."""


def read(run):
    if "dat" not in run.timed:
        return None
    ms, lr_px = run.timed["dat"]
    return ms / (lr_px * run.cfg["upscale"] ** 2 / 1e6) if lr_px else None
