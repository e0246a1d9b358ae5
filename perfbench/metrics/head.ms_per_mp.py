"""Device milliseconds of the fusion head (CUDA events around each replica's forward of
``model.fusion``) per HR megapixel it computed."""


def read(run):
    if "head" not in run.timed:
        return None
    ms, lr_px = run.timed["head"]
    return ms / (lr_px * run.cfg["upscale"] ** 2 / 1e6) if lr_px else None
