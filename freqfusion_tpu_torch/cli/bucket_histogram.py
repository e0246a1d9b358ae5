"""32-px bucket histogram and the whole-image / tiled split of an image directory. Twin of
the repository's ``scripts/bucket_histogram.py``.

    python -m freqfusion_tpu_torch.cli.bucket_histogram <dir-of-images>
    python -m freqfusion_tpu_torch.cli.bucket_histogram --shapes WxH,WxH,...
    python -m freqfusion_tpu_torch.cli.bucket_histogram --shapes-file list.txt   # WxH a line

Runs the port's serving plan (``InferencePipeline._whole_image_plan``: the pixel budget, the
reflect limit and, where ``FREQFUSION_WHOLE_IMAGE_SHAPES`` sets one, the bucket cap with its
pad-up to a bucket in use) over the shapes in serving order, without a model, and prints one
JSON line with the histogram and the split. ``FREQFUSION_WHOLE_IMAGE_PX`` and
``FREQFUSION_WHOLE_IMAGE_SHAPES`` are honoured as ``infer.io.main`` honours them;
``max_shapes`` is null where no cap is set (the port's default: eager PyTorch compiles nothing
a shape).
"""

from __future__ import annotations

import json
import os
import sys
import warnings
from typing import List, Optional, Sequence, Tuple

from PIL import Image

from ..infer.io import InferencePipeline


def shapes_from_dir(d: str) -> List[Tuple[int, int]]:
    """(h, w) of every image of `d`, in name order."""
    out = []
    for f in sorted(os.listdir(d)):
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
            with Image.open(os.path.join(d, f)) as im:
                w, h = im.size
            out.append((h, w))
    return out


def parse_shapes(items) -> List[Tuple[int, int]]:
    """'WxH' strings -> (h, w); blank items are skipped."""
    out = []
    for s in items:
        s = s.strip()
        if s:
            w, h = s.lower().split("x")
            out.append((int(h), int(w)))
    return out


class _Plan:
    """The pipeline's plan without a model: its limits and ``_whole_image_plan``."""
    _cliff_warn = InferencePipeline._cliff_warn
    _whole_image_plan = InferencePipeline._whole_image_plan

    def __init__(self):
        env = os.environ.get
        self.WHOLE_IMAGE_MAX_PX = int(env("FREQFUSION_WHOLE_IMAGE_PX",
                                          InferencePipeline.WHOLE_IMAGE_MAX_PX))
        shapes = env("FREQFUSION_WHOLE_IMAGE_SHAPES")
        self.WHOLE_IMAGE_MAX_SHAPES = (int(shapes) if shapes
                                       else InferencePipeline.WHOLE_IMAGE_MAX_SHAPES)


def simulate(shapes: Sequence[Tuple[int, int]]) -> dict:
    """The plan over (h, w) shapes in order: histogram, whole / padded-up / tiled counts."""
    plan = _Plan()
    hist, whole, padded_up, tiled = {}, 0, 0, 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for h, w in shapes:
            hp = -(-max(h, 64) // 32) * 32
            wp = -(-max(w, 64) // 32) * 32
            hist[f"{wp}x{hp}"] = hist.get(f"{wp}x{hp}", 0) + 1
            got = plan._whole_image_plan(h, w)
            if got is None:
                tiled += 1
            elif got != (hp, wp):
                padded_up += 1
            else:
                whole += 1
    return {
        "images": len(shapes),
        "distinct_buckets": len(hist),
        "histogram": dict(sorted(hist.items(), key=lambda kv: -kv[1])),
        "compiled_buckets": len(getattr(plan, "_whole_shapes", set())),
        "whole_image": whole, "padded_up": padded_up, "tiled": tiled,
        "whole_image_pct": round(100.0 * (whole + padded_up) / max(1, len(shapes)), 1),
        "max_px": plan.WHOLE_IMAGE_MAX_PX,
        "max_shapes": plan.WHOLE_IMAGE_MAX_SHAPES,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parses `argv` (the process's arguments if None), prints the JSON line, returns it."""
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--shapes":
        shapes = parse_shapes(args[1].split(","))
    elif args and args[0] == "--shapes-file":
        with open(args[1]) as f:
            shapes = parse_shapes(f.readlines())
    elif args:
        shapes = shapes_from_dir(args[0])
    else:
        sys.exit(__doc__)
    out = simulate(shapes)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
