"""Cached-feature extraction of the port. Twin of the repository's
``scripts/extract_features.py``.

    python -m freqfusion_tpu_torch.cli.extract_features --data-root DATA --split train \\
        --out cached_features_train [--model-dir model_zoo/team29] [--patch 64] \\
        [--crops-per-image 4] [--batch 8] [--scale 4] [--seed 0] [--device cuda|cpu]

For each LR/HR pair of the split it samples `--crops-per-image` random crops (LR `--patch`
px), runs the frozen ``ExpertEnsemble`` once a batch of `--batch` crops (the experts'
``.pth`` from ``pretrained/{hat,dat,nafnet}`` under `--model-dir`, seeded random weights
where one is missing; ``expert_kwargs`` from the ``FREQFUSION_CONFIG`` yaml's ``model``, as
the JAX script reads them) and writes one ``.npz`` a crop with ``lr``, ``hr``, ``out_*`` and
``feat_*`` (``data/extract.py``; the JAX package's layout, so either package trains from
it). The device is the card unless ``--device cpu`` is given; without a card the default
raises. The experts run f32 with TF32 off.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from ..data.dataset import find_split_dirs, list_image_paths, match_pairs
from ..data.extract import extract_cached_features
from ..infer.io import load_expert_checkpoints, pinned_precision
from ..infer.tiling import require_device
from ..models.experts import ExpertEnsemble
from ..utils.imageio import load_image
from ..utils.runtime import runtime_overrides


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Parses `argv` (the process's arguments if None), extracts, and returns the number
    of samples written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="train", choices=["train", "val"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--model-dir", default="model_zoo/team29")
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--crops-per-image", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default raises without a card")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    lr_dir, hr_dir = find_split_dirs(args.data_root, args.split, args.scale)
    pairs = match_pairs(list_image_paths(lr_dir), list_image_paths(hr_dir))
    print(f"{len(pairs)} LR/HR pairs in {lr_dir}")

    expert_kwargs = runtime_overrides().get("model", {}).get("expert_kwargs") or {}
    torch.manual_seed(0)
    model = ExpertEnsemble(**expert_kwargs)
    load_expert_checkpoints(model, args.model_dir)
    model = model.to(device).eval()

    def forward(batch):
        with torch.no_grad(), pinned_precision("highest"):
            outs, feats = model(torch.from_numpy(batch).to(device))
        return ({k: v.cpu().numpy() for k, v in outs.items()},
                {k: v.cpu().numpy() for k, v in feats.items()})

    n = extract_cached_features(
        pairs, lambda lp, hp: (load_image(str(lp)), load_image(str(hp))), forward, args.out,
        args.patch, args.crops_per_image, args.batch, args.scale, args.seed)
    print(f"wrote {n} cached samples to {args.out}")
    return n


if __name__ == "__main__":
    main()
