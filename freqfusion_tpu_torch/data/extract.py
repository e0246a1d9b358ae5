"""Cached-feature extraction. Twin of ``freqfusion_tpu/data/extract.py``, framework-free:
the caller's `forward_batch` runs the frozen experts (``cli/train.py`` and ``chip_smoke.py``
pass the port's ``ExpertEnsemble`` on the card under ``torch.no_grad()``). It writes the JAX
package's layout, one ``.npz`` a crop with ``lr``, ``hr``, ``out_{hat,dat,nafnet}`` and
``feat_{hat,dat,nafnet}`` (``data/cached.py``), so that either package trains from the
other's cache; uncompressed, where the JAX package compresses.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Tuple

import numpy as np

from .augment import paired_random_crop


def extract_cached_features(
    pairs: Iterable[Tuple],
    load_pair: Callable,
    forward_batch: Callable,
    out_dir: str,
    patch: int = 64,
    crops_per_image: int = 4,
    batch: int = 8,
    scale: int = 4,
    seed: int = 0,
) -> int:
    """Run the frozen experts over random crops and write one .npz per crop.

    forward_batch: [batch, patch, patch, 3] → (outputs dict, features dict),
    each value batched along axis 0.
    Returns the number of samples written.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    pending, hrs, names = [], [], []
    written = 0

    def flush():
        nonlocal pending, hrs, names, written
        if not pending:
            return
        arr = np.stack(pending)
        n_real = arr.shape[0]
        while arr.shape[0] < batch:  # pad to the static batch shape
            arr = np.concatenate([arr, arr[-1:]])
        outputs, features = forward_batch(arr)
        for i in range(n_real):
            # uncompressed: float32 features shrink by under a tenth in zlib, which costs
            # about 0.7 s a crop on the host (np.load reads either)
            np.savez(
                os.path.join(out_dir, f"{names[i]}.npz"),
                lr=pending[i], hr=hrs[i],
                **{f"out_{k}": np.asarray(v[i]) for k, v in outputs.items()},
                **{f"feat_{k}": np.asarray(v[i]) for k, v in features.items()})
            written += 1
        pending, hrs, names = [], [], []

    for lr_path, hr_path in pairs:
        lr, hr = load_pair(lr_path, hr_path)
        for c in range(crops_per_image):
            lr_c, hr_c = paired_random_crop(lr, hr, patch, scale, rng)
            pending.append(lr_c)
            hrs.append(hr_c)
            stem = getattr(hr_path, "stem", os.path.splitext(
                os.path.basename(str(hr_path)))[0])
            names.append(f"{stem}_c{c:02d}")
            if len(pending) == batch:
                flush()
    flush()
    return written
