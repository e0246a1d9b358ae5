"""The runtime configuration yaml that serving reads. Twin of ``runtime_overrides`` in
``freqfusion_tpu/utils/runtime.py``; the rest of that module (compile caches, host devices,
shape-only initialisation) belongs to JAX on the TPU and has no counterpart here.
"""

from __future__ import annotations

import os


def runtime_overrides() -> dict:
    """Optional runtime config from the yaml that ``FREQFUSION_CONFIG`` names; {} when the
    variable is unset or names no file.

    ``infer.io.main`` builds the shipped full-size model; this hook is the debug-shrink
    analog of the reference's ``--debug`` mode, a yaml with any of:

        model:  {fusion_dim, num_heads, refine_depth, refine_channels,
                 enable_* flags, expert_kwargs: {hat_kwargs: {...}, ...}}
        infer:  {tile, overlap, tile_batch}
    """
    path = os.environ.get("FREQFUSION_CONFIG")
    if not path or not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}
