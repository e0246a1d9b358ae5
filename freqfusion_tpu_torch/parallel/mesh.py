"""Device placement for training. Twin of the part of ``freqfusion_tpu/parallel/mesh.py``
that the training script calls, for one card: the batch goes to the device, the parameters
stay where the model is. Data parallelism over several cards is not ported yet (ROADMAP A5):
``n_devices`` above 1 raises."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> torch.device:
    """The one device that training runs on (`n_devices` None or 1)."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: data parallelism over several cards is not ported "
            "yet (ROADMAP A5); the port trains on one card")
    return torch.device(device)


def shard_batch(tree, device: torch.device):
    """Every numpy array or tensor of a (nested dict) batch on `device`, as float32."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32, non_blocking=True)
    return tree
