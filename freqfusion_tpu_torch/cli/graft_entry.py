"""Entry points of the port. Twin of the repository's ``__graft_entry__.py``.

- ``entry(device="cuda")`` -> (fn, args): ``fn(*args)`` is the full ``FreqFusionSR``
  (``FusionConfig()`` over HAT-L, DAT and NAFNet-64, seeded random weights) forward under
  ``torch.no_grad()`` on one 64x64 LR tile: on the card it launches kernels B1 to B12.
- ``dryrun_multichip(n)`` runs the four data-parallel paths of the JAX twin at its tiny
  shapes on n ranks (``parallel.mesh.run_ranks``; ``nccl`` on cards, ``gloo`` on the CPU or
  as `backend`) and n serving replicas, and prints one ``OK`` line for each: a cached step
  of the shipped head (AdamW, clip, the combined loss, BatchNorm statistics) at a global
  batch of n, a live step of a tiny ``FreqFusionSR`` (frozen experts in the step), a batch
  of n tiles split over the replicas, and a whole-image uint8 group of n - 1 ragged images
  (at least one) padded by repeat.

    python -m freqfusion_tpu_torch.cli.graft_entry [--n N] [--device cuda|cpu] [--backend B]
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..infer.io import InferencePipeline, pinned_precision
from ..infer.tiling import require_device
from ..losses import CombinedLoss
from ..models.experts import FreqFusionSR
from ..models.fusion import FusionConfig, FusionHead
from ..parallel.mesh import make_mesh, run_ranks, shard_batch
from ..training.schedule import warmup_then_cosine_restarts
from ..training.steps import (make_frozen_expert_optimizer, make_live_train_step,
                              make_optimizer, make_train_step)

#: the JAX twin's tiny live model
TINY_EXPERTS = dict(
    hat_kwargs=dict(embed_dim=24, depths=(1,), num_heads=(2,), window=4, squeeze=6),
    dat_kwargs=dict(embed_dim=32, depths=(1,), num_heads=(2,), split_size=(2, 4),
                    expansion=2.0),
    nafnet_kwargs=dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)))
TINY_HEAD = dict(fusion_dim=16, num_heads=2, refine_depth=2, refine_channels=8)
LOSS_WEIGHTS = {"l1": 1.0, "charbonnier": 0, "l2": 0, "vgg": 0, "swt": 0.2, "fft": 0.05,
                "edge": 0, "ssim": 0}


def entry(device="cuda"):
    """(fn, (model, lr)): the full model's forward on one 64x64 LR tile (uniform values
    from seed 0), f32 with TF32 off."""
    device = require_device(device)
    torch.manual_seed(0)
    model = FreqFusionSR(FusionConfig()).to(device).eval()
    lr = torch.rand(1, 64, 64, 3, generator=torch.Generator().manual_seed(0)).to(device)

    def fn(model, lr):
        with torch.no_grad(), pinned_precision("highest"):
            return model(lr)

    return fn, (model, lr)


def _batch(n: int, h: int = 8) -> dict:
    """The JAX twin's global batch of n at LR h x h: lr, hr, the experts' outputs and
    features (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "lr": rng.uniform(size=(n, h, h, 3)).astype(f32),
        "hr": rng.uniform(size=(n, 4 * h, 4 * h, 3)).astype(f32),
        "expert_outputs": {k: rng.uniform(size=(n, 4 * h, 4 * h, 3)).astype(f32)
                           for k in ("hat", "dat", "nafnet")},
        "expert_features": {k: (rng.normal(size=(n, h, h, c)) * 0.1).astype(f32)
                            for k, c in (("hat", 180), ("dat", 180), ("nafnet", 64))},
    }


def _dryrun_rank(rank: int, n: int, device: str, backend: Optional[str]):
    """One rank of ``dryrun_multichip``: the cached and the live step; rank 0 returns their
    lines and the live model's state after its step."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)
    mesh = make_mesh(n, device, backend, timeout_s=120)
    batch = _batch(n)
    schedule = warmup_then_cosine_restarts(1.5e-4, 10, 100)
    criterion = CombinedLoss(LOSS_WEIGHTS)
    gen = torch.Generator(mesh.device).manual_seed(1)
    lines = []
    with pinned_precision("highest"):
        torch.manual_seed(0)
        head = FusionHead(FusionConfig()).to(mesh.device)
        opt = make_optimizer(head, schedule)
        m = make_train_step(head, criterion, opt, mesh)(shard_batch(batch, mesh), gen)
        loss = float(m["total"])
        assert math.isfinite(loss), f"non-finite loss {loss}"
        assert opt.param_groups[0]["count"] == 1
        lines.append(f"dryrun_multichip({n}): cached train step OK, loss={loss:.4f}, "
                     f"grad_norm={float(m['grad_norm']):.4f}")

        torch.manual_seed(2)
        live = FreqFusionSR(FusionConfig(**TINY_HEAD), **TINY_EXPERTS).to(mesh.device)
        live_opt = make_frozen_expert_optimizer(live, schedule)
        live_batch = {"lr": batch["lr"], "hr": batch["hr"]}
        m = make_live_train_step(live, criterion, live_opt, mesh)(
            shard_batch(live_batch, mesh), gen)
        live_loss = float(m["total"])
        assert math.isfinite(live_loss), f"non-finite live loss {live_loss}"
        lines.append(f"dryrun_multichip({n}): live train step OK (experts in-graph), "
                     f"loss={live_loss:.4f}")
    if rank != 0:
        return None
    return lines, {k: v.cpu() for k, v in live.state_dict().items()}


def dryrun_multichip(n_devices: int, backend: Optional[str] = None, device="cuda",
                     timeout_s: float = 600) -> List[str]:
    """The four paths on `n_devices` ranks and replicas of `device` (the card unless the
    caller names the CPU); prints and returns their ``OK`` lines. A path that fails raises;
    a rank that hangs is killed after `timeout_s` seconds and ``TimeoutError`` raised."""
    n = n_devices
    device = require_device(device)
    results = run_ranks(_dryrun_rank, n, n, str(device), backend, timeout_s=timeout_s)
    lines, live_state = results[0]
    for line in lines:
        print(line, flush=True)

    torch.manual_seed(2)
    live = FreqFusionSR(FusionConfig(**TINY_HEAD), **TINY_EXPERTS)
    live.load_state_dict(live_state)
    pipe = InferencePipeline(live, device, tile=16, overlap=4, tile_batch=n, n_devices=n)
    sr = pipe.forward_batch(_batch(n)["lr"]).clamp(0.0, 1.0)
    assert tuple(sr.shape) == (n, 32, 32, 3) and bool(torch.isfinite(sr).all())
    lines.append(f"dryrun_multichip({n}): sharded inference batch OK, out={tuple(sr.shape)}")
    print(lines[-1], flush=True)

    assert pipe.u8_group_max == n
    rng = np.random.default_rng(3)
    lrs = [rng.uniform(size=(40, 56, 3)).astype(np.float32) for _ in range(max(n - 1, 1))]
    handle = pipe.dispatch_batch_u8(lrs)
    assert handle is not None, "whole-image plan refused on the replicas"
    outs = pipe.materialize_u8(handle)
    assert len(outs) == len(lrs)
    assert all(o.dtype == np.uint8 and o.shape == (160, 224, 3) for o in outs)
    lines.append(f"dryrun_multichip({n}): sharded whole-image uint8 batch OK, "
                 f"{len(lrs)} images → {outs[0].shape} u8")
    print(lines[-1], flush=True)
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help="ranks and replicas (default: the cards present)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args(argv)
    n = args.n or (torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1)
    return dryrun_multichip(n, args.backend, args.device)


if __name__ == "__main__":
    main()
