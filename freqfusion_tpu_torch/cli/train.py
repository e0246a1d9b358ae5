"""Fusion-head training, the twin of the repository's root ``train.py``.

    python -m freqfusion_tpu_torch.cli.train [--config configs/train_config.yaml]
        [--batch_size N] [--epochs N] [--data_root DIR] [--cached | --no-cached] [--debug]
        [--device cuda|cpu]
    torchrun --nproc_per_node N -m freqfusion_tpu_torch.cli.train [...]

The yaml and its overrides, in the root script's order: seeding, the cached (or live)
datasets, the ``FusionHead``, ``CombinedLoss`` with the 3-stage curriculum, clip + AdamW +
warmup + cosine warm restarts + gradient accumulation (``training/steps.py``: the schedule
counts optimizer updates), EMA, ``CheckpointManager`` (atomic, best-K, resume with the
historical best), then per epoch the train steps and a validation (PSNR / SSIM on Y, border
4) with the EMA weights swapped in.

Cached mode trains the head on expert outputs and features that ``data/extract.py`` wrote
(``cached_train_dir`` / ``cached_val_dir``). Live mode (``--no-cached``) runs the frozen
experts (``pretrained/*`` under ``model_dir``, random where missing) inside every step on
LR/HR pairs under ``--data_root``, and validates on 64-px center crops, as the JAX package
does. The device is the card unless ``--device cpu`` is given; without a card the default
raises. Products and convolutions run in f32 (TF32 off, serving's default precision).
``--debug`` cuts the run to 2 epochs of batch 2, repeat 1, validating every epoch.

Data parallelism: under ``torchrun --nproc_per_node N`` (or with the yaml's
``parallel.n_devices: N`` and N ranks launched) each rank trains on ``cuda:LOCAL_RANK`` (or
the CPU, over gloo) with its rows of every global batch of ``data.batch_size``, which N must
divide (``parallel/mesh.py``); the gradients are averaged before the clip and the
batch-coupled ops see the global batch, so that the run computes what one process computes
at the same batch. Validation splits each (padded) batch over the ranks and gathers the
outputs; rank 0 alone writes checkpoints, logs and histograms; a resume loads on every rank.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
import yaml

from ..data.augment import CenterCrop, TrainAugmentation
from ..data.cached import CachedFeatureDataset, batch_iterator, prefetch
from ..data.dataset import SRDataset, find_split_dirs
from ..infer.io import load_expert_checkpoints, pinned_precision
from ..infer.tiling import require_device
from ..losses import CombinedLoss
from ..models.experts import FreqFusionSR
from ..models.fusion import FusionConfig, FusionHead
from ..parallel.mesh import Mesh, all_gather, make_mesh, replicate, shard_batch
from ..training.checkpoint import CheckpointManager
from ..training.ema import EMA
from ..training.schedule import MultiStageLossScheduler, warmup_then_cosine_restarts
from ..training.steps import (make_eval_step, make_frozen_expert_optimizer,
                              make_live_eval_step, make_live_train_step, make_optimizer,
                              make_train_step)
from ..utils.logger import MetricsLogger, ProgressLogger, get_file_logger
from ..utils.metrics import MetricCalculator

FLAGS = ("enable_hierarchical", "enable_lka", "enable_edge_enhance", "enable_multi_domain_freq",
         "enable_dynamic_selection", "enable_cross_band_attn", "enable_adaptive_bands",
         "enable_multi_resolution", "enable_collaborative")


def load_config(path: str, overrides: argparse.Namespace) -> dict:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if overrides.batch_size:
        cfg["data"]["batch_size"] = overrides.batch_size
    if overrides.epochs:
        cfg["train"]["epochs"] = overrides.epochs
    if overrides.data_root:
        cfg["data"]["root"] = overrides.data_root
    if overrides.cached is not None:
        cfg["data"]["cached"] = overrides.cached
    if overrides.debug:
        cfg["train"]["epochs"] = min(cfg["train"]["epochs"], 2)
        cfg["data"]["batch_size"] = min(cfg["data"]["batch_size"], 2)
        cfg["data"]["repeat"] = 1
        cfg["train"]["validate_every"] = 1
    return cfg


def fusion_config(cfg: dict) -> FusionConfig:
    m = cfg["model"]
    return FusionConfig(fusion_dim=m["fusion_dim"], num_heads=m["num_heads"],
                        refine_depth=m["refine_depth"], refine_channels=m["refine_channels"],
                        **{k: m[k] for k in FLAGS})


def build_model(cfg: dict) -> FusionHead:
    return FusionHead(fusion_config(cfg))


def _setup(cfg: dict, steps_per_epoch: int):
    """The loss stages, the criterion at epoch 0 and the learning-rate schedule."""
    stages = MultiStageLossScheduler(cfg["loss"]["stages"])
    criterion = CombinedLoss(stages.weights_for_epoch(0), swt_wavelet=cfg["loss"]["swt_wavelet"],
                             swt_level=cfg["loss"]["swt_level"])
    o = cfg["optim"]
    schedule = warmup_then_cosine_restarts(o["lr"], o["warmup_epochs"] * steps_per_epoch,
                                           o["t0_epochs"] * steps_per_epoch, o["t_mult"])
    return stages, criterion, schedule


class _NoMetrics:
    """The metrics logger of ranks other than 0: they write nothing."""

    def scalars(self, *a, **k):
        pass

    histograms = images = close = scalars


def _mesh(cfg: dict, device) -> Mesh:
    return make_mesh(cfg.get("parallel", {}).get("n_devices"), device)


def _loggers(cfg: dict, mesh: Mesh, name: str):
    """(file logger, metrics logger): files on rank 0 only."""
    lead = mesh.rank == 0
    log = get_file_logger(name, os.path.join(cfg["train"]["log_dir"], f"{name}.log")
                          if lead else None)
    return log, (MetricsLogger(cfg["train"]["log_dir"]) if lead else _NoMetrics())


def _resume(ckpt: CheckpointManager, module, optimizer, ema, log, device):
    """(first epoch, step) from latest.ckpt, its weights, optimizer and EMA state loaded."""
    record = ckpt.load(map_location=device)
    if record is None:
        return 0, 0
    module.load_state_dict(record["model"])
    optimizer.load_state_dict(record["opt_state"])
    if ema and record.get("ema_state"):
        ema.load_state_dict(record["ema_state"])
    log.info(f"resumed from epoch {record['epoch']} (best {ckpt.best_value()})")
    return int(record["epoch"]) + 1, int(record.get("step", 0))


def _train_epoch(step_fn, batches, module, ema, optimizer, metrics_log, cfg, mesh,
                 generator, global_step):
    """One epoch of train steps over global batches; returns (images, global step)."""
    n_images, batch_size = 0, cfg["data"]["batch_size"]
    for batch in batches:
        metrics = step_fn(shard_batch(batch, mesh), generator)
        if ema:
            ema.update(module)
        global_step += 1
        n_images += batch_size
        if global_step % cfg["train"]["print_freq"] == 0:
            metrics_log.scalars({k: float(v) for k, v in metrics.items()}, global_step,
                                prefix="train/")
            count = optimizer.param_groups[0]["count"]
            metrics_log.scalars({"lr": optimizer.schedule(count)}, global_step, "opt/")
        if global_step % (cfg["train"]["print_freq"] * 10) == 0:
            metrics_log.histograms(module.state_dict(), global_step, prefix="params/")
    return n_images, global_step


def _checkpoint(ckpt, epoch, module, optimizer, ema, global_step, val_metrics, mesh):
    if mesh.rank != 0:
        return
    is_best = bool(val_metrics) and ckpt.is_best(val_metrics["psnr"])
    if is_best or ckpt.should_save(epoch):
        ckpt.save_checkpoint(epoch, {"model": module.state_dict(),
                                     "opt_state": optimizer.state_dict(),
                                     "step": global_step,
                                     "ema_state": ema.state_dict() if ema else {}},
                             val_metrics or {"psnr": 0.0}, is_best)


def train(cfg: dict, device="cuda") -> Optional[float]:
    """The whole run; returns the best validation PSNR (None without a validation, and on
    ranks other than 0)."""
    device = require_device(device)
    mesh = _mesh(cfg, device)
    if not cfg["data"]["cached"]:
        return train_live(cfg, mesh)
    device = mesh.device
    log, metrics_log = _loggers(cfg, mesh, "train")
    torch.manual_seed(cfg["seed"])
    generator = torch.Generator(device=device).manual_seed(cfg["seed"])

    train_ds = CachedFeatureDataset(cfg["data"]["cached_train_dir"], augment=True,
                                    seed=cfg["seed"])
    val_ds = CachedFeatureDataset(cfg["data"]["cached_val_dir"], augment=False)
    log.info(f"train samples: {len(train_ds)}, val samples: {len(val_ds)}")

    model = replicate(build_model(cfg).to(device), mesh)
    batch_size = cfg["data"]["batch_size"]
    stages, criterion, schedule = _setup(cfg, max(len(train_ds) // batch_size, 1))
    o = cfg["optim"]
    optimizer = make_optimizer(model, schedule, o["weight_decay"], o["grad_clip"],
                               o["accumulation_steps"])
    log.info(f"trainable fusion-head params: "
             f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    ema = EMA(model, cfg["ema"]["decay"]) if cfg["ema"]["enabled"] else None
    ckpt = CheckpointManager(cfg["train"]["checkpoint_dir"], max_best=cfg["train"]["max_best"],
                             save_every=cfg["train"]["save_every"])
    start_epoch, global_step = _resume(ckpt, model, optimizer, ema, log, device)

    train_step = make_train_step(model, criterion, optimizer, mesh)
    eval_step = make_eval_step(model, mesh)
    progress = ProgressLogger(cfg["train"]["epochs"])
    current_stage = None
    with pinned_precision("highest"):
        for epoch in range(start_epoch, cfg["train"]["epochs"]):
            if stages.stage_index(epoch) != current_stage:
                current_stage = stages.stage_index(epoch)
                criterion.set_weights(stages.weights_for_epoch(epoch))
                log.info("loss " + stages.describe(epoch))
            batches = prefetch(batch_iterator(train_ds, batch_size, shuffle=True,
                                              seed=cfg["seed"] + epoch))
            n_images, global_step = _train_epoch(train_step, batches, model, ema, optimizer,
                                                 metrics_log, cfg, mesh, generator,
                                                 global_step)
            log.info(progress.epoch_summary(epoch, n_images))

            val_metrics = {}
            if (epoch >= cfg["train"]["validate_start"]
                    and epoch % cfg["train"]["validate_every"] == 0):
                if ema:
                    ema.apply(model)
                calc = MetricCalculator(crop_border=4, y_channel=True)
                shown = False
                for batch in batch_iterator(val_ds, batch_size, shuffle=False, drop_last=False):
                    n_real = batch["lr"].shape[0]
                    pad = batch_size - n_real
                    if pad:   # the validation batch padded to its static size, as JAX does
                        batch = _pad_batch(batch, pad)
                    sr = all_gather(eval_step(shard_batch(batch, mesh)), mesh)[:n_real].cpu()
                    calc.update(sr, batch["hr"][:n_real])
                    if not shown:
                        metrics_log.images("val/lr_sr_hr", batch["lr"][0], sr[0],
                                           batch["hr"][0], epoch)
                        shown = True
                if ema:
                    ema.restore(model)
                val_metrics = calc.compute()
                metrics_log.scalars({"psnr": val_metrics["psnr"], "ssim": val_metrics["ssim"]},
                                    epoch, "val/")
                log.info(f"  val: PSNR {val_metrics['psnr']:.3f} dB, "
                         f"SSIM {val_metrics['ssim']:.4f}")
            _checkpoint(ckpt, epoch, model, optimizer, ema, global_step, val_metrics, mesh)

    metrics_log.close()
    log.info(f"done; best PSNR {ckpt.best_value()}")
    return ckpt.best_value() if mesh.rank == 0 else None


def _pad_batch(batch, pad: int):
    if isinstance(batch, dict):
        return {k: _pad_batch(v, pad) for k, v in batch.items()}
    return np.concatenate([batch, batch[-1:].repeat(pad, 0)])


def train_live(cfg: dict, mesh: Mesh) -> Optional[float]:
    """Live mode: the frozen experts inside every step, EMA over the head's parameters,
    validation on fixed-shape center crops, best-K checkpoints of the head with resume."""
    device = mesh.device
    log, metrics_log = _loggers(cfg, mesh, "train")
    d = cfg["data"]
    lr_dir, hr_dir = find_split_dirs(d["root"], "train", d["scale"])
    ds = SRDataset(lr_dir, hr_dir, d["lr_patch"], d["scale"], repeat=d["repeat"],
                   augment=TrainAugmentation(d["lr_patch"], d["scale"], seed=cfg["seed"]))
    try:
        va_lr, va_hr = find_split_dirs(d["root"], "val", d["scale"])
        val_ds = SRDataset(va_lr, va_hr, d["lr_patch"], d["scale"],
                           augment=CenterCrop(d["lr_patch"], d["scale"]))
    except FileNotFoundError:
        val_ds = None
    log.info(f"live mode: {len(ds)} train samples, {len(val_ds) if val_ds else 0} val "
             "samples (frozen experts in every step)")

    torch.manual_seed(cfg["seed"])
    generator = torch.Generator(device=device).manual_seed(cfg["seed"])
    model = FreqFusionSR(fusion_config(cfg), **(cfg["model"].get("expert_kwargs") or {}))
    load_expert_checkpoints(model, cfg.get("model_dir", "model_zoo/team29"))
    model.to(device)
    replicate(model.fusion, mesh)   # the experts are alike on every rank: the same files
    batch_size = d["batch_size"]
    stages, criterion, schedule = _setup(cfg, max(len(ds) // batch_size, 1))
    o = cfg["optim"]
    optimizer = make_frozen_expert_optimizer(model, schedule, o["weight_decay"], o["grad_clip"],
                                             o["accumulation_steps"])
    ema = EMA(model.fusion, cfg["ema"]["decay"]) if cfg["ema"]["enabled"] else None
    ckpt = CheckpointManager(cfg["train"]["checkpoint_dir"], max_best=cfg["train"]["max_best"],
                             save_every=cfg["train"]["save_every"])
    start_epoch, global_step = _resume(ckpt, model.fusion, optimizer, ema, log, device)

    def batch_iter(dataset, epoch, shuffle=True):
        brng = np.random.default_rng(cfg["seed"] + epoch)
        order = brng.permutation(len(dataset)) if shuffle else np.arange(len(dataset))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(j)] for j in order[i:i + batch_size]]
            yield {"lr": np.stack([it["lr"] for it in items]),
                   "hr": np.stack([it["hr"] for it in items])}

    train_step = make_live_train_step(model, criterion, optimizer, mesh)
    eval_step = make_live_eval_step(model, mesh)
    progress = ProgressLogger(cfg["train"]["epochs"])
    current_stage = None
    with pinned_precision("highest"):
        for epoch in range(start_epoch, cfg["train"]["epochs"]):
            if stages.stage_index(epoch) != current_stage:
                current_stage = stages.stage_index(epoch)
                criterion.set_weights(stages.weights_for_epoch(epoch))
                log.info("loss " + stages.describe(epoch))
            n_images, global_step = _train_epoch(train_step, prefetch(batch_iter(ds, epoch)),
                                                 model.fusion, ema, optimizer, metrics_log, cfg,
                                                 mesh, generator, global_step)
            log.info(progress.epoch_summary(epoch, n_images))

            val_metrics = {}
            if (val_ds is not None and epoch >= cfg["train"]["validate_start"]
                    and epoch % cfg["train"]["validate_every"] == 0):
                if ema:
                    ema.apply(model.fusion)
                calc = MetricCalculator(crop_border=4, y_channel=True)
                for batch in batch_iter(val_ds, 0, shuffle=False):
                    sr = all_gather(eval_step(shard_batch(batch, mesh)), mesh)
                    calc.update(sr.cpu(), batch["hr"])
                if ema:
                    ema.restore(model.fusion)
                val_metrics = calc.compute()
                metrics_log.scalars({"psnr": val_metrics["psnr"], "ssim": val_metrics["ssim"]},
                                    epoch, "val/")
                log.info(f"  val: PSNR {val_metrics['psnr']:.3f} dB, "
                         f"SSIM {val_metrics['ssim']:.4f}")
            # the head only (its BatchNorm statistics included); the experts reload from
            # model_dir
            _checkpoint(ckpt, epoch, model.fusion, optimizer, ema, global_step, val_metrics,
                        mesh)

    metrics_log.close()
    log.info(f"live done; best PSNR {ckpt.best_value()}")
    return ckpt.best_value() if mesh.rank == 0 else None


def main(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/train_config.yaml")
    ap.add_argument("--batch_size", type=int)
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--data_root", type=str)
    ap.add_argument("--cached", action=argparse.BooleanOptionalAction, default=None)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = load_config(args.config, args)
    try:
        return train(cfg, args.device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
