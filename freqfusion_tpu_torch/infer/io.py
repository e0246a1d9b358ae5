"""Serving of an SR module, whole-image and tiled. Twin of ``freqfusion_tpu/infer/io.py``.

``InferencePipeline`` serves the ``nn.Module`` it is given (``FreqFusionSR``, or one expert:
``NAFNetSR``, ``DAT`` or ``HAT``; any module that returns an image or ``(sr, features)`` and
has ``upscale``): each image is reflect-padded to a 32-px bucket (a whole number of DAT's
32-px and of HAT's 16-px windows), run whole, cropped, and converted to uint8 on the device.
An image that the plan refuses (over the pixel budget, smaller than its reflect padding)
goes through ``infer/tiling.py`` in fixed-shape tiles and is stitched on the device. The
batch protocol (``dispatch_batch_u8`` / ``materialize_u8``) lets a caller dispatch image
i+1 before it copies image i back. ``main`` (= ``model_func``) is the directory contract: it
builds ``FreqFusionSR``, loads the ``.pth`` checkpoints it finds under ``model_dir`` and
writes one x4 PNG per input image, whatever its size.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.experts import FreqFusionSR
from ..models.fusion import FusionConfig
from ..utils.convert import load_torch_checkpoint
from ..utils.imageio import list_images, load_image, save_image
from .tiling import require_device, tiled_sr, whole_image_sr

# the JAX twin's defaults: 192-px tiles keep the overlap recompute low on DIV2K-sized
# images; 192 is a whole number of DAT's 32-px and HAT's 16-px windows
TILE = 192
OVERLAP = 32
TILE_BATCH = 2
#: precision -> whether f32 products and convolutions may take TF32: "highest" keeps f32
#: (the JAX twin's "highest"), "high" allows TF32 (PyTorch's own default for cuDNN convs)
PRECISIONS = {"highest": False, "high": True}


class InferencePipeline:
    """Runs an SR module on one device: the card, unless the caller names another
    (``"cpu"``); without a card the default raises. Images run whole at 32-px buckets
    where the plan allows it, else as `tile_batch` tiles of `tile` x `tile` px a forward,
    `overlap` px shared between neighbours. `tile` must suit the model (a multiple of 16
    for HAT's windows; DAT pads to its 32-px windows by itself). `precision` is pinned
    around every forward, whole or tiled, and the caller's setting restored after it:
    "highest" runs f32 products and convolutions in f32, "high" lets them take TF32."""

    # JAX twin's default: 280000 px covers every DIV2K x4 LR frame after 32-px padding.
    # No cap on distinct buckets: the JAX twin's (6) bounds its compile cache, and eager
    # PyTorch compiles nothing per shape. A number here brings the cap back: past it an
    # image pads up to a bucket already in use, or takes the tiled path.
    WHOLE_IMAGE_MAX_PX = 280000
    WHOLE_IMAGE_MAX_SHAPES: Optional[int] = None

    def __init__(self, model: nn.Module, device="cuda", dtype: torch.dtype = torch.float32,
                 tile: int = TILE, overlap: int = OVERLAP, tile_batch: int = TILE_BATCH,
                 precision: str = "highest"):
        if tile < 1 or not 0 <= overlap < tile or tile_batch < 1:
            raise ValueError(f"tiling: tile={tile}, overlap={overlap}, tile_batch={tile_batch}; "
                             "expected tile >= 1, 0 <= overlap < tile and tile_batch >= 1")
        if precision not in PRECISIONS:
            raise ValueError(f"precision={precision!r}; expected one of {sorted(PRECISIONS)}")
        self.tile, self.overlap, self.tile_batch = tile, overlap, tile_batch
        self.precision = precision
        self.device = require_device(device)
        self.dtype = dtype
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.upscale = model.upscale

    def _cliff_warn(self, key, msg):
        seen = getattr(self, "_cliff_seen", None)
        if seen is None:
            seen = self._cliff_seen = set()
        if key not in seen:
            seen.add(key)
            warnings.warn(msg)

    def _whole_image_plan(self, h: int, w: int):
        """(padded_h, padded_w) bucket for a whole-image dispatch (records the bucket), or
        None when the image must take the tiled path (pixel budget, reflect-pad limit, or
        the bucket cap where one is set)."""
        if self.WHOLE_IMAGE_MAX_PX <= 0:
            return None
        hp = -(-max(h, 64) // 32) * 32
        wp = -(-max(w, 64) // 32) * 32
        if hp * wp > self.WHOLE_IMAGE_MAX_PX:
            self._cliff_warn(
                ("px", hp, wp),
                f"whole-image fallback → tiled: {w}x{h} pads to {wp}x{hp} "
                f"({hp * wp} px > {self.WHOLE_IMAGE_MAX_PX})")
            return None
        if hp - h >= h or wp - w >= w:   # reflect pad needs pad < size
            self._cliff_warn(
                ("pad", hp, wp),
                f"whole-image fallback → tiled: {w}x{h} is smaller than its "
                f"reflect padding to the {wp}x{hp} bucket")
            return None
        cache = getattr(self, "_whole_shapes", None)
        if cache is None:
            cache = self._whole_shapes = set()
        cap = self.WHOLE_IMAGE_MAX_SHAPES
        if cap is not None and (hp, wp) not in cache and len(cache) >= cap:
            # cache full: pad up to a bucket in use when that costs at most 30% more
            cand = [(ch * cw, ch, cw) for ch, cw in cache
                    if ch >= hp and cw >= wp
                    and ch - h < h and cw - w < w          # reflect limit
                    and ch * cw <= hp * wp * 1.3]          # ≤30% overhead
            if cand:
                _, ch, cw = min(cand)
                self._cliff_warn(
                    ("padup", hp, wp, ch, cw),
                    f"whole-image shape cache full: {w}x{h} (bucket {wp}x{hp}) pads "
                    f"up to the {cw}x{ch} bucket (+{(ch * cw) / (hp * wp) - 1:.0%} "
                    "compute)")
                return ch, cw
            self._cliff_warn(
                ("cap", hp, wp),
                f"whole-image fallback → tiled: shape cache full ({len(cache)} shapes); "
                f"new bucket {wp}x{hp} takes the tiled path")
            return None
        cache.add((hp, wp))
        return hp, wp

    @contextlib.contextmanager
    def _pinned_precision(self):
        """Sets both TF32 flags for `precision`, and restores the caller's on the way out."""
        tf32 = PRECISIONS[self.precision]
        old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old

    def _forward_device(self, x: torch.Tensor) -> torch.Tensor:
        """[B,hp,wp,3] on the device -> SR [B,s*hp,s*wp,3] on the device."""
        with torch.inference_mode(), self._pinned_precision():
            out = self.model(x.to(self.dtype))
        return out[0] if isinstance(out, tuple) else out

    def _forward(self, lrp: np.ndarray) -> torch.Tensor:
        """[B,hp,wp,3] float host batch -> SR [B,s*hp,s*wp,3] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(lrp, dtype=np.float32))
        return self._forward_device(x.to(self.device, non_blocking=True))

    @staticmethod
    def _pad(lrs, hp: int, wp: int) -> np.ndarray:
        return np.stack([np.pad(a, [(0, hp - a.shape[0]), (0, wp - a.shape[1]), (0, 0)],
                                mode="reflect") for a in lrs])

    @staticmethod
    def _to_u8(sr: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return torch.round(sr.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    def run_tiled(self, lr: np.ndarray) -> torch.Tensor:
        """One HWC float image of any size through the tiled path -> its SR image
        [s*H, s*W, 3] float32 on the device."""
        with torch.inference_mode():
            return tiled_sr(lr, self._forward_device, self.tile, self.overlap,
                            self.tile_batch, self.upscale, self.device)

    def run_tiled_u8(self, lr: np.ndarray) -> np.ndarray:
        """The tiled path's image as HWC uint8 on the host: round(clip(sr,0,1)*255) is
        taken on the device, like the whole-image path's."""
        return self._to_u8(self.run_tiled(lr)).cpu().numpy()

    def run_image(self, lr: np.ndarray) -> np.ndarray:
        """One HWC float image -> its SR image (float HWC, on the host): whole where the
        plan allows it, else tiled."""
        h, w, _ = lr.shape
        plan = self._whole_image_plan(h, w)
        if plan is None:
            return self.run_tiled(lr).cpu().numpy()
        sr = whole_image_sr(lr, self._forward_device, self.upscale, device=self.device,
                            bucket=plan)
        return sr.float().cpu().numpy()

    def dispatch_batch_u8(self, lrs, plan=None):
        """Dispatches a same-bucket batch of HWC float images without waiting for it.

        Returns a handle for ``materialize_u8``: round(clip(sr,0,1)*255) as uint8 is
        computed on the device and its copy to (pinned) host memory is queued on the
        current stream. Returns None when the images must take the tiled path
        (``run_tiled_u8``)."""
        if plan is None:
            plan = self._whole_image_plan(lrs[0].shape[0], lrs[0].shape[1])
            if plan is None:
                return None
        hp, wp = plan
        u8 = self._to_u8(self._forward(self._pad(lrs, hp, wp)))
        done = None
        if u8.device.type == "cuda":
            host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(u8, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = u8
        return host, done, [(a.shape[0], a.shape[1]) for a in lrs]

    def materialize_u8(self, handle):
        """Handle -> list of HWC uint8 arrays, one per image, cropped to x`upscale`."""
        host, done, metas = handle
        if done is not None:
            done.synchronize()
        s = self.upscale
        arr = host.numpy()
        return [arr[i, : h * s, : w * s] for i, (h, w) in enumerate(metas)]


def _find(model_dir: str, patterns) -> Optional[str]:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(model_dir, pat), recursive=True))
        if hits:
            return hits[0]
    return None


def _load_into(module: nn.Module, sd: dict, name: str) -> None:
    """A tolerant load, like the reference's strict=False and the JAX package's loader
    (``freqfusion_tpu/utils/convert.py:_adapt``): keys the module lacks are ignored; a
    tensor with the parameter's element count but another shape is reshaped to it; keys the
    checkpoint lacks, and tensors of another size, keep the module's weights and are
    counted in one warning."""
    own = module.state_dict()
    fitted, wrong = {}, {}
    for k, v in sd.items():
        if k not in own or v.shape == own[k].shape:
            fitted[k] = v
        elif v.numel() == own[k].numel():
            fitted[k] = v.reshape(own[k].shape)
        else:
            wrong[k] = f"{k} {tuple(v.shape)} for {tuple(own[k].shape)}"
    result = module.load_state_dict(fitted, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked") and k not in wrong]
    if missing or wrong:
        first = missing[0] if missing else next(iter(wrong.values()))
        warnings.warn(f"{name}: {len(missing) + len(wrong)} params not in checkpoint "
                      f"({len(wrong)} of another size; first: {first})")


def load_checkpoints(model: FreqFusionSR, model_dir: str) -> None:
    """Fills `model` from the reference-format torch checkpoints under `model_dir`:
    ``pretrained/{hat,dat,nafnet}/**/*.pth`` for the experts (the ``nafnet.`` prefix of a
    NAFNetSR checkpoint is stripped) and the first other ``*.pth`` for the head. A missing
    file warns and keeps the module's seeded random weights. A framework-native ``.ckpt``
    is refused: its loader is not ported (ROADMAP A8)."""
    native = _find(model_dir, ["*.ckpt", "checkpoints/**/*.ckpt"])
    if native:
        raise NotImplementedError(
            f"{native}: loading a framework-native .ckpt is not ported yet (ROADMAP A8); "
            "convert it to a torch .pth")
    experts = {"hat": (model.experts.hat, None), "dat": (model.experts.dat, None),
               "nafnet": (model.experts.nafnet.nafnet, "nafnet.")}
    for name, (module, strip) in experts.items():
        path = _find(model_dir, [f"pretrained/{name}/*.pth", f"pretrained/{name}/**/*.pth"])
        if path is None:
            warnings.warn(f"{name} checkpoint not found under {model_dir}; "
                          "using random weights")
            continue
        sd = load_torch_checkpoint(path)
        if strip:
            sd = {k[len(strip):]: v for k, v in sd.items() if k.startswith(strip)}
        _load_into(module, sd, name)
    path = _find(model_dir, ["*.pth", "checkpoints/**/*.pth", "checkpoints/*.pth"])
    if path and "pretrained" in path:   # the glob may also match an expert's checkpoint
        path = None
    if path is None:
        warnings.warn(f"fusion checkpoint not found under {model_dir}; using random weights")
        return
    _load_into(model.fusion, load_torch_checkpoint(path), "fusion")


def build_pipeline(model_dir: str, device="cuda", fusion_config: Optional[FusionConfig] = None,
                   expert_kwargs: Optional[dict] = None, tile: int = TILE,
                   overlap: int = OVERLAP, tile_batch: int = TILE_BATCH,
                   precision: str = "highest") -> InferencePipeline:
    """``FreqFusionSR`` with seeded initial weights, filled from `model_dir`'s checkpoints,
    behind an ``InferencePipeline`` on `device` at `precision`. `expert_kwargs` may hold
    ``hat_kwargs``, ``dat_kwargs`` and ``nafnet_kwargs`` (tests build tiny experts with
    them)."""
    device = require_device(device)   # before the model is built: it takes seconds
    torch.manual_seed(0)
    model = FreqFusionSR(fusion_config or FusionConfig(), **(expert_kwargs or {}))
    load_checkpoints(model, model_dir)
    return InferencePipeline(model, device, tile=tile, overlap=overlap, tile_batch=tile_batch,
                             precision=precision)


def main(model_dir: str, input_path: str, output_path: str, device="cuda", *,
         fusion_config: Optional[FusionConfig] = None, expert_kwargs: Optional[dict] = None,
         group_max: int = 1, tile: int = TILE, overlap: int = OVERLAP,
         tile_batch: int = TILE_BATCH, precision: str = "highest") -> int:
    """The challenge contract ``model_func(model_dir, input_path, output_path, device)``:
    super-resolves every image of the directory `input_path` into `output_path` under the
    same file name, and returns their number. The device is the card unless the caller
    names another; without a card the default raises.

    Consecutive images of one bucket are grouped, up to `group_max` a dispatch (one forward
    of that batch), and group i+1 is dispatched before group i is copied back and written.
    An image whose plan is the tiled path waits for what is pending, then runs as
    `tile_batch` tiles of `tile` px a forward (`overlap` px shared) and is written.
    `precision` ("highest": f32, the default; "high": TF32 allowed) holds inside every
    forward."""
    pipe = build_pipeline(model_dir, device, fusion_config, expert_kwargs, tile, overlap,
                          tile_batch, precision)
    os.makedirs(output_path, exist_ok=True)
    files = list_images(input_path)

    pending = None   # (handle, [(out_path, name, (lr_w, lr_h), t0), ...])
    group = []       # [(lr, out_path, name, t0), ...] awaiting dispatch
    group_plan = None

    def flush(p):
        handle, items = p
        for arr, (out, name, (lw, lh), t0) in zip(pipe.materialize_u8(handle), items):
            save_image(arr, out)
            print(f"  {name}: {lw}x{lh} -> {arr.shape[1]}x{arr.shape[0]} "
                  f"in {time.time() - t0:.2f}s")

    def dispatch_group():
        nonlocal pending, group, group_plan
        if not group:
            return
        handle = pipe.dispatch_batch_u8([g[0] for g in group], group_plan)
        if pending is not None:
            flush(pending)
        pending = (handle, [(out, name, (lr.shape[1], lr.shape[0]), t0)
                            for lr, out, name, t0 in group])
        group, group_plan = [], None

    for f in files:
        t0 = time.time()
        lr = load_image(f)
        out, name = os.path.join(output_path, os.path.basename(f)), os.path.basename(f)
        plan = pipe._whole_image_plan(lr.shape[0], lr.shape[1])
        if plan is None:   # the tiled path, synchronous
            dispatch_group()
            if pending is not None:
                flush(pending)
                pending = None
            arr = pipe.run_tiled_u8(lr)
            save_image(arr, out)
            print(f"  {name}: {lr.shape[1]}x{lr.shape[0]} -> {arr.shape[1]}x{arr.shape[0]} "
                  f"in {time.time() - t0:.2f}s (tiled)")
            continue
        if group and plan != group_plan:
            dispatch_group()
        group.append((lr, out, name, t0))
        group_plan = plan
        if len(group) >= group_max:
            dispatch_group()
    dispatch_group()
    if pending is not None:
        flush(pending)
    return len(files)


model_func = main
