"""Serving of an SR module, whole-image and tiled. Twin of ``freqfusion_tpu/infer/io.py``.

``InferencePipeline`` serves the ``nn.Module`` it is given (``FreqFusionSR``, or one expert:
``NAFNetSR``, ``DAT`` or ``HAT``; any module that returns an image or ``(sr, features)`` and
has ``upscale``): each image is reflect-padded to a 32-px bucket (a whole number of DAT's
32-px and of HAT's 16-px windows), run whole, cropped, and converted to uint8 on the device.
An image that the plan refuses (over the pixel budget, smaller than its reflect padding)
goes through ``infer/tiling.py`` in fixed-shape tiles and is stitched on the device. The
batch protocol (``dispatch_batch_u8`` / ``materialize_u8``) lets a caller dispatch image
i+1 before it copies image i back. ``main`` (= ``model_func``) is the directory contract: it
builds ``FreqFusionSR``, loads the checkpoints it finds under ``model_dir`` (the experts'
``.pth``; the head from a native ``.ckpt`` that training wrote, in the port's ``torch.save``
format or the JAX package's flax msgpack, else from a ``.pth``) and writes one x4 PNG per
input image, whatever its size. It serves in float32 or, with ``dtype="bfloat16"`` (or
``FREQFUSION_DTYPE=bfloat16``), in bfloat16 as the JAX package's serving does: parameters and
input cast to bf16, every kernel reading and writing bf16 with bf16 products, the output
taken to f32 before the clamp and the uint8 conversion. With ``precision="default"`` (or
``FREQFUSION_PRECISION=default``) it serves the JAX pipeline's own default numerics: f32
storage, every kernel's matmul operands rounded to bf16 with f32 accumulation, and TF32 in
the cuDNN and cuBLAS glue; the port's default stays "highest" (f32-exact). The JAX
``main``'s environment switches and its ``FREQFUSION_CONFIG`` yaml (``utils/runtime.py``)
are read where the caller gives no keyword (``serving_options``).

Several cards (``n_devices``; None: every card present, as the JAX twin takes every device)
serve from one process with one replica of the model a card (``cuda:0`` ..
``cuda:n-1``): a tile batch or a whole-image uint8 batch is split into equal parts, one a
replica, each launched from a thread of its own (a forward launches thousands of kernels;
one thread would serialise the cards), and the outputs are gathered on card 0 in batch
order. The JAX twin's mesh semantics hold: ``tile_batch`` rounds up to a multiple of
``n_devices``, a single image takes the tiled path, ``u8_group_max`` is the mesh size and a
ragged group pads by repeating its last image. ``device="cpu"`` with ``n_devices=k`` serves
from k CPU replicas (the tests' stand-in for cards).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
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
from ..ops.kernels import _mma
from ..utils import profiling
from ..utils.convert import fusion_params_from_flax, load_torch_checkpoint
from ..utils.imageio import list_images, load_image, save_image
from ..utils.runtime import runtime_overrides
from .tiling import require_device, tiled_sr, whole_image_sr

# the JAX twin's defaults: 192-px tiles keep the overlap recompute low on DIV2K-sized
# images; 192 is a whole number of DAT's 32-px and HAT's 16-px windows
TILE = 192
OVERLAP = 32
TILE_BATCH = 2
#: precision -> whether f32 products and convolutions may take TF32: "highest" keeps f32
#: (the JAX twin's "highest"), "high" allows TF32 (PyTorch's own default for cuDNN convs),
#: "default" allows it too (the H100's default class; the TPU's is a bf16 pass)
PRECISIONS = {"highest": False, "high": True, "default": True}
#: precision -> the kernels' matmul operand dtype (``_mma.operands``; None: f32-exact
#: products): "default" rounds every kernel's operands to bf16, as the JAX package's Pallas
#: kernels do on f32 storage (``wattn._mxu_dtype``)
OPERANDS = {"highest": None, "high": None, "default": torch.bfloat16}
#: serving dtypes by name (``FREQFUSION_DTYPE``, ``main(dtype=...)``)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def pinned_precision(precision: str):
    """Sets both TF32 flags for `precision` ("highest": off, "high" and "default": on) and
    the kernels' operand dtype (``OPERANDS``), and restores the caller's on the way out."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}; expected one of {sorted(PRECISIONS)}")
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = PRECISIONS[precision]
    try:
        with _mma.operands(OPERANDS[precision]):
            yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class InferencePipeline:
    """Runs an SR module on one device: the card, unless the caller names another
    (``"cpu"``); without a card the default raises. Images run whole at 32-px buckets
    where the plan allows it, else as `tile_batch` tiles of `tile` x `tile` px a forward,
    `overlap` px shared between neighbours. `tile` must suit the model (a multiple of 16
    for HAT's windows; DAT pads to its 32-px windows by itself). `precision` is pinned
    around every forward, whole or tiled, and the caller's setting restored after it:
    "highest" runs f32 products and convolutions in f32, "high" lets them take TF32, and
    "default" (the JAX pipeline's default) rounds every kernel's matmul operands to bf16 on
    f32 storage and lets the glue take TF32.
    `dtype` (torch.float32 or torch.bfloat16) is the dtype of the parameters, the input and
    every activation; the output leaves as f32 (``run_image``) or uint8.
    `n_devices` replicas serve a batch together (module docstring); None means every card
    present for ``device="cuda"``, else one. More than the cards present raise, as does a
    model whose forward takes a batch mean (``FusionHead.takes_batch_mean``): its replicas
    would each take their own part's mean."""

    # JAX twin's default: 280000 px covers every DIV2K x4 LR frame after 32-px padding.
    # No cap on distinct buckets: the JAX twin's (6) bounds its compile cache, and eager
    # PyTorch compiles nothing per shape. A number here brings the cap back: past it an
    # image pads up to a bucket already in use, or takes the tiled path.
    WHOLE_IMAGE_MAX_PX = 280000
    WHOLE_IMAGE_MAX_SHAPES: Optional[int] = None

    def __init__(self, model: nn.Module, device="cuda", dtype: torch.dtype = torch.float32,
                 tile: int = TILE, overlap: int = OVERLAP, tile_batch: int = TILE_BATCH,
                 precision: str = "highest", n_devices: Optional[int] = None):
        if tile < 1 or not 0 <= overlap < tile or tile_batch < 1:
            raise ValueError(f"tiling: tile={tile}, overlap={overlap}, tile_batch={tile_batch}; "
                             "expected tile >= 1, 0 <= overlap < tile and tile_batch >= 1")
        if precision not in PRECISIONS:
            raise ValueError(f"precision={precision!r}; expected one of {sorted(PRECISIONS)}")
        if dtype not in DTYPES.values():
            raise ValueError(f"dtype={dtype}; expected torch.float32 or torch.bfloat16")
        self.precision = precision
        self.device = require_device(device)
        self.dtype = dtype
        self.devices = replica_devices(self.device, n_devices)
        self.n_devices = n = len(self.devices)
        if n > 1:
            if any(getattr(m, "takes_batch_mean", False) for m in model.modules()):
                raise ValueError(
                    f"n_devices={n}: this model's forward takes a mean over its batch (the "
                    "adaptive-band split with enable_multi_domain_freq off); its replicas "
                    "would each take their own part's mean. Serve it on one device")
            tile_batch = max(tile_batch, n)
            tile_batch += (-tile_batch) % n
            self.device = self.devices[0]
        self.tile, self.overlap, self.tile_batch = tile, overlap, tile_batch
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d) for d in self.devices[1:]]
        self._pool = concurrent.futures.ThreadPoolExecutor(n) if n > 1 else None
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

    def _pinned_precision(self):
        return pinned_precision(self.precision)

    def _run_replica(self, i: int, x: torch.Tensor, within=None) -> torch.Tensor:
        """Replica i's forward of x (moved to its device) -> SR on that device. `within`:
        the spans' parent and request (``profiling.current()``) in a replica's thread."""
        device = self.devices[i]
        with (torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()), \
                torch.inference_mode():
            if self.n_devices > 1:   # each replica moves its own part to its card
                with profiling.span("ff.upload", within, replica=i):
                    x = x.to(device, self.dtype, non_blocking=True)
            x = x.to(self.dtype)
            with profiling.span("ff.forward", within, replica=i):
                out = self.replicas[i](x)
        return out[0] if isinstance(out, tuple) else out

    def _forward_device(self, x: torch.Tensor) -> torch.Tensor:
        """[B,hp,wp,3] (on any device) -> SR [B,s*hp,s*wp,3] on the device (card 0 of the
        replicas). On several replicas B splits into equal parts, one a replica, each run
        from a thread of its own; the caller makes B a multiple of ``n_devices``."""
        with self._pinned_precision():
            if self.n_devices == 1:
                return self._run_replica(0, x)
            if len(x) % self.n_devices:
                raise ValueError(f"a batch of {len(x)} does not split over "
                                 f"{self.n_devices} replicas")
            within = profiling.current()
            futures = [self._pool.submit(self._run_replica, i, part, within)
                       for i, part in enumerate(x.chunk(self.n_devices))]
            outs = [f.result() for f in futures]
        with profiling.span("ff.gather"), torch.inference_mode():
            return torch.cat([o.to(self.device, non_blocking=True) for o in outs])

    def forward_batch(self, lrp: np.ndarray) -> torch.Tensor:
        """[B,hp,wp,3] float host batch -> SR [B,s*hp,s*wp,3] on the device (card 0 of the
        replicas), enqueued without waiting; B a multiple of ``n_devices``."""
        x = torch.from_numpy(np.ascontiguousarray(lrp, dtype=np.float32))
        if self.n_devices == 1:
            with profiling.span("ff.upload"):
                x = x.to(self.device, non_blocking=True)
        return self._forward_device(x)

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
        with profiling.span("ff.tiled"), torch.inference_mode():
            return tiled_sr(lr, self._forward_device, self.tile, self.overlap,
                            self.tile_batch, self.upscale, self.device)

    def run_tiled_u8(self, lr: np.ndarray) -> np.ndarray:
        """The tiled path's image as HWC uint8 on the host: round(clip(sr,0,1)*255) is
        taken on the device, like the whole-image path's."""
        return self._to_u8(self.run_tiled(lr)).cpu().numpy()

    @property
    def u8_group_max(self) -> int:
        """Images a whole-image dispatch on the replicas: the mesh size, as the JAX twin's
        (on one device ``main`` groups by ``FREQFUSION_U8_BATCH``: ``serving_options``)."""
        return self.n_devices

    def run_image(self, lr: np.ndarray) -> np.ndarray:
        """One HWC float image -> its SR image (float HWC, on the host): whole where the
        plan allows it, else tiled. On several replicas a single image takes the tiled path,
        as on the JAX twin's mesh: its tile batches split over the replicas."""
        h, w, _ = lr.shape
        plan = None if self.n_devices > 1 else self._whole_image_plan(h, w)
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
        (``run_tiled_u8``). On several replicas a group that the mesh size does not divide
        is padded by repeating its last image; only the real images come back."""
        if plan is None:
            plan = self._whole_image_plan(lrs[0].shape[0], lrs[0].shape[1])
            if plan is None:
                return None
        hp, wp = plan
        with profiling.span("ff.dispatch", images=len(lrs), bucket=(hp, wp)) as dispatch:
            with profiling.span("ff.pad"):
                lrp = self._pad(lrs, hp, wp)
                pad_b = (-len(lrs)) % self.n_devices
                if pad_b:
                    lrp = np.concatenate([lrp, np.repeat(lrp[-1:], pad_b, axis=0)])
            sr = self.forward_batch(lrp)
            with profiling.span("ff.to_u8"):
                u8 = self._to_u8(sr)
            done = None
            with profiling.span("ff.host_copy"):
                if u8.device.type == "cuda":
                    host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
                    host.copy_(u8, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host = u8
        request = getattr(dispatch, "request", None)   # for its materialize's span
        return host, done, [(a.shape[0], a.shape[1]) for a in lrs], request

    def materialize_u8(self, handle):
        """Handle -> list of HWC uint8 arrays, one per image, cropped to x`upscale`."""
        host, done, metas, request = handle
        with profiling.span("ff.materialize", (None, request)):
            if done is not None:
                done.synchronize()
        s = self.upscale
        arr = host.numpy()
        return [arr[i, : h * s, : w * s] for i, (h, w) in enumerate(metas)]


def replica_devices(device: torch.device, n_devices: Optional[int]) -> list:
    """The devices of `n_devices` replicas for `device`: None means every card for
    ``cuda`` without an index, else one; cards ``cuda:0`` .. ``cuda:n-1``, or the CPU (or
    `device`) repeated. Raises ``ValueError`` where fewer cards are present than asked for
    (nothing shrinks the mesh)."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_devices is None:
        n_devices = cards if device.type == "cuda" and device.index is None else 1
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: expected at least 1")
    if n_devices == 1:
        return [device]
    if device.type != "cuda":
        return [device] * n_devices
    if n_devices > cards:
        raise ValueError(f"requested {n_devices} devices but only {cards} card(s) present")
    return [torch.device("cuda", i) for i in range(n_devices)]


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


#: Where a native checkpoint of the head is looked for, in order (the JAX package's order)
NATIVE_CKPT = ["best_*.ckpt", "checkpoints/**/best_*.ckpt", "latest.ckpt",
               "checkpoints/**/latest.ckpt", "*.ckpt", "checkpoints/**/*.ckpt"]


def _msgpack_record(path: str) -> dict:
    """A flax msgpack file as nested dicts of numpy arrays, decoded without flax: ext code 1
    is an array packed as (shape, dtype name, raw bytes), 2 a complex (re, im), 3 a numpy
    scalar packed as an array."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(f"{path} is a checkpoint written by the JAX package (flax msgpack); "
                          "reading it needs the msgpack package") from e

    def array(data):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    def ext_hook(code, data):
        if code == 1:
            return array(data)
        if code == 2:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        if code == 3:
            return array(data)[()]
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)


def read_native_checkpoint(path: str) -> dict:
    """The head's state dict (the reference's torch keys) from a native ``.ckpt``: a zip
    archive is the port's own ``torch.save`` (``training/checkpoint.py``): its ``model``
    with the EMA weights (``ema_state``) in place of the parameters where training kept
    them, the weights that validation measured and best-K chose; a msgpack map is the JAX
    package's ``CheckpointManager`` file, whose ``params`` and ``batch_stats`` (under
    ``fusion`` where live training wrote them) map through
    ``utils/convert.py:fusion_params_from_flax``, as the JAX package serves them."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        record = torch.load(path, map_location="cpu", weights_only=True)
        sd = dict(record["model"])
        sd.update({k: v for k, v in (record.get("ema_state") or {}).items() if k in sd})
        return sd
    if head and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        record = _msgpack_record(path)
        params, stats = record.get("params", {}), record.get("batch_stats", {})
        params = params.get("fusion", params)
        stats = stats.get("fusion", stats)
        return fusion_params_from_flax(params, stats)
    raise ValueError(f"{path}: neither a torch.save archive nor a flax msgpack checkpoint")


def load_expert_checkpoints(model: nn.Module, model_dir: str) -> None:
    """The experts of `model` (a ``FreqFusionSR`` or a bare ``ExpertEnsemble``) from
    ``pretrained/{hat,dat,nafnet}/**/*.pth`` under `model_dir` (the reference's torch
    format; the ``nafnet.`` prefix of a NAFNetSR checkpoint is stripped); a missing file
    warns and keeps the expert's weights."""
    ens = getattr(model, "experts", model)
    experts = {"hat": (ens.hat, None), "dat": (ens.dat, None),
               "nafnet": (ens.nafnet.nafnet, "nafnet.")}
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


def load_checkpoints(model: FreqFusionSR, model_dir: str) -> None:
    """Fills `model` from the checkpoints under `model_dir`: the experts from their ``.pth``
    (``load_expert_checkpoints``); the head from a native ``.ckpt`` that training wrote
    (``best_*``, then ``latest``, then any: the JAX package's order;
    ``read_native_checkpoint``), else from the first other ``*.pth``. A missing file warns
    and keeps the module's seeded random weights."""
    load_expert_checkpoints(model, model_dir)
    native = _find(model_dir, NATIVE_CKPT)
    if native:
        _load_into(model.fusion, read_native_checkpoint(native), "fusion")
        return
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
                   precision: str = "highest",
                   dtype: torch.dtype = torch.float32,
                   n_devices: Optional[int] = None) -> InferencePipeline:
    """``FreqFusionSR`` with seeded initial weights, filled from `model_dir`'s checkpoints,
    behind an ``InferencePipeline`` on `device` (`n_devices` replicas) at `precision` and
    `dtype`. `expert_kwargs`
    may hold ``hat_kwargs``, ``dat_kwargs`` and ``nafnet_kwargs`` (tests build tiny experts
    with them)."""
    device = require_device(device)   # before the model is built: it takes seconds
    torch.manual_seed(0)
    model = FreqFusionSR(fusion_config or FusionConfig(), **(expert_kwargs or {}))
    load_checkpoints(model, model_dir)
    return InferencePipeline(model, device, dtype=dtype, tile=tile, overlap=overlap,
                             tile_batch=tile_batch, precision=precision, n_devices=n_devices)


def serving_options(**given) -> dict:
    """The serving options of ``main``: each keyword the caller gave (not None), else the JAX
    ``main``'s environment switch, else the default; the model and tiling from the
    ``FREQFUSION_CONFIG`` yaml (``runtime_overrides``) where the caller gave none.

    * ``dtype``: ``FREQFUSION_DTYPE`` (``float32`` | ``bfloat16``), default float32;
    * ``precision``: ``FREQFUSION_PRECISION`` (``highest`` | ``high`` | ``default``), default
      highest; ``default`` is the JAX pipeline's (bf16 operands on f32 storage);
    * ``group_max``: ``FREQFUSION_U8_BATCH``, default 1;
    * ``whole_image_px``, ``whole_image_shapes``: ``FREQFUSION_WHOLE_IMAGE_PX`` (0: every
      image tiled) and ``FREQFUSION_WHOLE_IMAGE_SHAPES`` (a cap on distinct buckets), default
      the pipeline's own (280000 px, no cap);
    * ``fusion_config``, ``expert_kwargs``: the yaml's ``model`` (its ``expert_kwargs``, the
      rest a ``FusionConfig``); ``tile``, ``overlap``, ``tile_batch``: its ``infer``.

    ``FREQFUSION_USE_PALLAS`` has no counterpart: the plain versions serve only CPU tensors,
    and with a card every kernel of the path runs."""
    env = os.environ.get
    out = dict.fromkeys(("fusion_config", "expert_kwargs", "whole_image_px",
                         "whole_image_shapes"))
    out.update(given)
    if out.get("dtype") is None:
        out["dtype"] = env("FREQFUSION_DTYPE", "float32")
    if isinstance(out["dtype"], str):
        if out["dtype"] not in DTYPES:
            raise ValueError(f"dtype={out['dtype']!r}; expected one of {sorted(DTYPES)}")
        out["dtype"] = DTYPES[out["dtype"]]
    if out.get("precision") is None:
        out["precision"] = env("FREQFUSION_PRECISION", "highest")
    if out["precision"] not in PRECISIONS:
        raise ValueError(f"precision={out['precision']!r}; expected one of {sorted(PRECISIONS)}")
    if out.get("group_max") is None:
        out["group_max"] = max(1, int(env("FREQFUSION_U8_BATCH", "1")))
    if out.get("whole_image_px") is None and env("FREQFUSION_WHOLE_IMAGE_PX"):
        out["whole_image_px"] = int(env("FREQFUSION_WHOLE_IMAGE_PX"))
    if out.get("whole_image_shapes") is None and env("FREQFUSION_WHOLE_IMAGE_SHAPES"):
        out["whole_image_shapes"] = int(env("FREQFUSION_WHOLE_IMAGE_SHAPES"))
    ov = runtime_overrides()
    if "model" in ov:
        m = dict(ov["model"])
        expert_kwargs = m.pop("expert_kwargs", None)
        if out.get("expert_kwargs") is None:
            out["expert_kwargs"] = expert_kwargs
        if m and out.get("fusion_config") is None:
            out["fusion_config"] = FusionConfig(**m)
    for k, default in (("tile", TILE), ("overlap", OVERLAP), ("tile_batch", TILE_BATCH)):
        if out.get(k) is None:
            out[k] = ov.get("infer", {}).get(k, default)
    return out


def main(model_dir: str, input_path: str, output_path: str, device="cuda", *,
         fusion_config: Optional[FusionConfig] = None, expert_kwargs: Optional[dict] = None,
         group_max: Optional[int] = None, tile: Optional[int] = None,
         overlap: Optional[int] = None, tile_batch: Optional[int] = None,
         precision: Optional[str] = None, dtype=None,
         whole_image_px: Optional[int] = None,
         whole_image_shapes: Optional[int] = None, n_devices: Optional[int] = None) -> int:
    """The challenge contract ``model_func(model_dir, input_path, output_path, device)``:
    super-resolves every image of the directory `input_path` into `output_path` under the
    same file name, and returns their number. The device is the card unless the caller
    names another; without a card the default raises.

    Consecutive images of one bucket are grouped, up to `group_max` a dispatch (one forward
    of that batch), and group i+1 is dispatched before group i is copied back and written.
    An image whose plan is the tiled path waits for what is pending, then runs as
    `tile_batch` tiles of `tile` px a forward (`overlap` px shared) and is written.
    `precision` ("highest": f32, the default; "high": TF32 allowed; "default": the JAX
    pipeline's bf16 matmul operands on f32 storage) holds inside every forward; `dtype`
    ("float32", the default, or "bfloat16", or the torch dtype) is the serving dtype. A keyword left None is read from the environment and the
    ``FREQFUSION_CONFIG`` yaml as the JAX ``main`` reads them (``serving_options``).
    `n_devices` (None: every card present) replicas serve each group, which then holds up
    to ``u8_group_max`` images, the mesh size (``InferencePipeline``)."""
    opt = serving_options(
        fusion_config=fusion_config, expert_kwargs=expert_kwargs, group_max=group_max,
        tile=tile, overlap=overlap, tile_batch=tile_batch, precision=precision, dtype=dtype,
        whole_image_px=whole_image_px, whole_image_shapes=whole_image_shapes)
    pipe = build_pipeline(model_dir, device, opt["fusion_config"], opt["expert_kwargs"],
                          opt["tile"], opt["overlap"], opt["tile_batch"], opt["precision"],
                          opt["dtype"], n_devices)
    group_max = pipe.u8_group_max if pipe.n_devices > 1 else opt["group_max"]
    if opt.get("whole_image_px") is not None:
        pipe.WHOLE_IMAGE_MAX_PX = opt["whole_image_px"]
    if opt.get("whole_image_shapes") is not None:
        pipe.WHOLE_IMAGE_MAX_SHAPES = opt["whole_image_shapes"]
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
