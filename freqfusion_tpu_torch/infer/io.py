"""Whole-image serving of an SR module. Twin of ``freqfusion_tpu/infer/io.py``.

``InferencePipeline`` serves the ``nn.Module`` it is given (``NAFNetSR``, ``DAT`` or
``HAT``: any module that returns ``(sr, features)`` and has ``upscale``): each image is
reflect-padded to a 32-px bucket (a whole number of DAT's 32-px and of HAT's 16-px
windows), run whole, cropped, and converted to uint8 on the device. The batch protocol (``dispatch_batch_u8`` / ``materialize_u8``) lets a caller
dispatch image i+1 before it copies image i back. Images that the plan sends to the tiled
path are not served yet: tiling and ``model_func`` come with the ensemble.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn


class InferencePipeline:
    """Runs an SR module on whole images at 32-px buckets on one device: the card, unless
    the caller names another (``"cpu"``). Without a card the default raises."""

    # JAX twin's defaults: 280000 px covers every DIV2K x4 LR frame after 32-px padding;
    # at most 6 distinct buckets, after which images pad up to a bucket already in use
    WHOLE_IMAGE_MAX_PX = 280000
    WHOLE_IMAGE_MAX_SHAPES = 6

    def __init__(self, model: nn.Module, device="cuda", dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
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
        """(padded_h, padded_w) bucket for a whole-image dispatch (commits a shape-cache
        entry), or None when the image must take the tiled path (pixel budget,
        reflect-pad limit, or shape-cache cap)."""
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
        if (hp, wp) not in cache and len(cache) >= self.WHOLE_IMAGE_MAX_SHAPES:
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

    def _plan_or_raise(self, h: int, w: int):
        plan = self._whole_image_plan(h, w)
        if plan is None:
            raise NotImplementedError(
                f"a {w}x{h} image takes the tiled path, which the port does not serve "
                "yet (ROADMAP A7)")
        return plan

    def _forward(self, lrp: np.ndarray) -> torch.Tensor:
        """[B,hp,wp,3] float host batch -> SR [B,s*hp,s*wp,3] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(lrp, dtype=np.float32))
        x = x.to(self.device, self.dtype, non_blocking=True)
        with torch.inference_mode():
            out = self.model(x)
        return out[0] if isinstance(out, tuple) else out

    @staticmethod
    def _pad(lrs, hp: int, wp: int) -> np.ndarray:
        return np.stack([np.pad(a, [(0, hp - a.shape[0]), (0, wp - a.shape[1]), (0, 0)],
                                mode="reflect") for a in lrs])

    def run_image(self, lr: np.ndarray) -> np.ndarray:
        """One HWC float image -> its SR image (float HWC, on the host)."""
        h, w, _ = lr.shape
        hp, wp = self._plan_or_raise(h, w)
        sr = self._forward(self._pad([lr], hp, wp))[0]
        s = self.upscale
        return sr[: h * s, : w * s].float().cpu().numpy()

    def dispatch_batch_u8(self, lrs, plan=None):
        """Dispatches a same-bucket batch of HWC float images without waiting for it.

        Returns a handle for ``materialize_u8``: round(clip(sr,0,1)*255) as uint8 is
        computed on the device and its copy to (pinned) host memory is queued on the
        current stream."""
        if plan is None:
            plan = self._plan_or_raise(lrs[0].shape[0], lrs[0].shape[1])
        hp, wp = plan
        sr = self._forward(self._pad(lrs, hp, wp))
        with torch.inference_mode():
            u8 = torch.round(sr.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
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
