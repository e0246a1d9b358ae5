"""The system under test, driven as its serving entry drives it.

The model (a ``perfbench/models`` file builds it) is served behind ``infer.io.
InferencePipeline``; nothing else of the program is imported. Whole-image frames follow
``infer.io.main``'s loop with the decoded frames in memory: consecutive frames of one bucket
are grouped up to the group size, group i+1 is dispatched before group i is copied back. A
frame the whole-image plan refuses takes ``run_tiled_u8``, after what is pending has been
copied back.

``Hooks`` are forward hooks on each replica's modules. They keep the outputs of the sampled
requests for the check after the window (the model's output, and what the model file's
``taps`` pick), count the LR pixels each forward takes, and in a traced run put CUDA events
around the modules the model file's ``timed`` names.
"""

from __future__ import annotations

import time
from functools import partial

import torch
from torch.profiler import record_function


def build(model, cfg: dict, device, dtype, mix: dict, fill):
    """(pipeline, what ``fill(module)`` returns): `model`'s program (a ``perfbench/models``
    file) at the configuration's sizes, made on `device` and filled with its weights by
    `fill`, behind an InferencePipeline with the configuration's precision and the mix's
    tiling and replicas."""
    from freqfusion_tpu_torch.infer.io import InferencePipeline

    module = model.build(cfg, device)
    filled = fill(module)
    pipe = InferencePipeline(module, device=device, dtype=dtype, tile=mix.get("tile", 192),
                             overlap=mix.get("overlap", 32),
                             tile_batch=mix.get("tile_batch", 2), precision=cfg["precision"],
                             n_devices=mix.get("n_devices", 1))
    if "whole_image_px" in mix:   # main's whole_image_px option
        pipe.WHOLE_IMAGE_MAX_PX = mix["whole_image_px"]
    return pipe, filled


def _model_out(args, out):
    return {"sr": out[0] if isinstance(out, tuple) else out}


class Hooks:
    def __init__(self, pipe, model, sampled, timed: bool):
        self.sampled = set(sampled)
        self.rows = None            # request ids of the rows of the current dispatch
        self.frame = None           # the tiled frame being served
        self.chunk = -1             # its forward (chunk) counter
        self.batch = {}             # replica -> rows of its forward under way
        self.captured = {}          # key -> {"sr", and each name the taps pick}
        self.forwards = []          # (rows, h, w) of each replica forward in the window
        self.events = {}            # timed name -> [(start, end, LR px)]
        self.open = False           # True inside the window
        self.handles = []
        for r, m in enumerate(pipe.replicas):
            self.handles += [m.register_forward_pre_hook(partial(self._model_in, r)),
                             m.register_forward_hook(partial(self._keep, r, _model_out))]
            self.handles += [mod.register_forward_hook(partial(self._keep, r, pick))
                             for mod, pick in model.taps(m)]
            if timed:
                for name, mod in model.timed(m).items():
                    self.events.setdefault(name, [])
                    self.handles += [mod.register_forward_pre_hook(partial(self._start, name)),
                                     mod.register_forward_hook(partial(self._end, name))]

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []

    # keys of the rows a replica computes: a request id, or (frame, chunk, row)
    def _keys(self, r: int, k: int):
        if self.frame is not None:
            return [(self.frame, self.chunk, r * k + j) for j in range(k)]
        if self.rows is None:
            return [None] * k
        return self.rows[r * k:(r + 1) * k]

    def _wanted(self, key):
        if key is None:
            return False
        return (key[0] if isinstance(key, tuple) else key) in self.sampled

    def _model_in(self, r, module, args):
        x = args[0]
        self.batch[r] = x.shape[0]
        if r == 0 and self.frame is not None:
            self.chunk += 1
        if self.open:
            self.forwards.append((x.shape[0], x.shape[1], x.shape[2]))

    def _keep(self, r, pick, module, args, out):
        """Keeps the rows of the sampled requests of what `pick(args, out)` gives, by name;
        `pick` runs only where a row of this forward is sampled."""
        keys = self._keys(r, self.batch[r])
        if not any(self._wanted(key) for key in keys):
            return
        picked = pick(args, out)
        for j, key in enumerate(keys):
            if self._wanted(key):
                self.captured.setdefault(key, {}).update(
                    {n: x[j] for n, x in picked.items()})

    def _start(self, name, module, args):
        if self.open:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            module._perfbench_start = ev

    def _end(self, name, module, args, out):
        start = getattr(module, "_perfbench_start", None)
        if self.open and start is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            x = args[0]
            self.events[name].append((start, ev, x.shape[0] * x.shape[1] * x.shape[2]))
            module._perfbench_start = None

    def device_ms(self, name: str):
        """(device ms, LR px) of every timed forward of `name` in the window."""
        ms = sum(s.elapsed_time(e) for s, e, _ in self.events[name])
        return ms, sum(px for _, _, px in self.events[name])


def synchronize(pipe):
    for d in pipe.devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def warm(pipe, shapes, group_max: int, frame_of):
    """One forward of each shape the stream serves: a full group of each whole-image bucket,
    a tile-sized frame through the tiled path (one chunk of the served tile shape)."""
    seen = set()
    for i, (w, h) in enumerate(shapes):
        plan = pipe._whole_image_plan(h, w)
        key = ("tiled",) if plan is None else plan
        if key in seen:
            continue
        seen.add(key)
        lr = frame_of(i)
        if plan is None:
            pipe.run_tiled_u8(lr[: pipe.tile, : pipe.tile])
        else:
            pipe.materialize_u8(pipe.dispatch_batch_u8([lr] * group_max, plan))
    synchronize(pipe)


class Window:
    """What the window served: per request (id, LR shape, handed, done), the host spans of
    the dispatches, and the served uint8 images of the sampled requests."""

    def __init__(self):
        self.requests = []          # (id, (h, w), t_handed, t_done)
        self.dispatch = []          # (seconds, images)
        self.outputs = {}           # sampled id -> HWC uint8
        self.t0 = self.t1 = None


def serve_window(pipe, hooks, shapes, frame_of, seconds: float, group_max: int):
    """Runs the closed loop for `seconds`: no request is handed after that, and the window
    ends when the last one handed is on the host."""
    win = Window()
    pending = None
    group, group_plan = [], None

    def done(p):
        handle, items = p
        with record_function("serve.materialize"):
            arrs = pipe.materialize_u8(handle)
        now = time.perf_counter()
        for arr, (rid, hw, t_in) in zip(arrs, items):
            win.requests.append((rid, hw, t_in, now))
            if rid in hooks.sampled:
                win.outputs[rid] = arr.copy()

    def dispatch_group():
        nonlocal pending, group, group_plan
        if not group:
            return
        t_in = time.perf_counter()
        hooks.rows = [g[0] for g in group]
        hooks.rows += [None] * ((-len(group)) % pipe.n_devices)
        with record_function("serve.dispatch"):
            handle = pipe.dispatch_batch_u8([g[1] for g in group], group_plan)
        hooks.rows = None
        win.dispatch.append((time.perf_counter() - t_in, len(group)))
        if pending is not None:
            done(pending)
        pending = (handle, [(rid, lr.shape[:2], t_in) for rid, lr in group])
        group, group_plan = [], None

    hooks.open = True
    win.t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - win.t0 < seconds:
        w, h = shapes[i % len(shapes)]
        lr = frame_of(i % len(shapes))
        plan = pipe._whole_image_plan(h, w)
        if plan is None:
            dispatch_group()
            if pending is not None:
                done(pending)
                pending = None
            t_in = time.perf_counter()
            hooks.frame, hooks.chunk = i, -1
            with record_function("serve.tiled"):
                arr = pipe.run_tiled_u8(lr)
            hooks.frame = None
            now = time.perf_counter()
            win.requests.append((i, lr.shape[:2], t_in, now))
            if i in hooks.sampled:
                win.outputs[i] = arr
        else:
            if group and plan != group_plan:
                dispatch_group()
            group.append((i, lr))
            group_plan = plan
            if len(group) >= group_max:
                dispatch_group()
        i += 1
    dispatch_group()
    if pending is not None:
        done(pending)
    win.t1 = time.perf_counter()
    hooks.open = False
    return win
