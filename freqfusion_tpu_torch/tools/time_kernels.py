"""Times the wrappers of B1, B2, B4, B5b, B6, B8 (and B8's attention alone) and B10 at the
shapes the serving path gives them, so that two checkouts can be compared on one card in one
call.

    python -m freqfusion_tpu_torch.tools.time_kernels      # from a checkout's root; a card

Only the public wrappers (and B8's two launchers) are called, so the script runs unchanged
from an older checkout's root: copy it there and run it from each tree in turn (parent,
change, change, parent). Inputs come from seed 0 on the card; each time is the mean of 10
launches after a warm-up, CUDA events, f32 with TF32 off. B2 at C = 64 is also timed in the
device-memory design of its wider levels (``on_chip=False``), where the tree has it. B1 is
also timed by its device time alone (torch.profiler, the kernels of 10 calls), which a small
image's launch, bound by the host, hides from the events. Prints one JSON line with the
times in ms and the card's name and power limit.
"""

from __future__ import annotations

import inspect
import json
import subprocess

import torch

from ..ops import windows
from ..ops.kernels import aim, nafblock, sgfn, wattn

# NAF's three fused levels at the 512x352 bucket, a ragged image and a chunk of two tiles
B1_SHAPES = {"c64": (1, 1408, 2048, 64), "c128": (1, 704, 1024, 128),
             "c256": (1, 352, 512, 256), "ragged": (2, 37, 45, 64),
             "tile": (2, 768, 768, 64)}
B2_SHAPES = {k: B1_SHAPES[k] for k in ("c64", "c128", "c256", "tile")}


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time of the kernels that fn() launches, a call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)

    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    out, dev = {}, {}
    with torch.no_grad():
        for name, (b, h, w, c) in B1_SHAPES.items():
            args = (r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                    r(c, 2 * c, std=c ** -0.5), r(2 * c, std=0.1), r(9, 2 * c, std=1 / 3),
                    r(2 * c, std=0.1))
            out[f"b1_{name}"] = cuda_ms(lambda: nafblock.naf_block_stage_a(*args))
            dev[f"b1_{name}"] = device_ms(lambda: nafblock.naf_block_stage_a(*args))
            del args
        for name, (b, h, w, c) in B2_SHAPES.items():
            args = (r(b, h, w, c), r(b, h, w, c), r(b, c, std=0.5, mean=1.0),
                    r(c, c, std=c ** -0.5), r(c, std=0.1), r(c, std=0.5),
                    r(c, std=0.1, mean=1.0), r(c, std=0.1), r(c, 2 * c, std=c ** -0.5),
                    r(2 * c, std=0.1), r(c, c, std=c ** -0.5), r(c, std=0.1), r(c, std=0.5))
            out[f"b2_{name}"] = cuda_ms(lambda: nafblock.naf_block_stage_b(*args))
            if c == 64 and "on_chip" in inspect.signature(nafblock.naf_block_stage_b).parameters:
                # the device-memory design of the wider levels, at C = 64
                out[f"b2_{name}_via_memory"] = cuda_ms(
                    lambda: nafblock.naf_block_stage_b(*args, on_chip=False))
            del args
        # DAT at the bucket: 180 channels, a branch's 3 heads of 30 in 8x32 / 32x8 windows;
        # AIM's S-Map 11 wide
        x = r(1, 352, 512, 180)
        g_args = (x, r(1, 352, 512, 180), r(1, 1, 1, 180), r(1, 1, 180, 11, std=180 ** -0.5),
                  r(11, std=0.1), r(11, std=0.2, mean=1.0), r(11, std=0.1),
                  r(1, 1, 11, 1, std=11 ** -0.5), r(1, std=0.1), r(180, 180, std=180 ** -0.5),
                  r(180, std=0.1))
        for swap in (False, True):
            out[f"b5b{'_swap' if swap else ''}"] = cuda_ms(
                lambda: aim.aim_gates_proj(*g_args, swap=swap))
        del g_args
        for hs, ws in ((8, 32), (32, 8)):
            for shifted in (False, True):
                mask = (torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2)
                                         .copy()).cuda() if shifted else None)
                args = (x, r(180, 270, std=180 ** -0.5), r(270, std=0.1),
                        r(3, 256, 256, std=0.5), mask, (hs, ws), 3)
                out[f"b4_{hs}x{ws}{'_shift' if shifted else ''}"] = cuda_ms(
                    lambda: wattn.fused_window_attention_xqkv(*args))
        c, hid = 180, 720
        t_args = (x, r(1, 352, 512, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid // 2, std=0.1, mean=1.0),
                  r(hid // 2, std=0.1), r(3, 3, 1, hid // 2, std=1 / 3), r(hid // 2, std=0.1),
                  r(hid // 2, c, std=(hid // 2) ** -0.5), r(c, std=0.1))
        out["b6"] = cuda_ms(lambda: sgfn.fused_sgfn_tail(*t_args))
        del t_args
        # HAT-L at the bucket: 6 heads of 30 in 16x16 windows, hidden 360
        hid = 360
        m_args = (x, r(1, 352, 512, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid, c, std=hid ** -0.5),
                  r(c, std=0.1))
        out["b10"] = cuda_ms(lambda: wattn.fused_residual_ln_mlp(*m_args))
        del m_args
        h_args = (x, r(1, 352, 512, c, std=3.0), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, std=0.1, mean=1.0), r(c, std=0.1), r(c, 3 * c, std=c ** -0.5),
                  r(3 * c, std=0.1), r(c, c, std=c ** -0.5), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid, c, std=hid ** -0.5),
                  r(c, std=0.1), r(6, 256, 256, std=0.5))
        types = torch.from_numpy(windows.shift_mask_types(16, 16, 8, 8).copy()).cuda()
        for case, mask, shift in (("", None, 0), ("_shift", types, 8)):
            kw = dict(cab_scale=r(1, 1, 1, c, std=0.2, mean=0.5), in_shift=shift)
            out[f"b8{case}"] = cuda_ms(
                lambda: wattn.fused_hab_block(*h_args, mask, (16, 16), 6, 0.01, **kw))
            attention, _, _ = wattn._hab_block_launchers(*h_args, mask, (16, 16), 6, 0.01,
                                                         **kw)
            out[f"b8_attention{case}"] = cuda_ms(attention)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "ms": out, "device_ms": dev}), flush=True)


if __name__ == "__main__":
    main()
