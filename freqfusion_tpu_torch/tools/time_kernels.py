"""Times the wrappers of B1, B2, B3, B4, B5a, B5b, B6 (and its two launches alone), B7, B8 (and
its attention and its tail alone), B9 (and its attention and its projection alone), B10, B11,
B12, B13 and B14 at the shapes the serving path gives them (B13 and B14 at the shapes of
PERF.md's table), so that two checkouts can be compared on one card in one call.

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
from ..ops.kernels import aim, bandmha, cab, conv3x3, lka, nafblock, sgfn, wattn

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
        # B5a at the bucket and on a chunk of two 192-px tiles
        for name, shape in (("bucket", (1, 352, 512, 180)), ("tile", (2, 192, 192, 180))):
            a_args = (r(*shape), r(3, 3, 1, 180, std=1 / 3), r(180, std=0.1),
                      r(180, std=0.2, mean=1.0), r(180, std=0.1))
            out[f"b5a_{name}"] = cuda_ms(lambda: aim.aim_conv_branch(*a_args))
            del a_args
        # B11 at the bucket: the head's 9 band tokens of 64 in 4 heads, and 3 tokens
        for t in (9, 3):
            m_args = (r(1, 352, 512, t, 64, std=0.6), r(64, 192, std=0.125), r(192, std=0.1),
                      r(64, 64, std=0.125), r(64, std=0.1), r(64, std=0.1, mean=1.0),
                      r(64, std=0.1), 4)
            out[f"b11_t{t}"] = cuda_ms(lambda: bandmha.fused_band_mha(*m_args))
            del m_args
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
        fc1, gate_fc2, _ = sgfn._sgfn_launchers(*t_args)
        out["b6_fc1"] = cuda_ms(fc1)
        out["b6_gate_fc2"] = cuda_ms(gate_fc2)
        del t_args
        # B3 (HAT's and DAT's 180 -> 180 convs) and B7 (HAT's CAB chain) at the bucket
        c_args = (x, r(3, 3, 180, 180, std=1620 ** -0.5), r(180, std=0.1))
        out["b3"] = cuda_ms(lambda: conv3x3.conv3x3_dense(*c_args))
        k_args = (x, r(180, std=0.1, mean=1.0), r(180, std=0.1), r(3, 3, 180, 60, std=1620 ** -0.5),
                  r(60, std=0.1), r(3, 3, 60, 180, std=540 ** -0.5), r(180, std=0.1))
        out["b7"] = cuda_ms(lambda: cab.cab_chain(*k_args))
        del c_args, k_args
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
            attention, tail, _, _ = wattn._hab_block_launchers(*h_args, mask, (16, 16), 6, 0.01,
                                                               **kw)
            out[f"b8_attention{case}"] = cuda_ms(attention)
            out[f"b8_tail{case}"] = cuda_ms(tail)
        del h_args
        # B9 at the bucket: 256 queries against 576 keys a window, 6 heads of 30
        o_args = (x, r(1, 352, 512, c), r(1, 352, 512, c), r(c, c, std=c ** -0.5),
                  r(c, std=0.1), r(6, 256, 576, std=0.5))
        out["b9"] = cuda_ms(lambda: wattn.fused_overlap_attention(*o_args, 16, 8, 6))
        attention, proj, _ = wattn._overlap_launchers(*o_args, 16, 8, 6)
        out["b9_attention"] = cuda_ms(attention)
        out["b9_proj"] = cuda_ms(proj)
        del o_args
        # B13 at DAT's branch (90 channels, 3 heads of 30) and B14 at HAT-L's width
        for name, (b, h, w, hs, ws) in (("", (1, 352, 512, 8, 32)),
                                        ("_chunk", (2, 192, 192, 32, 8))):
            qkv = [r(b, h, w, 90) for _ in range(3)]
            for shifted in (False, True):
                mask = (torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2)
                                         .copy()).cuda() if shifted else None)
                args = (*qkv, r(3, hs * ws, hs * ws, std=0.5), mask, (hs, ws), 3)
                out[f"b13{name}{'_shift' if shifted else ''}"] = cuda_ms(
                    lambda: wattn.fused_window_attention_qkv(*args))
            del qkv
        types = torch.from_numpy(windows.shift_mask_types(16, 16, 8, 8).copy()).cuda()
        w_args = (x, r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1), r(c, c, std=c ** -0.5),
                  r(c, std=0.1), r(6, 256, 256, std=0.5))
        for case, mask in (("", None), ("_shift", types)):
            out[f"b14{case}"] = cuda_ms(
                lambda: wattn.fused_window_attention(*w_args, mask, (16, 16), 6))
        del w_args, x
        # B12 at the head's 9 bands folded into the batch, and at the collaborative C = 128
        for name, (b, cc) in (("", (9, 64)), ("_c128", (3, 128))):
            l_args = (r(b, 352, 512, cc), r(5, 5, cc, std=0.2), r(21, cc, std=0.2),
                      r(21, cc, std=0.2), r(cc, cc, std=cc ** -0.5), r(cc, std=0.2, mean=1.0),
                      r(cc, std=0.1))
            out[f"b12{name}"] = cuda_ms(lambda: lka.lka_gate(*l_args))
            dev[f"b12{name}"] = device_ms(lambda: lka.lka_gate(*l_args))
            del l_args
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "ms": out, "device_ms": dev}), flush=True)


if __name__ == "__main__":
    main()
