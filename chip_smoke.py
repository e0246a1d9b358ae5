#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

Phases, each printing JSON lines; any failure raises and the exit code is not 0:
  1. device: the card (nvidia-smi name and power limit), TF32 off for every comparison;
  2. build: nvcc builds freqfusion_tpu_torch/csrc into a library (seconds printed), and
     ptxas -v must show every tensor-core kernel at <= 128 registers with no spill;
  3. kernels: each CUDA kernel against its plain PyTorch version at the slices' shapes,
     with its time, the plain version's, the card's bound for the same work and, where one
     PyTorch call computes the same function, that call's time; B6, B8 and B10 also at
     C = 256 and 384, above the 192 channels a row product stages at once, B5b at C = 256
     with a 16- and a 32-wide S-Map, B11 at D = 96 and 128; then every width and window
     that the JAX kernels take and the card once refused (`repair` lines: B1 and B2 at
     C = 32 and 48, B6 at hidden/2 = 400, B9 at window 32, B11 at D = 144 and 256, heads of
     96 and 65 tokens, B12 at C = 6, 130 and 400, B13 at 144 and 576 tokens and heads of 48
     and 96, B14 at window 12 with heads of 48; then B1 and B2 at C = 36, 44 and 100, B11 at
     D = 400 and 512, 65 tokens at D = 128 and 129 at D = 64, B12 at C = 1816 and 2048),
     each one launch of its kernel within the kernel bound of its plain version;
  4. NAF slice: NAFNetSR at its published width (random weights from a seed) serves three
     PNG requests through InferencePipeline's uint8 protocol; the forward is checked
     against the plain versions, every kernel must have been launched, and per-image
     times are taken for both paths;
  5. DAT slice: the same for DAT at its shipped width and depth (embed 180, 6 x 6 blocks,
     split (8, 32)), whose every block runs the window-attention, AIM and SGFN kernels;
     it also times the weight work that every forward repeats (host and device);
  6. HAT slice: the same for HAT-L at its full width and depth (embed 180, 12 groups of
     6 HAB + 1 OCAB, window 16), whose every HAB runs the CAB-chain and fused-block
     kernels and every OCAB the overlapping-attention and residual-MLP kernels;
  7. ensemble: FreqFusionSR at the shipped FusionConfig over the three full experts serves
     the same three requests through infer.io.main, from .pth checkpoints of seeded random
     weights that the script saved; the fusion head's band-attention and
     LKA-gate kernels must have launched once per image and every expert kernel as often as
     in its solo phase; the head's bands, the fused image and the output are checked against
     the plain versions, and the forward and the head alone are timed on both paths;
  8. tiled: the same FreqFusionSR through the submission runner (cli/test.py, which times
     infer.io.main and writes results.json) on three frames that each take another way in (640x480: over the whole-image pixel budget, 12 tiles of 192 px in 6
     chunks of 2; 40x30: smaller than its reflect padding, one tile, the chunk padded by
     repeat; 510x339: whole, in the same stream), then the 640x480 frame again at tile 176,
     whose tiles are not whole 32-px windows, so that every DAT spatial block launches the
     pre-projected window attention; launch counts are required exactly, the stitched uint8
     image within 1 LSB of the same tiles on the plain path, one chunk's fused image and
     output within the forward's bound; tiles, chunks, ms a chunk, s an image and peak
     memory are printed;
  9. hat_odd: HAT at HAT-L's width with a 15-px window on a 225x225 image (2 groups of
     6 HAB + OCAB): every HAB fails the fused gate (odd H, W) and launches the standalone
     window attention once, against the plain path;
 10. train: the training path at full width (train_slice): feature extraction with the
     full ExpertEnsemble, cached training through cli/train.py (the head's train steps
     launch no kernel, its validation forward B11 and B12), one cached step on the card
     against the CPU and 20 steps whose loss must fall (ms a step, images a second, peak
     memory), live training through cli/train.py (every expert kernel in every step, no
     expert parameter changed), and the trained checkpoint served through infer.io.main
     within 1 LSB of the model in memory.
With --profile [dat|hat|ens|head|tiled] (or several, comma-separated: --profile hat,ens),
one forward of each model named (DAT if none is named; `head` is the fusion head alone on
fixed expert outputs, `tiled` one chunk of two 192-px tiles on the kernel path and on the
plain path) is also traced with torch.profiler and its device time is printed by kernel. The last two lines are the kernels' summary and
{"ok": true, "device": {...}}. It exits non-zero without a CUDA card. The PNGs go to
build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings
from statistics import fmean as mean

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from freqfusion_tpu_torch.cli import test as cli_test
from freqfusion_tpu_torch.infer.io import InferencePipeline, build_pipeline
from freqfusion_tpu_torch.infer.io import main as serve_directory
from freqfusion_tpu_torch.infer.tiling import num_tiles
from freqfusion_tpu_torch.models import dat as dat_model
from freqfusion_tpu_torch.models.dat import DAT
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.hat import HAT
from freqfusion_tpu_torch.models.nafnet import NAFNetSR
from freqfusion_tpu_torch.ops import windows
from freqfusion_tpu_torch.ops.kernels import (_build, _mma, aim, bandmha, cab, conv3x3, lka,
                                              nafblock, sgfn, wattn)
from freqfusion_tpu_torch.utils.imageio import list_images, load_image, save_image

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
SEED = 0
REQUESTS = [(510, 339), (450, 300), (400, 270)]   # W x H, DIV2K-class x4 LR frames
KERNEL_ATOL = 1e-4       # max |kernel - plain| on g and on the block / conv output
SUMS_RTOL = 1e-5         # |Δ sums_c| <= SUMS_RTOL * Σ|g_c|: the sums add in another order
SLICE_RTOL = 1e-3        # max |Δ| <= SLICE_RTOL * max|plain| on the whole forward
# (name, B, H, W, C): the NAF levels of the 512x352 bucket at HR, one ragged case, and the
# first level of a chunk of two 192-px tiles. Every list below ends in such "tile" cases:
# the shapes that the tiled path gives each kernel, at batch 2.
BLOCK_CASES = [("enc0_hr", 1, 1408, 2048, 64), ("enc1", 1, 704, 1024, 128),
               ("enc2", 1, 352, 512, 256), ("ragged", 2, 37, 45, 64),
               ("tile_hr", 2, 768, 768, 64)]
# "dat_180" is DAT's group-ending conv at the 512x352 bucket: the summary's B3 numbers
CONV_CASES = [("intro", 1, 1408, 2048, 3, 64), ("ending", 1, 1408, 2048, 64, 3),
              ("dat_180", 1, 352, 512, 180, 180), ("tile_180", 2, 192, 192, 180, 180)]
# DAT at the 512x352 bucket (embed 180, 3 heads of 30 a branch, hidden 720), a ragged case
# for the halos and a small multi-batch case for the windows
DAT_C, DAT_HEADS, DAT_HIDDEN = 180, 3, 720
DAT_CASES = [("bucket", 1, 352, 512), ("ragged", 2, 37, 45), ("tile", 2, 192, 192),
             ("tile176", 2, 176, 176)]
WATTN_CASES = [("8x32", 1, 352, 512, 8, 32, False), ("8x32_shift", 1, 352, 512, 8, 32, True),
               ("32x8", 1, 352, 512, 32, 8, False), ("32x8_shift", 1, 352, 512, 32, 8, True),
               ("batch2", 2, 64, 96, 8, 32, True), ("tile", 2, 192, 192, 32, 8, True)]
# HAT-L at the 512x352 bucket (embed 180, 6 heads of 30, window 16, OCAB window 24, CAB mid
# 60, hidden 360): (name, B, H, W); "batch2" is a few windows, "ragged" takes any H, W
HAT_C, HAT_HEADS, HAT_WINDOW, HAT_OVERLAP, HAT_MID, HAT_HIDDEN = 180, 6, 16, 8, 60, 360
HAT_CASES = [("bucket", 1, 352, 512), ("batch2", 2, 32, 48), ("ragged", 2, 37, 45),
             ("tile", 2, 192, 192), ("tile176", 2, 176, 176)]
# the fusion head at the 512x352 bucket: 9 band tokens of 64 (4 heads) a pixel; the LKA gate
# on the 9 bands folded into the batch, and at the collaborative branch's C = 128
MHA_CASES = [("bucket", 1, 352, 512, 9, 64, 4), ("t3", 1, 352, 512, 3, 64, 4),
             ("ragged", 2, 37, 45, 9, 64, 4), ("d32", 1, 16, 24, 3, 32, 2),
             ("tile", 2, 192, 192, 9, 64, 4), ("d96", 1, 176, 256, 9, 96, 4),
             ("d128", 1, 176, 256, 9, 128, 2)]
LKA_CASES = [("bucket", 9, 352, 512, 64), ("c128", 3, 352, 512, 128),
             ("ragged", 2, 37, 45, 64), ("h10", 1, 10, 50, 64), ("tile", 18, 192, 192, 64)]
# B13 at DAT's branch width (90 channels, 3 heads of 30): the table's shape and a chunk of two
# 176-px tiles padded to 192; B14 at HAT-L's width: the 15-px window of the hat_odd path (225
# tokens) and the table's shape. (name, B, H, W, hs, ws, shifted); "table*" feed the summary.
QKV_CASES = [("table", 1, 352, 512, 8, 32, False), ("table_shift", 1, 352, 512, 8, 32, True),
             ("tile", 2, 192, 192, 8, 32, False), ("tile_shift", 2, 192, 192, 32, 8, True)]
WIN_CASES = [("table", 1, 352, 512, 16, 16, False), ("table_shift", 1, 352, 512, 16, 16, True),
             ("odd", 1, 225, 225, 15, 15, False), ("odd_shift", 1, 225, 225, 15, 15, True)]
# B6, B8 and B10 above the 192 channels that a row product stages at once (ROADMAP C7)
WIDE_ROWS = (256, 384)
TILED_REQUESTS = [(640, 480), (40, 30), (510, 339)]   # W x H: tiled, tiled (tiny), whole
RAGGED_TILE = 176   # whole 16-px windows (HAT) but not whole 32-px ones (DAT)
# H100 SXM: f32 outside the tensor cores, f32-exact products on them (3xTF32: three TF32
# products at 495 TFLOP/s each), HBM3
PEAK_FLOPS, PEAK_TC, PEAK_BYTES = 67e12, 495e12 / 3, 3.35e12


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds of fn() over `iters` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, tc_flops: float = 0.0) -> tuple:
    """(least milliseconds the card could take, what sets it): the largest of the
    operations on the CUDA cores over the f32 peak, the f32-exact products on the tensor
    cores (`tc_flops`, 3xTF32) over their peak, and the bytes (each input read once, each
    output written once) over the memory rate."""
    t_ops = max(flops / PEAK_FLOPS, tc_flops / PEAK_TC)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bounds(flops: float, tc_flops: float, nbytes: float) -> tuple:
    """(bound of a kernel whose products (`tc_flops`) run f32-exact on the tensor cores and
    the rest (`flops`) on the CUDA cores, bound of the same work all on the CUDA cores)."""
    return bound_ms(flops, nbytes, tc_flops), bound_ms(flops + tc_flops, nbytes)


def block_params(c: int, gen: torch.Generator) -> dict:
    """Random NAFBlock parameters in the fused layouts; β, γ and every bias non-zero
    (β = γ = 0 would make the block the identity and the check compare nothing)."""
    def r(*shape, std, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")
    p = dict(ln1_w=r(c, std=0.1, mean=1.0), ln1_b=r(c, std=0.1),
             w1=r(c, 2 * c, std=c ** -0.5), b1=r(2 * c, std=0.1),
             wdw=r(9, 2 * c, std=1 / 3), bdw=r(2 * c, std=0.1),
             sca_w=r(c, c, std=c ** -0.5), sca_b=r(c, std=0.1),
             w3=r(c, c, std=c ** -0.5), b3=r(c, std=0.1), beta=r(c, std=0.5),
             ln2_w=r(c, std=0.1, mean=1.0), ln2_b=r(c, std=0.1),
             w4=r(c, 2 * c, std=c ** -0.5), b4=r(2 * c, std=0.1),
             w5=r(c, c, std=c ** -0.5), b5=r(c, std=0.1), gamma=r(c, std=0.5))
    return p


def randomize_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: convs N(0, 1/fan_in), LN weights N(1, 0.1), biases
    N(0, 0.02), and non-zero β/γ N(0, 0.1). The `ending` conv is scaled by 0.1 more, so
    that the output stays near its bicubic input and mostly inside (0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("beta", "gamma"):
                std, mean = 0.1, 0.0
            elif p.dim() == 4:
                std, mean = (p[0].numel()) ** -0.5, 0.0
                if name.startswith("nafnet.ending."):
                    std *= 0.1
            elif ".norm" in name and leaf == "weight":
                std, mean = 0.1, 1.0
            else:
                std, mean = 0.02, 0.0
            p.copy_(mean + std * torch.randn(p.shape, generator=gen))


def set_kernels(model: torch.nn.Module, on: bool) -> None:
    for m in model.modules():
        if hasattr(m, "kernels"):
            m.kernels = on


LAUNCH_COUNTS = (nafblock.launches, conv3x3.launches, wattn.launches, aim.launches,
                 sgfn.launches, cab.launches, bandmha.launches, lka.launches)


def reset_launches() -> None:
    for counts in LAUNCH_COUNTS:
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    return {k: n for counts in LAUNCH_COUNTS for k, n in counts.items()}


def phase_device() -> tuple:
    """Returns (torch's device name, nvidia-smi's "name, power limit" line)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check "
                         "runs only on an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


# the tensor-core kernels (every instantiation): at most 128 registers a thread (16 warps an
# SM, or two blocks of 8) and no spill
TC_KERNELS = ("conv3x3_gemm_kernel", "xqkv_attention_kernel", "oca_attn_kernel",
              "wattn_qkv_kernel", "sgfn_gate_fc2_kernel", "rows_kernel", "naf_stage_a_kernel",
              "naf_stage_b_onchip_kernel", "naf_stage_b_rows_kernel", "aim_gates_proj_kernel",
              "band_mha_kernel", "lka_mix_kernel")


def ptxas_report(log: str) -> list:
    """[(mangled kernel name, registers, spill bytes stored + loaded)] from ptxas -v."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def phase_build() -> None:
    path, secs, log = _build.build()
    report = ptxas_report(log)
    _build.library()
    emit("build", seconds=secs, library=os.path.relpath(path, ROOT),
         ptxas=[dict(kernel=k[:96], registers=r, spill_bytes=sp) for k, r, sp in report])
    tc = [(k, r, sp) for k, r, sp in report if any(t in k for t in TC_KERNELS)]
    for t in TC_KERNELS:
        require(any(t in k for k, _, _ in tc), f"ptxas -v reports no {t}")
    for k, r, sp in tc:
        require(r <= 128 and sp == 0, f"{k}: {r} registers, {sp} bytes of spill")


def naf_kernel_cases(gen: torch.Generator, res: dict) -> None:
    for name, b, h, w, c in BLOCK_CASES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda")
        p = block_params(c, gen)
        a_args = (x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"], p["wdw"], p["bdw"])
        g, sums = nafblock.naf_block_stage_a(*a_args)
        g_ref, sums_ref = nafblock.naf_block_stage_a_plain(*a_args)
        att = (sums_ref / (h * w)) @ p["sca_w"] + p["sca_b"]
        b_args = (g_ref, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"], p["ln2_b"],
                  p["w4"], p["b4"], p["w5"], p["b5"], p["gamma"])
        y = nafblock.naf_block_stage_b(*b_args)
        y_ref = nafblock.naf_block_stage_b_plain(*b_args)
        full = nafblock.fused_naf_block(x, p)
        full_ref = nafblock.fused_naf_block_plain(x, p)
        torch.cuda.synchronize()
        g_err = (g - g_ref).abs().max().item()
        sums_ratio = ((sums - sums_ref).abs() / g_ref.abs().sum((1, 2))).max().item()
        y_err = max((y - y_ref).abs().max().item(), (full - full_ref).abs().max().item())
        t = dict(a_ms=cuda_ms(lambda: nafblock.naf_block_stage_a(*a_args)),
                 a_plain_ms=cuda_ms(lambda: nafblock.naf_block_stage_a_plain(*a_args)),
                 b_ms=cuda_ms(lambda: nafblock.naf_block_stage_b(*b_args)),
                 b_plain_ms=cuda_ms(lambda: nafblock.naf_block_stage_b_plain(*b_args)))
        npix = b * h * w
        # stage A: the 1x1 product C->2C on the tensor cores; LN, depthwise 3x3 on 2C and the
        # gate on CUDA cores; reads x, writes g and the sums
        a_bound, a_bound32 = bounds(npix * (36 * c + 9 * c), npix * 4 * c * c,
                                    4 * (2 * npix * c + 2 * c * c + 24 * c + b * c))
        # stage B: three 1x1 products (C->C, C->2C, C->C) on the tensor cores; LN, gate and
        # residuals on CUDA cores; reads g, x, writes out
        b_bound, b_bound32 = bounds(npix * 16 * c, npix * 8 * c * c,
                                    4 * (3 * npix * c + 4 * c * c + 9 * c + b * c))
        emit("kernel", kernel="naf_block", case=name, shape=[b, h, w, c],
             g_max_abs_err=g_err, g_bound=KERNEL_ATOL,
             sums_max_rel_err=sums_ratio, sums_bound=SUMS_RTOL,
             out_max_abs_err=y_err, out_bound=KERNEL_ATOL, a_bound_ms=a_bound[0],
             a_bound_by=a_bound[1], a_bound_f32_ms=a_bound32[0], b_bound_ms=b_bound[0],
             b_bound_by=b_bound[1], b_bound_f32_ms=b_bound32[0], **t)
        require(g_err <= KERNEL_ATOL, f"B1 g error {g_err} at {name}")
        require(sums_ratio <= SUMS_RTOL, f"B1 sums error {sums_ratio} at {name}")
        require(y_err <= KERNEL_ATOL, f"B2 output error {y_err} at {name}")
        res["naf_block_stage_a"]["err"] = max(res["naf_block_stage_a"]["err"], g_err)
        res["naf_block_stage_b"]["err"] = max(res["naf_block_stage_b"]["err"], y_err)
        if name == "enc0_hr":   # the heaviest level: the summary's times
            res["naf_block_stage_a"].update(ms=t["a_ms"], plain_ms=t["a_plain_ms"],
                                            bound=a_bound, bound_f32=a_bound32)
            res["naf_block_stage_b"].update(ms=t["b_ms"], plain_ms=t["b_plain_ms"],
                                            bound=b_bound, bound_f32=b_bound32)
        del x, g, g_ref, y, y_ref, full, full_ref
    for name, b, h, w, cin, cout in CONV_CASES:
        x = torch.randn(b, h, w, cin, generator=gen, device="cuda")
        wt = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
        bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")
        err = (conv3x3.conv3x3_dense(x, wt, bias)
               - conv3x3.conv3x3_dense_plain(x, wt, bias)).abs().max().item()
        ms = cuda_ms(lambda: conv3x3.conv3x3_dense(x, wt, bias))
        plain_ms = cuda_ms(lambda: conv3x3.conv3x3_dense_plain(x, wt, bias))
        # the library call alone: cuDNN on the same tensors, f32 (TF32 off), NCHW views
        xv, wv = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        lib_ms = cuda_ms(lambda: F.conv2d(xv, wv, bias, padding=1))
        # the wide case's products run on the tensor cores, the narrow kernel's on CUDA cores
        prod = b * h * w * 18 * cin * cout
        wide = min(cin, cout) >= 32
        bnd, bnd_f32 = bounds(0.0 if wide else prod, prod if wide else 0.0,
                              4 * (b * h * w * (cin + cout) + 9 * cin * cout + cout))
        emit("kernel", kernel="conv3x3_dense", case=name, shape=[b, h, w, cin, cout],
             max_abs_err=err, bound=KERNEL_ATOL, ms=ms, plain_ms=plain_ms,
             library_cudnn_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1],
             bound_f32_ms=bnd_f32[0])
        require(err <= KERNEL_ATOL, f"B3 error {err} at {name}")
        r = res["conv3x3_dense"]
        r["err"] = max(r["err"], err)
        if name == "dat_180":   # the heaviest use: the summary's times
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound=bnd, bound_f32=bnd_f32)
        del x


def dat_kernel_cases(gen: torch.Generator, res: dict) -> None:
    """B4, B5a, B5b and B6 at DAT's full width. Bounds as for the NAF kernels: outputs of
    O(1) within KERNEL_ATOL of the plain version, sums within SUMS_RTOL * sum|.|."""
    c, heads, hid = DAT_C, DAT_HEADS, DAT_HIDDEN
    half, mid, co = hid // 2, c // 16, c // 2
    hd = co // heads

    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    times = []
    for name, b, h, w, hs, ws, shifted in WATTN_CASES:
        n = hs * ws
        x = r(b, h, w, c)   # the block's LayerNorm output: O(1)
        # the mask as the model hands it over, its 4 window types on the card; the small
        # case takes the whole image's numpy mask, which the wrapper reduces and checks
        mask = None
        if shifted and name == "batch2":
            mask = windows.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
        elif shifted:
            mask = torch.from_numpy(
                windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()
        args = (x, r(c, 3 * co, std=c ** -0.5), r(3 * co, std=0.1), r(heads, n, n, std=0.5),
                mask, (hs, ws), heads)
        got = wattn.fused_window_attention_xqkv(*args)
        want = wattn.fused_window_attention_xqkv_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: wattn.fused_window_attention_xqkv(*args), iters=5)
        plain_ms = cuda_ms(lambda: wattn.fused_window_attention_xqkv_plain(*args), iters=5)
        npix, nwin = b * h * w, b * (h // hs) * (w // ws)
        # products on the tensor cores: the projection, q k^T and p v; the rest: bias
        # (+ mask) and softmax; reads x, the weights, the bias and the 4 mask types, writes
        # the co-wide image
        bnd, bnd32 = bounds(nwin * heads * n * n * 8,
                            npix * 2 * c * 3 * co + nwin * heads * n * n * 4 * hd,
                            4 * (npix * (c + co) + c * 3 * co + 3 * co
                                 + (heads + (4 if shifted else 0)) * n * n))
        emit("kernel", kernel="fused_window_attention_xqkv", case=name,
             shape=[b, h, w, c], window=[hs, ws], shifted=shifted, max_abs_err=err,
             bound=KERNEL_ATOL, max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
             bound_ms=bnd[0], bound_by=bnd[1], bound_f32_ms=bnd32[0])
        require(err <= KERNEL_ATOL, f"B4 error {err} at {name}")
        res["fused_window_attention_xqkv"]["err"] = max(
            res["fused_window_attention_xqkv"]["err"], err)
        if b == 1:   # the bucket's mix: both orientations, half shifted
            times.append((ms, plain_ms, bnd, bnd32))
        del x, args
    res["fused_window_attention_xqkv"].update(
        ms=mean(t[0] for t in times), plain_ms=mean(t[1] for t in times),
        bound=(mean(t[2][0] for t in times), times[0][2][1]),
        bound_f32=(mean(t[3][0] for t in times), times[0][3][1]))

    for name, b, h, w in DAT_CASES:
        npix = b * h * w
        v, att, chmap = r(b, h, w, c), r(b, h, w, c), r(b, 1, 1, c)
        a_args = (v, r(3, 3, 1, c, std=1 / 3), r(c, std=0.1), r(c, std=0.2, mean=1.0),
                  r(c, std=0.1))
        cx, sums = aim.aim_conv_branch(*a_args)
        cx_ref, sums_ref = aim.aim_conv_branch_plain(*a_args)
        torch.cuda.synchronize()
        a_err = (cx - cx_ref).abs().max().item()
        sums_ratio = ((sums - sums_ref).abs()
                      / cx_ref.abs().sum((1, 2), keepdim=True)).max().item()
        a_ms = cuda_ms(lambda: aim.aim_conv_branch(*a_args))
        a_plain = cuda_ms(lambda: aim.aim_conv_branch_plain(*a_args))
        # 9 FMAs, the BN affine and an erf GELU per element; reads v, writes conv_x
        a_bnd = bound_ms(npix * c * 30, 4 * (2 * npix * c + 12 * c + b * c))
        emit("kernel", kernel="aim_conv_branch", case=name, shape=[b, h, w, c],
             max_abs_err=a_err, bound=KERNEL_ATOL, sums_max_rel_err=sums_ratio,
             sums_bound=SUMS_RTOL, ms=a_ms, plain_ms=a_plain, bound_ms=a_bnd[0],
             bound_by=a_bnd[1])
        require(a_err <= KERNEL_ATOL, f"B5a error {a_err} at {name}")
        require(sums_ratio <= SUMS_RTOL, f"B5a sums error {sums_ratio} at {name}")
        res["aim_conv_branch"]["err"] = max(res["aim_conv_branch"]["err"], a_err)
        del cx, v

        b_args = (att, cx_ref, chmap, r(1, 1, c, mid, std=c ** -0.5), r(mid, std=0.1),
                  r(mid, std=0.2, mean=1.0), r(mid, std=0.1), r(1, 1, mid, 1, std=mid ** -0.5),
                  r(1, std=0.1), r(c, c, std=c ** -0.5), r(c, std=0.1))
        # proj (C->C) on the tensor cores; the S-Map (C->mid->1), the two gates and the sum
        # on CUDA cores; reads attened, conv_x, writes out
        b_bnd, b_bnd32 = bounds(npix * (2 * c * mid + 2 * mid + 8 * c), npix * 2 * c * c,
                                4 * (3 * npix * c + b * c + c * mid + c * c + 3 * mid + c + 2))
        b_times = []
        for swap in (False, True):
            got = aim.aim_gates_proj(*b_args, swap=swap)
            want = aim.aim_gates_proj_plain(*b_args, swap=swap)
            torch.cuda.synchronize()
            b_err = (got - want).abs().max().item()
            del got, want
            b_ms = cuda_ms(lambda: aim.aim_gates_proj(*b_args, swap=swap))
            b_plain = cuda_ms(lambda: aim.aim_gates_proj_plain(*b_args, swap=swap))
            emit("kernel", kernel="aim_gates_proj", case=name, swap=swap,
                 shape=[b, h, w, c], max_abs_err=b_err, bound=KERNEL_ATOL, ms=b_ms,
                 plain_ms=b_plain, bound_ms=b_bnd[0], bound_by=b_bnd[1],
                 bound_f32_ms=b_bnd32[0])
            require(b_err <= KERNEL_ATOL, f"B5b error {b_err} at {name}, swap={swap}")
            res["aim_gates_proj"]["err"] = max(res["aim_gates_proj"]["err"], b_err)
            b_times.append((b_ms, b_plain))
        del att, cx_ref, b_args

        if name == "bucket":   # above the 192 channels a row is staged at once (ROADMAP C9)
            res["aim_gates_proj"]["err"] = max(res["aim_gates_proj"]["err"],
                                               aim_wide_cases(r, b, h // 2, w // 2))

        t_args = (r(b, h, w, c), r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(half, std=0.1, mean=1.0),
                  r(half, std=0.1), r(3, 3, 1, half, std=1 / 3), r(half, std=0.1),
                  r(half, c, std=half ** -0.5), r(c, std=0.1))
        got = sgfn.fused_sgfn_tail(*t_args)
        want = sgfn.fused_sgfn_tail_plain(*t_args)
        torch.cuda.synchronize()
        t_err = (got - want).abs().max().item()
        t_scale = want.abs().max().item()
        del got, want
        t_ms = cuda_ms(lambda: sgfn.fused_sgfn_tail(*t_args), iters=5)
        t_plain = cuda_ms(lambda: sgfn.fused_sgfn_tail_plain(*t_args), iters=5)
        # the two launches apart: fc1 with both LNs, then the gate and fc2
        fc1, gate_fc2, _ = sgfn._sgfn_launchers(*t_args)
        fc1_ms, gate_fc2_ms = cuda_ms(fc1, iters=5), cuda_ms(gate_fc2, iters=5)
        # products on the tensor cores: fc1 C->hid, fc2 hid/2->C; the rest: two LNs, GELU on
        # hid, depthwise 3x3 and gate on hid/2; reads a and shortcut, writes out
        t_bnd, t_bnd32 = bounds(npix * (8 * c + 10 * hid + 28 * half),
                                npix * (2 * c * hid + 2 * half * c),
                                4 * (3 * npix * c + c * hid + half * c + hid + 13 * half + 3 * c))
        emit("kernel", kernel="fused_sgfn_tail", case=name, shape=[b, h, w, c],
             hidden=hid, max_abs_err=t_err, bound=KERNEL_ATOL, max_abs_plain=t_scale,
             ms=t_ms, plain_ms=t_plain, fc1_ms=fc1_ms, gate_fc2_ms=gate_fc2_ms,
             bound_ms=t_bnd[0], bound_by=t_bnd[1], bound_f32_ms=t_bnd32[0])
        require(t_err <= KERNEL_ATOL, f"B6 error {t_err} at {name}")
        res["fused_sgfn_tail"]["err"] = max(res["fused_sgfn_tail"]["err"], t_err)
        del t_args
        if name == "bucket":   # the summary's times
            res["aim_conv_branch"].update(ms=a_ms, plain_ms=a_plain, bound=a_bnd)
            res["aim_gates_proj"].update(ms=mean(t[0] for t in b_times),
                                         plain_ms=mean(t[1] for t in b_times), bound=b_bnd,
                                         bound_f32=b_bnd32)
            res["fused_sgfn_tail"].update(ms=t_ms, plain_ms=t_plain, bound=t_bnd,
                                          bound_f32=t_bnd32,
                                          extra=dict(fc1_ms=fc1_ms, gate_fc2_ms=gate_fc2_ms))


def aim_wide_cases(r, b: int, h: int, w: int) -> float:
    """B5b at C = 256 with the S-Map 16 and 32 wide (the projection's K in two pieces, the
    S-Map in groups of 12), both wirings: within KERNEL_ATOL of plain; timed, not the
    summary's times. Returns the largest error."""
    c, worst = 256, 0.0
    for mid in (16, 32):
        args = (r(b, h, w, c), r(b, h, w, c), r(b, 1, 1, c), r(1, 1, c, mid, std=c ** -0.5),
                r(mid, std=0.1), r(mid, std=0.2, mean=1.0), r(mid, std=0.1),
                r(1, 1, mid, 1, std=mid ** -0.5), r(1, std=0.1), r(c, c, std=c ** -0.5),
                r(c, std=0.1))
        for swap in (False, True):
            got = aim.aim_gates_proj(*args, swap=swap)
            want = aim.aim_gates_proj_plain(*args, swap=swap)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            del got, want
            emit("kernel", kernel="aim_gates_proj", case=f"c256_mid{mid}", swap=swap,
                 shape=[b, h, w, c], pieces=_mma.piece_sizes(c), max_abs_err=err,
                 bound=KERNEL_ATOL, ms=cuda_ms(lambda: aim.aim_gates_proj(*args, swap=swap)))
            require(err <= KERNEL_ATOL, f"B5b error {err} at C = 256, mid {mid}, swap={swap}")
            worst = max(worst, err)
    return worst


def hat_kernel_cases(gen: torch.Generator, res: dict) -> None:
    """B7, B8, B9 and B10 at HAT-L's full width, with the bounds of the other kernels:
    outputs within KERNEL_ATOL of the plain version, sums within SUMS_RTOL * sum|.|. The
    summary's times are those of the bucket: for B7 and B8 the mean of the unshifted and the
    shifted call, which the main path makes equally often."""
    c, heads, ws, ov, mid, hid = HAT_C, HAT_HEADS, HAT_WINDOW, HAT_OVERLAP, HAT_MID, HAT_HIDDEN
    n, nk, hd, s = ws * ws, (ws + ov) ** 2, HAT_C // HAT_HEADS, HAT_WINDOW // 2

    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    def record(name, case, err, ms, plain_ms, bnd, summary, bnd_f32):
        require(err <= KERNEL_ATOL, f"{name} error {err} at {case}")
        res[name]["err"] = max(res[name]["err"], err)
        if summary:
            res[name].setdefault("times", []).append((ms, plain_ms, bnd, bnd_f32))

    for name, b, h, w in HAT_CASES:
        npix, whole = b * h * w, h % ws == 0 and w % ws == 0
        # B7: LN, two dense 3x3 convs through mid channels, GELU on mid; reads x, writes u
        c_args = (r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(3, 3, c, mid, std=(9 * c) ** -0.5), r(mid, std=0.1),
                  r(3, 3, mid, c, std=(9 * mid) ** -0.5), r(c, std=0.1))
        c_bnd, c_bnd32 = bounds(npix * (10 * c + 10 * mid), npix * 36 * c * mid,
                                4 * (2 * npix * c + 18 * c * mid + 3 * c + mid + b * c))
        for shift in (0, s if whole else 3):
            u, sums = cab.cab_chain(*c_args, out_shift=shift)
            u_ref, sums_ref = cab.cab_chain_plain(*c_args, out_shift=shift)
            torch.cuda.synchronize()
            err = (u - u_ref).abs().max().item()
            ratio = ((sums - sums_ref).abs() / u_ref.abs().sum((1, 2), keepdim=True)).max().item()
            del u, u_ref
            ms = cuda_ms(lambda: cab.cab_chain(*c_args, out_shift=shift), iters=5)
            plain_ms = cuda_ms(lambda: cab.cab_chain_plain(*c_args, out_shift=shift), iters=5)
            emit("kernel", kernel="cab_chain", case=name, shape=[b, h, w, c], out_shift=shift,
                 max_abs_err=err, bound=KERNEL_ATOL, sums_max_rel_err=ratio,
                 sums_bound=SUMS_RTOL, ms=ms, plain_ms=plain_ms, bound_ms=c_bnd[0],
                 bound_by=c_bnd[1], bound_f32_ms=c_bnd32[0])
            require(ratio <= SUMS_RTOL, f"B7 sums error {ratio} at {name}")
            record("cab_chain", name, err, ms, plain_ms, c_bnd, name == "bucket", c_bnd32)
        del c_args

        # B10: residual, LN, fc1, GELU, fc2, residual; reads a and shortcut, writes out
        m_args = (r(b, h, w, c), r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid, c, std=hid ** -0.5),
                  r(c, std=0.1))
        got = wattn.fused_residual_ln_mlp(*m_args)
        want = wattn.fused_residual_ln_mlp_plain(*m_args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: wattn.fused_residual_ln_mlp(*m_args), iters=5)
        plain_ms = cuda_ms(lambda: wattn.fused_residual_ln_mlp_plain(*m_args), iters=5)
        m_bnd, m_bnd32 = bounds(npix * (12 * c + 10 * hid), npix * 4 * c * hid,
                                4 * (3 * npix * c + 2 * c * hid + hid + 3 * c))
        emit("kernel", kernel="fused_residual_ln_mlp", case=name, shape=[b, h, w, c],
             hidden=hid, max_abs_err=err, bound=KERNEL_ATOL, ms=ms, plain_ms=plain_ms,
             bound_ms=m_bnd[0], bound_by=m_bnd[1], bound_f32_ms=m_bnd32[0])
        record("fused_residual_ln_mlp", name, err, ms, plain_ms, m_bnd, name == "bucket",
               m_bnd32)
        del m_args
        if not whole:
            continue
        nwin = b * (h // ws) * (w // ws)

        # B8: LN1, qkv, q k^T and p v with bias (+ mask) and softmax, proj, residuals, LN2,
        # MLP; reads x and conv_x, the weights, the bias and the 4 mask types, writes out
        h_args = (r(b, h, w, c), r(b, h, w, c, std=3.0), r(c, std=0.1, mean=1.0),
                  r(c, std=0.1), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1), r(c, c, std=c ** -0.5),
                  r(c, std=0.1), r(c, hid, std=c ** -0.5), r(hid, std=0.1),
                  r(hid, c, std=hid ** -0.5), r(c, std=0.1), r(heads, n, n, std=0.5))
        gate = r(b, 1, 1, c, std=0.2, mean=0.5)
        # the mask as the model hands it over, its 4 window types on the card; the small
        # case takes the whole image's numpy mask, which the wrapper reduces and checks
        types = torch.from_numpy(windows.shift_mask_types(ws, ws, s, s).copy()).cuda()
        full = windows.shift_attn_mask(h, w, ws, ws, s, s)
        for case, mask, in_shift, cab_scale in (
                ("unshifted", None, 0, gate),
                ("in_shift", types if name == "bucket" else full, s, gate),
                ("no_cab_scale", None, 0, None)):
            kw = dict(cab_scale=cab_scale, in_shift=in_shift)
            got = wattn.fused_hab_block(*h_args, mask, (ws, ws), heads, 0.01, **kw)
            want = wattn.fused_hab_block_plain(*h_args, mask, (ws, ws), heads, 0.01, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            del got, want
            ms = cuda_ms(lambda: wattn.fused_hab_block(*h_args, mask, (ws, ws), heads, 0.01,
                                                       **kw), iters=5)
            plain_ms = cuda_ms(lambda: wattn.fused_hab_block_plain(
                *h_args, mask, (ws, ws), heads, 0.01, **kw), iters=5)
            # the two halves apart: the attention (one launch) and the tail (three)
            attention, tail, _ = wattn._hab_block_launchers(*h_args, mask, (ws, ws), heads,
                                                            0.01, **kw)
            attention_ms, tail_ms = cuda_ms(attention, iters=5), cuda_ms(tail, iters=5)
            # products: qkv and proj (8 C^2), the MLP (4 C hid), q k^T and p v (4 N hd a row);
            # the rest: LNs, residuals, GELU, bias (+ mask) and softmax
            h_bnd, h_bnd32 = bounds(
                npix * (24 * c + 10 * hid) + nwin * heads * n * n * 8,
                npix * (8 * c * c + 4 * c * hid) + nwin * heads * n * n * 4 * hd,
                4 * (3 * npix * c + 4 * c * c + 2 * c * hid + 8 * c + hid + b * c
                     + (heads + (4 if in_shift else 0)) * n * n))
            emit("kernel", kernel="fused_hab_block", case=f"{name}_{case}", shape=[b, h, w, c],
                 window=ws, in_shift=in_shift, cab_scale=cab_scale is not None,
                 max_abs_err=err, bound=KERNEL_ATOL, max_abs_plain=scale, ms=ms,
                 plain_ms=plain_ms, attention_ms=attention_ms, tail_ms=tail_ms,
                 bound_ms=h_bnd[0], bound_by=h_bnd[1], bound_f32_ms=h_bnd32[0])
            record("fused_hab_block", f"{name}_{case}", err, ms, plain_ms, h_bnd,
                   name == "bucket" and case != "no_cab_scale", h_bnd32)
            if name == "bucket" and case != "no_cab_scale":
                res["fused_hab_block"].setdefault("parts", []).append((attention_ms, tail_ms))
        del h_args

        # B9: q k^T and p v over the 24 x 24 keys of each 16 x 16 window, bias, softmax,
        # proj; reads q, k, v, the bias and the weights, writes out
        o_args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c), r(c, c, std=c ** -0.5),
                  r(c, std=0.1), r(heads, n, nk, std=0.5))
        got = wattn.fused_overlap_attention(*o_args, ws, ov, heads)
        want = wattn.fused_overlap_attention_plain(*o_args, ws, ov, heads)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        del got, want
        ms = cuda_ms(lambda: wattn.fused_overlap_attention(*o_args, ws, ov, heads), iters=5)
        plain_ms = cuda_ms(lambda: wattn.fused_overlap_attention_plain(*o_args, ws, ov, heads),
                           iters=5)
        # the two launches apart: the attention, then the projection
        attention, proj, _ = wattn._overlap_launchers(*o_args, ws, ov, heads)
        attention_ms, proj_ms = cuda_ms(attention, iters=5), cuda_ms(proj, iters=5)
        # products on the tensor cores: q k^T and p v, the projection; the rest: bias and
        # softmax
        o_bnd, o_bnd32 = bounds(nwin * heads * n * nk * 8,
                                nwin * heads * n * nk * 4 * hd + npix * 2 * c * c,
                                4 * (4 * npix * c + c * c + c + heads * n * nk))
        emit("kernel", kernel="fused_overlap_attention", case=name, shape=[b, h, w, c],
             window=ws, overlap=ov, max_abs_err=err, bound=KERNEL_ATOL, ms=ms,
             plain_ms=plain_ms, attention_ms=attention_ms, proj_ms=proj_ms,
             bound_ms=o_bnd[0], bound_by=o_bnd[1], bound_f32_ms=o_bnd32[0])
        record("fused_overlap_attention", name, err, ms, plain_ms, o_bnd, name == "bucket",
               o_bnd32)
        if name == "bucket":
            res["fused_overlap_attention"]["extra"] = dict(attention_ms=attention_ms,
                                                           proj_ms=proj_ms)
        del o_args
        torch.cuda.empty_cache()
    parts = res["fused_hab_block"].pop("parts")
    res["fused_hab_block"]["extra"] = dict(attention_ms=mean(p[0] for p in parts),
                                           tail_ms=mean(p[1] for p in parts))
    for k in ("cab_chain", "fused_hab_block", "fused_overlap_attention",
              "fused_residual_ln_mlp"):
        times = res[k].pop("times")
        res[k].update(ms=mean(t[0] for t in times), plain_ms=mean(t[1] for t in times),
                      bound=times[0][2], bound_f32=times[0][3])


def wide_row_cases(gen: torch.Generator, res: dict) -> None:
    """B6, B8 and B10 above the 192 rows of K that a row product stages at a time (the row
    kernel takes C in pieces there), at C = 256 and 384 on [1,128,256,C]: B8 with heads of
    32 and the shift mask, B6 and B10 at hidden 2C. Outputs within KERNEL_ATOL of the plain
    version; timed, but not the summary's times."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    b, h, w, ws = 1, 128, 256, HAT_WINDOW
    types = torch.from_numpy(windows.shift_mask_types(ws, ws, ws // 2, ws // 2).copy()).cuda()
    for c in WIDE_ROWS:
        hid, heads = 2 * c, c // 32
        ln = (r(c, std=0.1, mean=1.0), r(c, std=0.1))
        cases = {
            "fused_sgfn_tail": (sgfn.fused_sgfn_tail, sgfn.fused_sgfn_tail_plain,
                                (r(b, h, w, c), r(b, h, w, c), *ln, r(c, hid, std=c ** -0.5),
                                 r(hid, std=0.1), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                                 r(3, 3, 1, c, std=1 / 3), r(c, std=0.1),
                                 r(c, c, std=c ** -0.5), r(c, std=0.1)), {}),
            "fused_residual_ln_mlp": (wattn.fused_residual_ln_mlp,
                                      wattn.fused_residual_ln_mlp_plain,
                                      (r(b, h, w, c), r(b, h, w, c), *ln,
                                       r(c, hid, std=c ** -0.5), r(hid, std=0.1),
                                       r(hid, c, std=hid ** -0.5), r(c, std=0.1)), {}),
            "fused_hab_block": (wattn.fused_hab_block, wattn.fused_hab_block_plain,
                                (r(b, h, w, c), r(b, h, w, c, std=3.0), *ln, *ln,
                                 r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
                                 r(c, c, std=c ** -0.5), r(c, std=0.1), r(c, hid, std=c ** -0.5),
                                 r(hid, std=0.1), r(hid, c, std=hid ** -0.5), r(c, std=0.1),
                                 r(heads, ws * ws, ws * ws, std=0.5), types, (ws, ws), heads,
                                 0.01),
                                dict(cab_scale=r(b, 1, 1, c, std=0.2, mean=0.5),
                                     in_shift=ws // 2)),
        }
        for name, (fn, plain, args, kw) in cases.items():
            got, want = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            del got, want
            ms = cuda_ms(lambda: fn(*args, **kw), iters=3)
            emit("kernel", kernel=name, case=f"c{c}", shape=[b, h, w, c], hidden=hid,
                 pieces=_mma.piece_sizes(-(-c // 8) * 8), max_abs_err=err, bound=KERNEL_ATOL,
                 ms=ms)
            require(err <= KERNEL_ATOL, f"{name} error {err} at C = {c}")
            res[name]["err"] = max(res[name]["err"], err)
        del cases
        torch.cuda.empty_cache()


def band_mha_library(x, in_proj_weight, bqkv, out_proj_weight, bproj, ln_w, ln_b, heads):
    """B11's function through PyTorch's own attention entry point: the yardstick
    `library_ms`, which nothing in the port calls."""
    *_, t, d = x.shape
    n = F.layer_norm(x, (d,), ln_w, ln_b, 1e-5).reshape(-1, t, d).transpose(0, 1)
    a, _ = F.multi_head_attention_forward(
        n, n, n, d, heads, in_proj_weight, bqkv, None, None, False, 0.0, out_proj_weight,
        bproj, training=False, need_weights=False)
    return x + a.transpose(0, 1).reshape(x.shape)


def head_kernel_cases(gen: torch.Generator, res: dict) -> None:
    """B11 and B12 at the fusion head's shapes, with the bound of the other kernels: outputs
    of O(1) within KERNEL_ATOL of the plain version."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    for name, b, h, w, t, d, heads in MHA_CASES:
        hd, npix = d // heads, b * h * w
        args = (r(b, h, w, t, d, std=0.6), r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.1),
                r(d, d, std=d ** -0.5), r(d, std=0.1), r(d, std=0.1, mean=1.0),
                r(d, std=0.1), heads)
        got = bandmha.fused_band_mha(*args)
        want = bandmha.fused_band_mha_plain(*args)
        lib_args = (args[0], args[1].t().contiguous(), args[2], args[3].t().contiguous(),
                    *args[4:])
        lib_err = (band_mha_library(*lib_args) - want).abs().max().item()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: bandmha.fused_band_mha(*args), iters=5)
        plain_ms = cuda_ms(lambda: bandmha.fused_band_mha_plain(*args), iters=5)
        lib_ms = cuda_ms(lambda: band_mha_library(*lib_args), iters=5)
        # products on the tensor cores: the qkv and out projections; on CUDA cores: LN, q k^T
        # and p v over T x T scores a head, softmax; reads the stacked tensor and the weights,
        # writes the stacked tensor
        tc_flops = npix * t * 8 * d * d
        bnd, bnd32 = bounds(npix * (t * 10 * d + heads * t * t * (4 * hd + 8)), tc_flops,
                            4 * (2 * npix * t * d + 4 * d * d + 6 * d))
        emit("kernel", kernel="fused_band_mha", case=name, shape=[b, h, w, t, d], heads=heads,
             max_abs_err=err, bound=KERNEL_ATOL, max_abs_plain=scale,
             library_vs_plain_max_abs=lib_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=bnd[0], bound_by=bnd[1], bound_f32_ms=bnd32[0],
             tc_tflops=tc_flops / ms / 1e9)
        require(err <= KERNEL_ATOL, f"B11 error {err} at {name}")
        require(lib_err <= KERNEL_ATOL, f"B11's library call differs from it by {lib_err}")
        res["fused_band_mha"]["err"] = max(res["fused_band_mha"]["err"], err)
        if name == "bucket":   # the summary's times
            res["fused_band_mha"].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                         bound=bnd, bound_f32=bnd32)
        del args, lib_args
        torch.cuda.empty_cache()

    for name, b, h, w, c in LKA_CASES:
        n = b * h * w * c
        args = (r(b, h, w, c), r(5, 5, c, std=0.2), r(21, c, std=0.2), r(21, c, std=0.2),
                r(c, c, std=c ** -0.5), r(c, std=0.2, mean=1.0), r(c, std=0.1))
        got = lka.lka_gate(*args)
        want = lka.lka_gate_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: lka.lka_gate(*args), iters=5)
        plain_ms = cuda_ms(lambda: lka.lka_gate_plain(*args), iters=5)
        # 25 + 21 + 21 depthwise taps, affine, sigmoid and gate on the CUDA cores, the 1x1
        # product on the tensor cores; reads x and the weights, writes out
        bnd, bnd32 = bounds(n * (2 * (25 + 21 + 21) + 8), n * 2 * c,
                            4 * (2 * n + c * c + 69 * c))
        emit("kernel", kernel="lka_gate", case=name, shape=[b, h, w, c], max_abs_err=err,
             bound=KERNEL_ATOL, max_abs_plain=scale, ms=ms, plain_ms=plain_ms,
             bound_ms=bnd[0], bound_by=bnd[1], bound_f32_ms=bnd32[0])
        require(err <= KERNEL_ATOL, f"B12 error {err} at {name}")
        res["lka_gate"]["err"] = max(res["lka_gate"]["err"], err)
        if name == "bucket":   # the summary's times
            res["lka_gate"].update(ms=ms, plain_ms=plain_ms, bound=bnd, bound_f32=bnd32)
        del args
        torch.cuda.empty_cache()


def window_attention_library(q, k, v, bias, types, window, heads):
    """B13's function through PyTorch's fused attention: the yardstick `library_ms`, which
    nothing in the port calls. The partition of q, k, v into windows and the reverse copy
    are inside the call, hence inside its time: SDPA takes [batch, heads, N, hd]."""
    b, h, w, c = q.shape
    hs, ws = window
    n, hd = hs * ws, c // heads

    def wins(t):
        return windows.window_partition(t, hs, ws).reshape(-1, n, heads, hd).permute(0, 2, 1, 3)

    mask = bias[None]
    if types is not None:
        per_win = types[wattn._type_index(h // hs, w // ws, q.device)]
        mask = (bias[None, None] + per_win[None, :, None]).expand(b, -1, -1, -1, -1).reshape(
            -1, heads, n, n)
    out = F.scaled_dot_product_attention(wins(q), wins(k), wins(v), attn_mask=mask)
    return windows.window_reverse(out.permute(0, 2, 1, 3).reshape(-1, n, c), hs, ws, h, w)


def window_kernel_cases(gen: torch.Generator, res: dict) -> None:
    """B13 and B14 at the table's shapes and at the shapes of the tiled and hat_odd paths,
    with the bound of the other kernels: outputs of O(1) within KERNEL_ATOL of the plain
    version. The summary's times are those of the table's shape, the mean of the unshifted
    and the shifted call."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    def mask_of(hs, ws, shifted):
        if not shifted:
            return None
        return torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()

    c, heads = DAT_C // 2, DAT_HEADS
    hd = c // heads
    for name, b, h, w, hs, ws, shifted in QKV_CASES:
        n, npix, nwin = hs * ws, b * h * w, b * (h // hs) * (w // ws)
        mask = mask_of(hs, ws, shifted)
        args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c), r(heads, n, n, std=0.5), mask,
                (hs, ws), heads)
        got = wattn.fused_window_attention_qkv(*args)
        want = wattn.fused_window_attention_qkv_plain(*args)
        lib_err = (window_attention_library(*args) - want).abs().max().item()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: wattn.fused_window_attention_qkv(*args), iters=5)
        plain_ms = cuda_ms(lambda: wattn.fused_window_attention_qkv_plain(*args), iters=5)
        lib_ms = cuda_ms(lambda: window_attention_library(*args), iters=5)
        # q k^T and p v on the tensor cores, bias (+ mask) and softmax on the CUDA cores;
        # reads q, k, v, the bias and the 4 mask types, writes the attended image
        bnd, bnd32 = bounds(nwin * heads * n * n * 8, nwin * heads * n * n * 4 * hd,
                            4 * (4 * npix * c + (heads + (4 if shifted else 0)) * n * n))
        emit("kernel", kernel="fused_window_attention_qkv", case=name, shape=[b, h, w, c],
             window=[hs, ws], shifted=shifted, max_abs_err=err, bound=KERNEL_ATOL,
             max_abs_plain=scale, library_vs_plain_max_abs=lib_err, ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, library="windowing copies + F.scaled_dot_product_attention",
             bound_ms=bnd[0], bound_by=bnd[1], bound_f32_ms=bnd32[0],
             tc_tflops=nwin * heads * n * n * 4 * hd / ms / 1e9)
        require(err <= KERNEL_ATOL, f"B13 error {err} at {name}")
        require(lib_err <= KERNEL_ATOL, f"B13's library call differs from it by {lib_err}")
        res["fused_window_attention_qkv"]["err"] = max(
            res["fused_window_attention_qkv"]["err"], err)
        if name.startswith("table"):
            res["fused_window_attention_qkv"].setdefault("times", []).append(
                (ms, plain_ms, bnd, lib_ms, bnd32))
        del args
    c, heads = HAT_C, HAT_HEADS
    hd = c // heads
    for name, b, h, w, hs, ws, shifted in WIN_CASES:
        n, npix, nwin = hs * ws, b * h * w, b * (h // hs) * (w // ws)
        args = (r(b, h, w, c), r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
                r(c, c, std=c ** -0.5), r(c, std=0.1), r(heads, n, n, std=0.5),
                mask_of(hs, ws, shifted), (hs, ws), heads)
        got = wattn.fused_window_attention(*args)
        want = wattn.fused_window_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: wattn.fused_window_attention(*args), iters=5)
        plain_ms = cuda_ms(lambda: wattn.fused_window_attention_plain(*args), iters=5)
        # the qkv and output projections, q k^T and p v, bias (+ mask) and softmax; reads x,
        # the weights, the bias and the 4 mask types, writes the attended image; every
        # product on the tensor cores, bias and softmax on the CUDA cores
        bnd, bnd32 = bounds(nwin * heads * n * n * 8,
                            npix * 8 * c * c + nwin * heads * n * n * 4 * hd,
                            4 * (2 * npix * c + 4 * c * c + 4 * c
                                 + (heads + (4 if shifted else 0)) * n * n))
        emit("kernel", kernel="fused_window_attention", case=name, shape=[b, h, w, c],
             window=[hs, ws], shifted=shifted, max_abs_err=err, bound=KERNEL_ATOL,
             max_abs_plain=scale, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
             bound_f32_ms=bnd32[0])
        require(err <= KERNEL_ATOL, f"B14 error {err} at {name}")
        res["fused_window_attention"]["err"] = max(res["fused_window_attention"]["err"], err)
        if name.startswith("table"):
            res["fused_window_attention"].setdefault("times", []).append(
                (ms, plain_ms, bnd, None, bnd32))
        del args
        torch.cuda.empty_cache()
    for k in ("fused_window_attention_qkv", "fused_window_attention"):
        times = res[k].pop("times")
        res[k].update(ms=mean(t[0] for t in times), plain_ms=mean(t[1] for t in times),
                      bound=(mean(t[2][0] for t in times), times[0][2][1]),
                      bound_f32=(mean(t[4][0] for t in times), times[0][4][1]),
                      library_ms=None if times[0][3] is None else mean(t[3] for t in times))


# (kernel, case, shape): what the card's kernels once refused and the JAX kernels compute
REPAIR_CASES = [("naf_block", "c32", (1, 176, 256, 32)), ("naf_block", "c48", (1, 176, 256, 48)),
                ("fused_sgfn_tail", "half400", (1, 64, 96, 200, 800)),
                ("fused_overlap_attention", "win32", (1, 64, 96, 180, 6, 32)),
                ("fused_overlap_attention", "win32_hd48", (1, 64, 96, 96, 2, 32)),
                ("fused_band_mha", "d144", (1, 32, 48, 9, 144, 4)),
                ("fused_band_mha", "d256", (1, 32, 48, 9, 256, 4)),
                ("fused_band_mha", "hd96", (1, 32, 48, 9, 96, 1)),
                ("fused_band_mha", "t65", (1, 8, 12, 65, 96, 4)),
                ("lka_gate", "c6", (1, 64, 96, 6)), ("lka_gate", "c130", (1, 64, 96, 130)),
                ("lka_gate", "c400", (1, 64, 96, 400)),
                ("fused_window_attention_qkv", "n144_hd48", (1, 48, 96, 12, 12, 96, 2)),
                ("fused_window_attention_qkv", "n576_hd96", (1, 48, 96, 24, 24, 96, 1)),
                ("fused_window_attention_qkv", "n256_hd64", (1, 64, 96, 16, 16, 128, 2)),
                ("fused_window_attention", "win12_hd48", (1, 48, 72, 12, 96, 2)),
                ("naf_block", "c36", (1, 64, 96, 36)), ("naf_block", "c44", (1, 64, 96, 44)),
                ("naf_block", "c100", (1, 64, 96, 100)),
                ("fused_band_mha", "d400", (1, 16, 24, 9, 400, 4)),
                ("fused_band_mha", "d512", (1, 16, 24, 9, 512, 4)),
                ("fused_band_mha", "t65_d128", (1, 8, 12, 65, 128, 4)),
                ("fused_band_mha", "t129_d64", (1, 8, 12, 129, 64, 4)),
                ("lka_gate", "c1816", (1, 32, 48, 1816)), ("lka_gate", "c2048", (1, 32, 48, 2048))]


def repair_cases(gen: torch.Generator) -> None:
    """Every REPAIR_CASES shape: one launch of its kernel (counted), within KERNEL_ATOL of
    the plain version, and its time."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    def mask_of(hs, ws):
        return torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()

    for kernel, case, shape in REPAIR_CASES:
        if kernel == "naf_block":
            b, h, w, c = shape
            x, p = r(b, h, w, c), block_params(c, gen)
            fn, plain = nafblock.fused_naf_block, nafblock.fused_naf_block_plain
            args, counts, want_n = (x, p), nafblock.launches, {
                "naf_block_stage_a": 1, "naf_block_stage_b": 1}
        elif kernel == "fused_sgfn_tail":
            b, h, w, c, hid = shape
            half = hid // 2
            args = (r(b, h, w, c), r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                    r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(half, std=0.1, mean=1.0),
                    r(half, std=0.1), r(3, 3, 1, half, std=1 / 3), r(half, std=0.1),
                    r(half, c, std=half ** -0.5), r(c, std=0.1))
            fn, plain, counts = sgfn.fused_sgfn_tail, sgfn.fused_sgfn_tail_plain, sgfn.launches
        elif kernel == "fused_overlap_attention":
            b, h, w, c, heads, ws = shape
            ov = ws // 2
            args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c), r(c, c, std=c ** -0.5),
                    r(c, std=0.1), r(heads, ws * ws, (ws + ov) ** 2, std=0.5), ws, ov, heads)
            fn, plain = wattn.fused_overlap_attention, wattn.fused_overlap_attention_plain
            counts = wattn.launches
        elif kernel == "fused_band_mha":
            b, h, w, t, d, heads = shape
            args = (r(b, h, w, t, d, std=0.6), r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.1),
                    r(d, d, std=d ** -0.5), r(d, std=0.1), r(d, std=0.1, mean=1.0),
                    r(d, std=0.1), heads)
            fn, plain = bandmha.fused_band_mha, bandmha.fused_band_mha_plain
            counts = bandmha.launches
        elif kernel == "lka_gate":
            b, h, w, c = shape
            args = (r(b, h, w, c), r(5, 5, c, std=0.2), r(21, c, std=0.2), r(21, c, std=0.2),
                    r(c, c, std=c ** -0.5), r(c, std=0.2, mean=1.0), r(c, std=0.1))
            fn, plain, counts = lka.lka_gate, lka.lka_gate_plain, lka.launches
        elif kernel == "fused_window_attention_qkv":
            b, h, w, hs, ws, c, heads = shape
            args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c),
                    r(heads, hs * ws, hs * ws, std=0.5), mask_of(hs, ws), (hs, ws), heads)
            fn, plain = wattn.fused_window_attention_qkv, wattn.fused_window_attention_qkv_plain
            counts = wattn.launches
        else:   # fused_window_attention
            b, h, w, ws, c, heads = shape
            args = (r(b, h, w, c), r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
                    r(c, c, std=c ** -0.5), r(c, std=0.1), r(heads, ws * ws, ws * ws, std=0.5),
                    mask_of(ws, ws), (ws, ws), heads)
            fn, plain = wattn.fused_window_attention, wattn.fused_window_attention_plain
            counts = wattn.launches
        if kernel != "naf_block":
            want_n = {kernel: 1}
        before = dict(counts)
        got = fn(*args)
        launched = {k: counts[k] - before[k] for k in counts if counts[k] != before[k]}
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        del got, want
        ms = cuda_ms(lambda: fn(*args), iters=3)
        emit("repair", kernel=kernel, case=case, shape=list(shape), max_abs_err=err,
             bound=KERNEL_ATOL, max_abs_plain=scale, launches=launched, ms=ms)
        require(launched == want_n, f"{kernel} at {case}: launches {launched}")
        require(err <= KERNEL_ATOL, f"{kernel} error {err} at {case}")
        del args
    torch.cuda.empty_cache()


def phase_kernels(gen: torch.Generator) -> dict:
    """Each kernel against its plain version at the slices' shapes; returns the numbers
    for the summary line."""
    res = {k: {"err": 0.0, "library_ms": None} for k in KERNELS}
    naf_kernel_cases(gen, res)
    dat_kernel_cases(gen, res)
    torch.cuda.empty_cache()
    hat_kernel_cases(gen, res)
    torch.cuda.empty_cache()
    wide_row_cases(gen, res)
    head_kernel_cases(gen, res)
    torch.cuda.empty_cache()
    window_kernel_cases(gen, res)
    repair_cases(gen)
    return res


def write_requests(directory: str, sizes=REQUESTS) -> list:
    """Smooth random RGB PNGs at `sizes` (W x H; the three REQUESTS by default), from SEED."""
    rng = np.random.default_rng(SEED)
    paths = []
    for i, (w, h) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        img = np.zeros((h, w, 3))
        for _ in range(6):
            fy, fx, ph = rng.uniform(1, 12), rng.uniform(1, 12), rng.uniform(0, 6.3)
            img += rng.uniform(0.05, 0.15, 3) * np.sin(fy * yy + fx * xx + ph)[..., None]
        img = np.clip(0.5 + img + 0.02 * rng.standard_normal(img.shape), 0, 1)
        paths.append(os.path.join(directory, f"req{i}_{w}x{h}.png"))
        save_image(img.astype(np.float32), paths[-1])
    return paths


class count_planes:
    """Counts the weight planes made (``_mma.mma_planes``) inside the ``with`` block: a
    forward after the first makes none where every product keeps its planes."""

    def __enter__(self):
        self.made, self._make = 0, _mma.mma_planes

        def counted(wp):
            self.made += 1
            return self._make(wp)

        _mma.mma_planes = counted
        return self

    def __exit__(self, *exc):
        _mma.mma_planes = self._make


def phase_slice(tag: str, model: torch.nn.Module, forward, expected: tuple,
                time_buckets: int, extra_times=None) -> dict:
    """Serves the three requests through InferencePipeline with `model`, checks the
    forward of image 0 (kernels against plain versions, `forward(x)` -> (pre-clamp sr,
    features, (h, w) to crop to)), requires every kernel in `expected` to have launched on
    the served path, and times the first `time_buckets` buckets (`extra_times(model)`,
    where given, adds its own entries to that line). A timed forward must make no weight
    planes: the first forwards made them all. Returns the launches."""
    pipe = InferencePipeline(model)   # the card is the default device
    req_dir, sr_dir = os.path.join(OUT, "requests"), os.path.join(OUT, f"sr_{tag}")
    write_requests(req_dir)
    files = list_images(req_dir)
    lrs = [load_image(f) for f in files]
    plans = [pipe._whole_image_plan(lr.shape[0], lr.shape[1]) for lr in lrs]
    emit(f"{tag}_setup", params=sum(p.numel() for p in model.parameters()),
         requests=[list(lr.shape) for lr in lrs], buckets=plans)

    # the main path: dispatch image i+1 before materialising image i
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, outs = None, []
    for f, lr, plan in zip(files, lrs, plans):
        handle = pipe.dispatch_batch_u8([lr], plan)
        if pending is not None:
            outs.append((pending[1], pipe.materialize_u8(pending[0])[0]))
        pending = (handle, f)
    outs.append((pending[1], pipe.materialize_u8(pending[0])[0]))
    serve_s = time.perf_counter() - t0
    counts = {k: n for k, n in read_launches().items() if n or k in expected}
    for f, arr in outs:
        save_image(arr, os.path.join(sr_dir, os.path.basename(f)))
    for (f, arr), lr in zip(outs, lrs):
        require(arr.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3) and
                arr.dtype == np.uint8, f"{f}: output {arr.shape} {arr.dtype}")
    emit(f"{tag}_serve", images=len(outs), seconds=serve_s,
         outputs=[list(a.shape) for _, a in outs], launches=counts)
    for k in expected:
        require(counts[k] > 0, f"kernel {k} was not launched on the {tag} main path")

    # the same forward of image 0, kernels against plain versions
    with torch.inference_mode():
        x = torch.from_numpy(pipe._pad([lrs[0]], *plans[0])).cuda()
        out_k, feats_k, (h, w) = forward(x)
        u8_k = torch.round(out_k[:, :h, :w].clamp(0, 1) * 255).to(torch.uint8)
        set_kernels(model, False)
        out_p, feats_p, _ = forward(x)
        set_kernels(model, True)
        torch.cuda.synchronize()
    lr_h, lr_w = lrs[0].shape[:2]
    u8_served = torch.from_numpy(outs[0][1]).cuda()
    lsb = (u8_k[0, :4 * lr_h, :4 * lr_w].int() - u8_served.int()).abs().max().item()
    out_err = (out_k - out_p).abs().max().item()
    out_bound = SLICE_RTOL * out_p.abs().max().item()
    feats_err = (feats_k - feats_p).abs().max().item()
    feats_bound = SLICE_RTOL * feats_p.abs().max().item()
    o = out_k[:, :h, :w]
    inside = ((o > 0) & (o < 1)).float().mean().item()
    finite = bool(torch.isfinite(out_k).all() and torch.isfinite(feats_k).all())
    emit(f"{tag}_check", out_max_abs_err=out_err, out_bound=out_bound,
         feats_max_abs_err=feats_err, feats_bound=feats_bound,
         share_inside_0_1=inside, served_vs_forward_max_lsb=lsb, finite=finite)
    require(finite, "non-finite output")
    require(out_err <= out_bound, f"{tag} output error {out_err} > {out_bound}")
    require(feats_err <= feats_bound, f"{tag} feats error {feats_err} > {feats_bound}")
    require(inside > 0.05, f"only {inside:.3f} of the output lies in (0,1)")
    require(lsb <= 1, f"served image differs from its forward by {lsb} LSB")
    del out_k, feats_k, out_p, feats_p, x

    # per-image device time of the forward at each request's bucket
    times = []
    torch.cuda.reset_peak_memory_stats()
    for lr, plan in list(zip(lrs, plans))[:time_buckets]:
        with torch.inference_mode():
            xb = torch.from_numpy(pipe._pad([lr], *plan)).cuda()
            ms = {}
            for path, on in (("kernel", True), ("plain", False), ("kernel2", True)):
                set_kernels(model, on)
                with count_planes() as planes:
                    ms[path] = cuda_ms(lambda: model(xb), iters=3)
                if on:
                    made = planes.made
            set_kernels(model, True)
        times.append(dict(lr=[lr.shape[1], lr.shape[0]], bucket=list(plan),
                          kernel_ms=ms["kernel"], kernel_ms_again=ms["kernel2"],
                          plain_ms=ms["plain"], planes_made_again=made))
        require(made == 0,
                f"{tag}: a forward at {list(plan)} made {made} weight planes again")
    torch.cuda.synchronize()
    emit(f"{tag}_time", per_image=times,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         **(extra_times(model) if extra_times else {}))
    return counts


def naf_slice(gen_cpu: torch.Generator) -> dict:
    model = NAFNetSR()
    randomize_(model, gen_cpu)

    def forward(x):
        x_in, hw = model.unet_input(x)
        out, feats = model.nafnet(x_in)
        return out, feats, hw

    return phase_slice("slice", model, forward,
                       ("naf_block_stage_a", "naf_block_stage_b", "conv3x3_dense"),
                       time_buckets=1)


def randomize_transformer_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights with nothing an identity, for DAT and HAT: convs and Linears
    N(0, 1/fan_in), HAT's relative-position bias tables N(0, 0.5), LayerNorm / BatchNorm
    weights and `temperature` N(1, 0.1), biases N(0, 0.02), BN running means U(-0.2, 0.2)
    and variances U(0.6, 1.4). `conv_last` is scaled by 0.1 more, so that the output stays
    near the RGB mean and mostly inside (0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table":
                std, mean = 0.5, 0.0
            elif p.dim() >= 2 and leaf == "weight":
                std, mean = p[0].numel() ** -0.5, 0.0
                if name.startswith("conv_last."):
                    std *= 0.1
            elif leaf in ("weight", "temperature"):
                std, mean = 0.1, 1.0
            else:
                std, mean = 0.02, 0.0
            p.copy_(mean + std * torch.randn(p.shape, generator=gen))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.8 + 0.6)


def dat_weight_prep(model: DAT) -> None:
    """The weight work that one DAT forward repeats in every block and nothing else: the
    modules keep torch's layouts, so each call re-lays some weights out for the kernels
    (transposes, the BN affines); the row products' and AIM's planes and the attention's
    head slabs are made once and only looked up (_mma.kept)."""
    for group in model.layers:
        for blk in group.blocks:
            a = blk.attn
            a.conv_weights()
            g = a.gates_weights()
            aim.gates_planes(g[0], g[6])
            w1, _, _, _, _, _, w2, _ = blk.ffn.raw()
            kp, k2p, npad = sgfn._widths(*w1.shape)
            _mma.planes(w1, kp, w1.shape[1]), _mma.planes(w2, k2p, npad)
            if isinstance(a, dat_model.AdaptiveSpatialAttention):
                wqkv = dat_model.linear_io_view(a.qkv)
                c, heads = wqkv.shape[0], a.num_heads // 2
                for br in range(2):
                    wattn.head_slabs(wqkv, a.qkv.bias, heads, c // 2 // heads, -(-c // 8) * 8,
                                     (br * c // 2, c // 2))


DAT_KERNELS = ("conv3x3_dense", "fused_window_attention_xqkv", "aim_conv_branch",
               "aim_gates_proj", "fused_sgfn_tail")


def dat_slice(gen_cpu: torch.Generator, profile: bool) -> dict:
    model = DAT()
    randomize_transformer_(model, gen_cpu)

    def forward(x):
        sr, deep = model(x)
        return sr, deep, (x.shape[1] * model.upscale, x.shape[2] * model.upscale)

    def weight_prep_ms(m):
        with torch.inference_mode():
            return {"weight_prep_ms_per_image": cuda_ms(lambda: dat_weight_prep(m), iters=3)}

    counts = phase_slice("dat", model, forward, DAT_KERNELS, time_buckets=1,
                         extra_times=weight_prep_ms)
    # per image: 7 convs (6 groups + conv_after_body), 36 of each AIM kernel and of the
    # tail (every block), 36 window attentions (18 spatial blocks x 2 branches)
    per_image = {"conv3x3_dense": 7, "fused_window_attention_xqkv": 36,
                 "aim_conv_branch": 36, "aim_gates_proj": 36, "fused_sgfn_tail": 36}
    for k, n in per_image.items():
        require(counts[k] == n * len(REQUESTS),
                f"{k}: {counts[k]} launches on the DAT path, expected {n} per image")
    if profile:
        x = torch.rand(1, 352, 512, 3, device="cuda")
        profile_forward("dat", lambda: model(x))
    return counts


def hat_weight_prep(model: HAT) -> None:
    """The weight work that one HAT forward repeats in every block and nothing else: the
    modules keep torch's layouts, so each call re-lays some weights out for the kernels
    (transposes, the bias gathers, the CAB convs' padding); the row products' planes and
    the attention's head slabs are made once and only looked up (_mma.kept)."""
    c = model.conv_first.out_channels
    kp = npad = -(-c // 8) * 8
    for group in model.layers:
        for blk in group.residual_group.blocks:
            cab._padded_weights(*blk.conv_block.raw())
            wqkv, bqkv, wproj, _, _ = blk.attn.raw()
            wattn.head_slabs(wqkv, bqkv, blk.num_heads, c // blk.num_heads, kp)
            _mma.planes(wproj, kp, npad)
            wattn._mlp_planes(c, *blk.mlp.raw()[::2])
        oc = group.residual_group.overlap_attn
        windows.oca_bias_from_table(oc.relative_position_bias_table, oc.window,
                                    oc.overlap_window, oc.relative_position_index)
        _mma.planes(oc.proj.weight.t(), kp, npad)
        wattn._mlp_planes(c, *oc.mlp.raw()[::2])


HAT_KERNELS = ("conv3x3_dense", "cab_chain", "fused_hab_block", "fused_overlap_attention",
               "fused_residual_ln_mlp")


def hat_slice(gen_cpu: torch.Generator, profile: bool) -> dict:
    model = HAT()   # HAT-L: 12 groups of 6 HAB + 1 OCAB at embed 180
    randomize_transformer_(model, gen_cpu)

    def forward(x):
        sr, deep = model(x)
        return sr, deep, (x.shape[1] * model.upscale, x.shape[2] * model.upscale)

    def weight_prep_ms(m):
        with torch.inference_mode():
            return {"weight_prep_ms_per_image": cuda_ms(lambda: hat_weight_prep(m), iters=3)}

    counts = phase_slice("hat", model, forward, HAT_KERNELS, time_buckets=1,
                         extra_times=weight_prep_ms)
    # per image: 72 HABs (a CAB chain and a fused block each), 12 OCABs (an overlapping
    # attention and a residual MLP each), 13 convs (12 groups + conv_after_body)
    per_image = {"cab_chain": 72, "fused_hab_block": 72, "fused_overlap_attention": 12,
                 "fused_residual_ln_mlp": 12, "conv3x3_dense": 13}
    for k, n in per_image.items():
        require(counts[k] == n * len(REQUESTS),
                f"{k}: {counts[k]} launches on the HAT path, expected {n} per image")
    if profile:
        x = torch.rand(1, 352, 512, 3, device="cuda")
        profile_forward("hat", lambda: model(x))
    return counts


def randomize_head_(head: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights with nothing an identity, for the fusion head: convs, Linears
    and the packed in_proj N(0, 1/fan_in), LayerNorm / BatchNorm weights N(1, 0.1), biases
    N(0, 0.02), BN running means U(-0.2, 0.2) and variances U(0.6, 1.4); the head's own
    scalars and vectors (residual scales, band scales, importances, the FFT mask) keep
    their initial values plus N(0, 0.05)."""
    with torch.no_grad():
        for name, p in head.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 and leaf in ("weight", "in_proj_weight"):
                p.copy_(p[0].numel() ** -0.5 * torch.randn(p.shape, generator=gen))
            elif leaf == "weight":
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif leaf in ("bias", "in_proj_bias"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            else:
                p.add_((0.05 * torch.randn(p.shape, generator=gen)).to(p.device))
        for name, buf in head.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.8 + 0.6)


def write_checkpoints(model_dir: str, gen_cpu: torch.Generator) -> None:
    """Seeded random weights for the whole model, nothing an identity, saved where `main`
    looks for them: one .pth per expert under pretrained/ (NAFNetSR's with its `nafnet.`
    prefix) and the head's beside them."""
    model = FreqFusionSR()
    randomize_transformer_(model.experts.hat, gen_cpu)
    randomize_transformer_(model.experts.dat, gen_cpu)
    randomize_(model.experts.nafnet, gen_cpu)
    randomize_head_(model.fusion, gen_cpu)
    for name, module in (("hat", model.experts.hat), ("dat", model.experts.dat),
                         ("nafnet", model.experts.nafnet)):
        os.makedirs(os.path.join(model_dir, "pretrained", name), exist_ok=True)
        torch.save(module.state_dict(), os.path.join(model_dir, "pretrained", name, f"{name}.pth"))
    torch.save(model.fusion.state_dict(), os.path.join(model_dir, "fusion_head.pth"))


def ens_forward(model: FreqFusionSR, x: torch.Tensor) -> tuple:
    """(expert outputs, the head's three fused bands, the fused image before any clamp, the
    output) of one FreqFusionSR forward, stage by stage."""
    head = model.fusion
    outputs, _ = model.experts(x)
    bands = head.process_frequency_bands(x)
    fused = head.fuse_experts(x, outputs, bands)
    sr = head.refine(fused, x)
    return outputs, torch.cat(bands, -1), fused, head.edge_refine(sr)


def ens_slice(gen_cpu: torch.Generator, profiled, solo_counts: dict) -> dict:
    """FreqFusionSR at the shipped FusionConfig over NAFNet-64, DAT and HAT-L at full width
    and depth serves the three requests through infer.io.main, from the checkpoints that
    `write_checkpoints` saved. `solo_counts` holds the launches of the three solo phases on
    the same requests: the ensemble must repeat them, plus one band attention and one LKA
    gate an image."""
    model_dir = os.path.join(OUT, "model_dir")
    req_dir, sr_dir = os.path.join(OUT, "requests"), os.path.join(OUT, "sr_ens")
    t0 = time.perf_counter()
    write_checkpoints(model_dir, gen_cpu)
    write_requests(req_dir)
    files = list_images(req_dir)
    lrs = [load_image(f) for f in files]
    for f in list_images(sr_dir) if os.path.isdir(sr_dir) else []:
        os.remove(f)
    write_s = time.perf_counter() - t0

    # the main path: the directory contract, on the card (its default device), every
    # checkpoint found
    reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        served = serve_directory(model_dir, req_dir, sr_dir)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {k: n for k, n in read_launches().items() if n}
    lost = [str(w.message) for w in caught if "checkpoint" in str(w.message)]
    require(not lost, f"main did not load every checkpoint: {lost}")

    # the same model once more, for the checks and the timings below
    t0 = time.perf_counter()
    pipe = build_pipeline(model_dir)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model, head = pipe.model, pipe.model.fusion
    plans = [pipe._whole_image_plan(lr.shape[0], lr.shape[1]) for lr in lrs]
    emit("ens_setup", params=sum(p.numel() for p in model.parameters()),
         head_params=sum(p.numel() for p in head.parameters()),
         requests=[list(lr.shape) for lr in lrs], buckets=plans,
         write_checkpoints_seconds=write_s)
    outs = [load_image(os.path.join(sr_dir, os.path.basename(f))) for f in files]
    # `seconds`: the whole call of main, building the model and loading its checkpoints
    # included; `build_seconds`: that part alone, as the second build took it
    emit("ens_serve", images=served, seconds=main_s, build_seconds=build_s,
         outputs=[list(a.shape) for a in outs], launches=counts)
    require(served == len(REQUESTS), f"main served {served} images")
    for lr, arr in zip(lrs, outs):
        require(arr.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3), f"output {arr.shape}")
    expected = {k: n for k, n in solo_counts.items() if n}
    expected.update(fused_band_mha=len(REQUESTS), lka_gate=len(REQUESTS))
    require(counts == expected, f"launches on the ensemble path {counts}, expected {expected}")

    # the same forward of image 0, kernels against plain versions: the head's three fused
    # bands (what B11 and B12 feed), the fused image before any clamp, and the output
    def forward(x):
        return ens_forward(model, x)

    lr_h, lr_w = lrs[0].shape[:2]
    with torch.inference_mode():
        x = torch.from_numpy(pipe._pad([lrs[0]], *plans[0])).cuda()
        _, bands_k, fused_k, out_k = forward(x)
        set_kernels(model, False)
        outputs_p, bands_p, fused_p, out_p = forward(x)
        set_kernels(model, True)
        torch.cuda.synchronize()
        u8_k = torch.round(out_k[0, :4 * lr_h, :4 * lr_w] * 255).to(torch.uint8)
    served_u8 = torch.from_numpy(np.round(outs[0] * 255).astype(np.uint8)).cuda()
    lsb = (u8_k.int() - served_u8.int()).abs().max().item()
    errs = {n: ((a - b).abs().max().item(), SLICE_RTOL * b.abs().max().item())
            for n, a, b in (("bands", bands_k, bands_p), ("fused", fused_k, fused_p),
                            ("out", out_k, out_p))}
    o = out_k[:, :4 * lr_h, :4 * lr_w]
    inside = ((o > 0) & (o < 1)).float().mean().item()
    finite = bool(torch.isfinite(out_k).all() and torch.isfinite(bands_k).all())
    emit("ens_check", **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
         **{f"{n}_bound": b for n, (_, b) in errs.items()}, share_inside_0_1=inside,
         served_vs_forward_max_lsb=lsb, finite=finite)
    require(finite, "non-finite output")
    for n, (e, bnd) in errs.items():
        require(e <= bnd, f"ensemble {n} error {e} > {bnd}")
    require(inside > 0.05, f"only {inside:.3f} of the output lies in (0,1)")
    require(lsb <= 1, f"served image differs from its forward by {lsb} LSB")
    del bands_k, fused_k, out_k, bands_p, fused_p, out_p

    # per-image device time of the forward at each bucket, and of the head alone on fixed
    # expert outputs at the first (512x352)
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for lr, plan in zip(lrs, plans):
            xb = torch.from_numpy(pipe._pad([lr], *plan)).cuda()
            ms = {}
            for path, on in (("kernel", True), ("plain", False)):
                set_kernels(model, on)
                ms[path] = cuda_ms(lambda: model(xb), iters=2)
            set_kernels(model, True)
            times.append(dict(lr=[lr.shape[1], lr.shape[0]], bucket=list(plan),
                              kernel_ms=ms["kernel"], plain_ms=ms["plain"]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        head_ms = {}
        for path, on in (("kernel", True), ("plain", False), ("kernel_again", True)):
            set_kernels(model, on)
            head_ms[path] = cuda_ms(lambda: head(x, outputs_p), iters=3)
        set_kernels(model, True)
    emit("ens_time", per_image=times, peak_mem_gib=peak, head_bucket=list(plans[0]),
         head_ms=head_ms)
    if "ens" in profiled:
        profile_forward("ens", lambda: model(x))
    if "head" in profiled:
        profile_forward("head", lambda: head(x, outputs_p))
    return counts


def tiled_slice(per_forward: dict, profile: bool) -> dict:
    """Tiled serving of the full FreqFusionSR through the submission runner
    (``freqfusion_tpu_torch.cli.test`` around infer.io.main, on its default device), from
    the checkpoints and at the weights of the ensemble phase. `per_forward` holds the launches of one
    whole-image forward: every forward of the tiled path, whatever its batch, must repeat
    them, except that at a tile that is not whole 32-px windows DAT's window attention is
    the pre-projected kernel. Returns the launches of both `main` calls together."""
    model_dir = os.path.join(OUT, "model_dir")
    req_dir, one_dir = os.path.join(OUT, "requests_tiled"), os.path.join(OUT, "requests_2k")
    save_dir, save176_dir = os.path.join(OUT, "results"), os.path.join(OUT, "results_176")
    sr_dir, sr176_dir = (os.path.join(d, cli_test.MODEL_NAME, "valid")
                         for d in (save_dir, save176_dir))
    for d in (req_dir, one_dir, sr_dir, sr176_dir):
        for f in list_images(d) if os.path.isdir(d) else []:
            os.remove(f)
    for d in (save_dir, save176_dir):
        if os.path.exists(os.path.join(d, "results.json")):
            os.remove(os.path.join(d, "results.json"))
    files = write_requests(req_dir, TILED_REQUESTS)
    big = write_requests(one_dir, TILED_REQUESTS[:1])[0]
    lrs = [load_image(f) for f in files]
    os.environ["FREQFUSION_MODEL_DIR"] = model_dir

    def served(directory, save_to, out_dir, n_frames, **tiling):
        """The runner on `directory` (`tiling`: keywords for main; the runner has no flag
        for them); returns (launches, its runtime in seconds)."""
        reset_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runtime_ms = cli_test.main(["--input", directory, "--save_dir", save_to], **tiling)
        counts = {k: v for k, v in read_launches().items() if v}
        lost = [str(w.message) for w in caught if "checkpoint" in str(w.message)]
        require(not lost, f"the runner did not load every checkpoint: {lost}")
        with open(os.path.join(save_to, "results.json")) as f:
            results = json.load(f)
        require(results.get(cli_test.MODEL_NAME) == {"runtime_ms": runtime_ms, "split": "valid"},
                f"results.json holds {results}")
        pngs = sorted(os.path.basename(f) for f in list_images(out_dir))
        require(pngs == sorted(os.path.basename(f) for f in list_images(directory))
                and len(pngs) == n_frames, f"the runner wrote {pngs} for {n_frames} frames")
        return counts, runtime_ms / 1e3

    def forwards(tile, sizes, whole):
        """(forwards `main` makes for frames of `sizes`, the plan of each): chunks of 2
        tiles, or one forward for a frame that runs whole."""
        plan = []
        for (w, h), is_whole in zip(sizes, whole):
            tiles = 0 if is_whole else num_tiles(h, w, tile, 32, 2)
            plan.append(dict(lr=[w, h], tiles=tiles, chunks=-(-tiles // 2) if tiles else 1))
        return sum(p["chunks"] for p in plan), plan

    # the main path: three frames, three ways in, at the default 192-px tiles
    n192, plan192 = forwards(192, TILED_REQUESTS, (False, False, True))
    counts, secs = served(req_dir, save_dir, sr_dir, 3)
    expected = {k: n * n192 for k, n in per_forward.items()}
    emit("tiled_serve", tile=192, frames=plan192, forwards=n192, seconds=secs, launches=counts)
    require(counts == expected, f"launches on the tiled path {counts}, expected {expected}")
    # the 2K frame again in 176-px tiles: q, k, v are padded to 192 after their projection
    n176, plan176 = forwards(RAGGED_TILE, TILED_REQUESTS[:1], (False,))
    counts176, secs176 = served(one_dir, save176_dir, sr176_dir, 1, tile=RAGGED_TILE)
    expected = {k: n * n176 for k, n in per_forward.items()}
    expected["fused_window_attention_qkv"] = expected.pop("fused_window_attention_xqkv")
    emit("tiled_serve", tile=RAGGED_TILE, frames=plan176, forwards=n176, seconds=secs176,
         launches=counts176)
    require(counts176 == expected,
            f"launches on the tiled path at tile {RAGGED_TILE} {counts176}, expected {expected}")
    require([p["tiles"] for p in plan192] == [12, 1, 0] and plan192[0]["chunks"] == 6
            and plan176[0]["tiles"] == 20, f"tile plans {plan192} {plan176}")

    # the same model once more: the same tiles on the plain path, one chunk stage by stage,
    # and the times
    lr_big = lrs[0]
    times, checks = [], []
    for tile, out_dir in ((192, sr_dir), (RAGGED_TILE, sr176_dir)):
        pipe = build_pipeline(model_dir, tile=tile)
        model = pipe.model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        u8_k = pipe.run_tiled_u8(lr_big)
        image_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tiny_k = pipe.run_tiled_u8(lrs[1])
        set_kernels(model, False)
        t0 = time.perf_counter()
        u8_p = pipe.run_tiled_u8(lr_big)
        plain_s = time.perf_counter() - t0
        tiny_p = pipe.run_tiled_u8(lrs[1])
        set_kernels(model, True)
        png = np.round(load_image(os.path.join(out_dir, os.path.basename(big))) * 255)
        lsb = dict(stitched_vs_plain=int(np.abs(u8_k.astype(np.int32) - u8_p).max()),
                   served_vs_stitched=int(np.abs(png.astype(np.int32) - u8_k).max()),
                   tiny_vs_plain=int(np.abs(tiny_k.astype(np.int32) - tiny_p).max()))
        require(u8_k.shape == (4 * 480, 4 * 640, 3) and tiny_k.shape == (120, 160, 3),
                f"tiled outputs {u8_k.shape} {tiny_k.shape}")
        # two tiles of the 2K frame as one chunk
        with torch.inference_mode():
            x = torch.from_numpy(np.stack([lr_big[:tile, :tile],
                                           lr_big[-tile:, -tile:]])).cuda()
            _, bands_k, fused_k, out_k = ens_forward(model, x)
            set_kernels(model, False)
            _, bands_p, fused_p, out_p = ens_forward(model, x)
            set_kernels(model, True)
            torch.cuda.synchronize()
            errs = {n: ((a - b).abs().max().item(), SLICE_RTOL * b.abs().max().item())
                    for n, a, b in (("bands", bands_k, bands_p), ("fused", fused_k, fused_p),
                                    ("out", out_k, out_p))}
            finite = bool(torch.isfinite(out_k).all() and torch.isfinite(fused_k).all())
            inside = ((out_k > 0) & (out_k < 1)).float().mean().item()
            del bands_k, fused_k, out_k, bands_p, fused_p, out_p
            chunk_ms = {}
            for path, on in (("kernel", True), ("plain", False)):
                set_kernels(model, on)
                chunk_ms[path] = cuda_ms(lambda: model(x), iters=2)
            set_kernels(model, True)
        checks.append(dict(tile=tile, **lsb, finite=finite, share_inside_0_1=inside,
                           **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
                           **{f"{n}_bound": b for n, (_, b) in errs.items()}))
        n_tiles = num_tiles(480, 640, tile, 32, 2)
        times.append(dict(tile=tile, lr=[640, 480], tiles=n_tiles, chunks=-(-n_tiles // 2),
                          chunk_kernel_ms=chunk_ms["kernel"], chunk_plain_ms=chunk_ms["plain"],
                          image_kernel_s=image_s, image_plain_s=plain_s, peak_mem_gib=peak))
        if tile == 192:
            # one frame that both paths can serve: 510x339 whole (bucket 512x352) and tiled
            frame = lrs[2]
            with torch.inference_mode():
                xw = torch.from_numpy(pipe._pad([frame], 352, 512)).cuda()
                whole_ms = cuda_ms(lambda: model(xw), iters=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run_tiled(frame)
            torch.cuda.synchronize()
            times[-1].update(frame=[510, 339], frame_tiles=num_tiles(339, 510, 192, 32, 2),
                             frame_whole_ms=whole_ms,
                             frame_tiled_ms=1e3 * (time.perf_counter() - t0))
            if profile:
                profile_forward("tiled", lambda: model(x))
                set_kernels(model, False)
                profile_forward("tiled_plain", lambda: model(x))
                set_kernels(model, True)
        del pipe, model
        torch.cuda.empty_cache()
    emit("tiled_check", checks=checks)
    emit("tiled_time", per_tile=times)
    for c in checks:
        require(c["finite"], "non-finite output on the tiled path")
        require(max(c["stitched_vs_plain"], c["served_vs_stitched"], c["tiny_vs_plain"]) <= 1,
                f"tiled images differ by more than 1 LSB: {c}")
        for n in ("bands", "fused", "out"):
            require(c[f"{n}_max_abs_err"] <= c[f"{n}_bound"], f"tiled chunk {n} error: {c}")
        require(c["share_inside_0_1"] > 0.05, f"tiled chunk output saturated: {c}")
    return {k: counts.get(k, 0) + counts176.get(k, 0) for k in {**counts, **counts176}}


def hat_odd_slice(gen_cpu: torch.Generator) -> dict:
    """HAT at HAT-L's width (embed 180, 6 heads of 30, compress 3, squeeze 30, mlp_ratio 2)
    with a 15-px window on [1,225,225,3], depth cut to 2 groups of 6 HAB + OCAB. A 6-px
    overlap (overlap_ratio 0.4) tiles 225 px into 15 key windows a side. H and W are odd, so
    every HAB fails the fused gate and launches the standalone window attention once (half
    of them shifted, with the mask types); the OCAB is outside its gate and runs in torch."""
    model = HAT(depths=(6, 6), num_heads=(6, 6), window=15, overlap_ratio=0.4)
    randomize_transformer_(model, gen_cpu)
    model = model.cuda().eval()
    x = torch.rand(1, 225, 225, 3, generator=gen_cpu).cuda()
    reset_launches()
    with torch.inference_mode():
        sr, deep = model(x)
        torch.cuda.synchronize()
        counts = {k: n for k, n in read_launches().items() if n}
        set_kernels(model, False)
        sr_p, deep_p = model(x)
        torch.cuda.synchronize()
        errs = {"sr": ((sr - sr_p).abs().max().item(), SLICE_RTOL * sr_p.abs().max().item()),
                "deep": ((deep - deep_p).abs().max().item(),
                         SLICE_RTOL * deep_p.abs().max().item())}
        finite = bool(torch.isfinite(sr).all() and torch.isfinite(deep).all())
        inside = ((sr > 0) & (sr < 1)).float().mean().item()
        ms = {}
        for path, on in (("kernel", True), ("plain", False)):
            set_kernels(model, on)
            ms[path] = cuda_ms(lambda: model(x), iters=3)
        set_kernels(model, True)
    emit("hat_odd", params=sum(p.numel() for p in model.parameters()), shape=list(x.shape),
         window=15, output=list(sr.shape), launches=counts, finite=finite,
         share_inside_0_1=inside, kernel_ms=ms["kernel"], plain_ms=ms["plain"],
         **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
         **{f"{n}_bound": b for n, (_, b) in errs.items()})
    require(sr.shape == (1, 900, 900, 3) and finite, f"hat_odd output {sr.shape}")
    # 12 HABs, 3 convs (2 groups + conv_after_body); nothing else of the package launches
    require(counts == {"fused_window_attention": 12, "conv3x3_dense": 3},
            f"launches on the hat_odd path {counts}")
    for n, (e, bnd) in errs.items():
        require(e <= bnd, f"hat_odd {n} error {e} > {bnd}")
    require(inside > 0.05, f"only {inside:.3f} of the output lies in (0,1)")
    return counts


HEAD_KERNELS = ("fused_band_mha", "lka_gate")
TRAIN_LR = 96          # the synthetic training frames' LR side (HR 384)
TRAIN_PAIRS = 4        # training pairs (4 crops each at patch 64), and as many for validation


def require_plain(tag: str, shape: list, pairs: dict) -> None:
    """pairs: name -> (kernel run, plain run) of one forward; each finite and within
    SLICE_RTOL of the plain run's largest magnitude."""
    errs = {n: ((a - b).abs().max().item(), SLICE_RTOL * b.abs().max().item())
            for n, (a, b) in pairs.items()}
    finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
    emit(tag, input=shape, finite=finite, **{f"{n}_max_abs_err": e for n, (e, _) in errs.items()},
         **{f"{n}_bound": b for n, (_, b) in errs.items()})
    require(finite, f"{tag}: non-finite output")
    for n, (e, bnd) in errs.items():
        require(e <= bnd, f"{tag}: {n} error {e} > {bnd}")


def write_pairs(root: str, n: int, split: str, seed: int) -> None:
    """n smooth random HR frames of TRAIN_LR x 4 px and their 4x box-downsampled LR frames
    under root/{split}_HR and root/{split}_LR (the layout find_split_dirs takes first)."""
    rng = np.random.default_rng(seed)
    side = 4 * TRAIN_LR
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        img = np.zeros((side, side, 3))
        for _ in range(6):
            fy, fx, ph = rng.uniform(1, 20, 2).tolist() + [rng.uniform(0, 6.3)]
            img += rng.uniform(0.05, 0.15, 3) * np.sin(fy * yy + fx * xx + ph)[..., None]
        hr = np.clip(0.5 + img + 0.02 * rng.standard_normal(img.shape), 0, 1)
        lr = hr.reshape(TRAIN_LR, 4, TRAIN_LR, 4, 3).mean(axis=(1, 3))
        save_image(hr.astype(np.float32), os.path.join(root, f"{split}_HR", f"{i:04d}.png"))
        save_image(lr.astype(np.float32), os.path.join(root, f"{split}_LR", f"{i:04d}x4.png"))


def train_slice(per_forward: dict) -> dict:
    """The training path on the card at full width (FusionConfig(), HAT-L, DAT, NAFNet-64,
    the yaml's 64-px LR patches), f32 with TF32 off:
      1. extraction: extract_cached_features with the full ExpertEnsemble (the ens phase's
         seeded weights, from its .pth files) on 4 HR/LR pairs at LR 96x96, 4 crops an image
         at patch 64 in batches of 8 (and 1 crop an image for validation): every expert
         kernel as often as a forward launches it, each batch; then one batch of 8 crops
         through the experts with kernels and with plain versions, every output and
         feature map within SLICE_RTOL;
      2. cached training through cli/train.py's `train` (the shipped yaml, --debug, batch
         14, 2 epochs): the head's train steps launch no kernel, the one validation forward
         (features passed: the collaborative branch runs) B11 once and B12 twice; a finite
         loss, latest.ckpt and a best_*.ckpt; then the validation batch (padded to 14)
         through the EMA head with kernels and with plain versions, the fused bands, the
         collaborative outputs and the output within SLICE_RTOL;
      3. a cached step on the card against the same step on the CPU and on the card in
         float64 (fixed weights, a batch of 2, lr 1e-4, dropout off): loss and grad_norm
         within 1e-4 relative; each leaf's gradient within the larger of 1e-4 of its
         largest float64 value and 8x the CPU's float32 error there; every updated
         parameter within 1e-5 but where |g64| is within that bound (AdamW's first step
         is about lr * sign(g), and float32 does not settle the sign): those are counted
         by leaf and held to 2 lr; then 20 steps on one batch of 14 at lr 1e-3, timed,
         whose last loss must be below the first;
      4. live training through `train` (--no-cached --debug, batch 2): every step launches
         each expert kernel as a forward does, and so does each validation forward (no
         features), which adds B11 and B12 once; no expert parameter changes, the head's do;
      5. infer.io.main serves the three requests from step 2's checkpoint within 1 LSB of
         the in-memory model with that checkpoint's EMA weights (what main serves)."""
    import argparse
    import shutil

    from freqfusion_tpu_torch.cli import train as cli_train
    from freqfusion_tpu_torch.data.dataset import find_split_dirs, list_image_paths, match_pairs
    from freqfusion_tpu_torch.data.cached import CachedFeatureDataset, batch_iterator
    from freqfusion_tpu_torch.data.extract import extract_cached_features
    from freqfusion_tpu_torch.infer.io import load_expert_checkpoints
    from freqfusion_tpu_torch.losses import CombinedLoss
    from freqfusion_tpu_torch.models import layers
    from freqfusion_tpu_torch.models.fusion import EXPERT_ORDER, FusionHead
    from freqfusion_tpu_torch.parallel.mesh import shard_batch
    from freqfusion_tpu_torch.training.steps import make_optimizer, make_train_step

    t_phase = time.perf_counter()
    root = os.path.join(OUT, "train")
    shutil.rmtree(root, ignore_errors=True)
    data, model_dir = os.path.join(root, "data"), os.path.join(root, "model_dir")
    os.makedirs(model_dir)
    os.symlink(os.path.join(OUT, "model_dir", "pretrained"), os.path.join(model_dir, "pretrained"))
    write_pairs(data, TRAIN_PAIRS, "train", SEED)
    write_pairs(data, TRAIN_PAIRS, "val", SEED + 1)
    expert_forward = {k: n for k, n in per_forward.items() if k not in HEAD_KERNELS}
    ref = FreqFusionSR()
    load_expert_checkpoints(ref, model_dir)
    ref = ref.cuda().eval()

    # 1. extraction
    def forward_batch(arr):
        with torch.no_grad():
            outs, feats = ref.experts(torch.from_numpy(arr).cuda())
        return ({k: v.cpu().numpy() for k, v in outs.items()},
                {k: v.cpu().numpy() for k, v in feats.items()})

    def load_pair(lp, hp):
        return load_image(str(lp)), load_image(str(hp))

    reset_launches()
    t0 = time.perf_counter()
    written = {}
    for split, crops in (("train", 4), ("val", 1)):
        pairs = match_pairs(*map(list_image_paths, find_split_dirs(data, split)))
        written[split] = extract_cached_features(pairs, load_pair, forward_batch,
                                                 os.path.join(root, f"cache_{split}"), patch=64,
                                                 crops_per_image=crops, batch=8, seed=SEED)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    extract_counts = {k: n for k, n in read_launches().items() if n}
    batches = -(-written["train"] // 8) + -(-written["val"] // 8)
    emit("train_extract", samples=written, batches=batches, seconds=extract_s,
         launches=extract_counts)
    require(written == {"train": 4 * TRAIN_PAIRS, "val": TRAIN_PAIRS}, f"extracted {written}")
    require(extract_counts == {k: batches * n for k, n in expert_forward.items()},
            f"extraction launches {extract_counts}, {batches} x {expert_forward} expected")
    # one extraction batch (8 crops of 64x64) once more, the experts' kernels against their
    # plain versions: every output and feature map (these launches are not the path's)
    train_ds = CachedFeatureDataset(os.path.join(root, "cache_train"), augment=False)
    x8 = torch.from_numpy(next(batch_iterator(train_ds, 8, shuffle=False))["lr"]).cuda()
    with torch.inference_mode():
        outs_k, feats_k = ref.experts(x8)
        set_kernels(ref, False)
        outs_p, feats_p = ref.experts(x8)
        set_kernels(ref, True)
    require_plain("train_extract_check", list(x8.shape),
                  {f"{kind}_{n}": (a[n], b[n]) for kind, a, b in
                   (("out", outs_k, outs_p), ("feat", feats_k, feats_p)) for n in b})
    del x8, outs_k, feats_k, outs_p, feats_p

    # 2. cached training through the CLI
    args = argparse.Namespace(batch_size=None, epochs=None, data_root=None, cached=None,
                              debug=True)
    cfg = cli_train.load_config(os.path.join(ROOT, "configs", "train_config.yaml"), args)
    ckpt_dir = os.path.join(model_dir, "checkpoints")
    cfg["data"].update(batch_size=14, cached_train_dir=os.path.join(root, "cache_train"),
                       cached_val_dir=os.path.join(root, "cache_val"))
    cfg["train"].update(checkpoint_dir=ckpt_dir, log_dir=os.path.join(root, "logs"))
    reset_launches()
    t0 = time.perf_counter()
    best = cli_train.train(cfg, "cuda")
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    cached_counts = {k: n for k, n in read_launches().items() if n}
    names = sorted(os.listdir(ckpt_dir))
    record = torch.load(os.path.join(ckpt_dir, "latest.ckpt"), map_location="cuda",
                        weights_only=True)
    with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    emit("train_cached", batch=14, epochs=2, seconds=cached_s, launches=cached_counts,
         best_psnr=best, checkpoints=names, step=record["step"])
    # one validation forward (4 samples in a padded batch of 14), features passed
    require(cached_counts == {"fused_band_mha": 1, "lka_gate": 2},
            f"cached training launches {cached_counts}")
    require("latest.ckpt" in names and any(n.startswith("best_") for n in names),
            f"checkpoints {names}")
    require(best is not None and np.isfinite(best), f"validation PSNR {best}")
    # the validation batch (padded to 14, as `train` pads it) through the head with the EMA
    # weights it validated, B11 and B12 against their plain versions: the three fused bands
    # (band attention and the first LKA gate), the collaborative branch's outputs (the
    # second) and the output
    head_val = FusionHead().cuda().eval()
    head_val.load_state_dict(record["model"])
    with torch.no_grad():
        for k, p in head_val.named_parameters():
            p.copy_(record["ema_state"][k])
    vb = next(batch_iterator(CachedFeatureDataset(cfg["data"]["cached_val_dir"],
                                                  augment=False), 14, shuffle=False,
                             drop_last=False))
    vb = shard_batch(cli_train._pad_batch(vb, 14 - vb["lr"].shape[0]), torch.device("cuda"))
    order = EXPERT_ORDER[:head_val.cfg.num_experts]

    def head_stages():
        bands = head_val.process_frequency_bands(vb["lr"])
        enhanced = head_val.collaborative(vb["expert_features"],
                                          [vb["expert_outputs"][n] for n in order])
        return (torch.cat(bands, -1), torch.cat(enhanced, -1),
                head_val(vb["lr"], vb["expert_outputs"], vb["expert_features"]))

    with torch.inference_mode():
        staged_k = head_stages()
        set_kernels(head_val, False)
        staged_p = head_stages()
        set_kernels(head_val, True)
    require_plain("train_val_check", list(vb["lr"].shape),
                  {n: (a, b) for n, a, b in zip(("bands", "collaborative", "out"), staged_k,
                                                staged_p)})
    del head_val, vb, staged_k, staged_p

    # 3. the step on the card against the CPU, then 20 steps on one batch
    ds = CachedFeatureDataset(cfg["data"]["cached_train_dir"], augment=False)
    weights = cfg["loss"]["stages"][2]["weights"]   # every loss of the recipe
    gen_cpu = torch.Generator().manual_seed(SEED)
    head_cpu = FusionHead()
    randomize_head_(head_cpu, gen_cpu)
    batch2 = next(batch_iterator(ds, 2, shuffle=False))
    results = {}
    lr_check = 1e-4
    real_dropout = layers.dropout
    layers.dropout = lambda x, p, training: x   # masks would differ between the devices
    try:
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                        ("cuda", torch.float64)):
            head = FusionHead().to(dev, dt)
            head.load_state_dict(head_cpu.state_dict())
            opt = make_optimizer(head, lambda n: lr_check, cfg["optim"]["weight_decay"],
                                 cfg["optim"]["grad_clip"], 1)
            step = make_train_step(head, CombinedLoss(weights), opt)
            b = shard_batch(batch2, torch.device(dev))
            m = step({k: ({n: t.to(dt) for n, t in v.items()} if isinstance(v, dict)
                          else v.to(dt) if isinstance(v, torch.Tensor) else v)
                      for k, v in b.items()})
            results[(dev, dt)] = ({k: float(v) for k, v in m.items()},
                                  {k: p.detach().double().cpu()
                                   for k, p in head.named_parameters()},
                                  {k: p.grad.double().cpu() for k, p in head.named_parameters()
                                   if p.grad is not None})
    finally:
        layers.dropout = real_dropout
    (mg, sg, gg), (mc, sc, gc), (_, _, g64) = results.values()
    rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("total", "grad_norm")}
    # Each leaf's gradient on the card is held to the float64 one within the larger of
    # 1e-4 of the leaf's largest and 8x the CPU's own float32 error on that leaf. AdamW's
    # first step is about lr * sign(g): where |g64| lies within that bound, float32 does not
    # settle the sign, and the two devices may step +-lr apart. Those elements are counted
    # by leaf and held to 2 lr; every other updated element to 1e-5.
    grad_worst, param_err, left_err, left = (0.0, ""), 0.0, 0.0, {}
    for k in sc:
        d = (sg[k] - sc[k]).abs()
        if k not in g64:
            param_err = max(param_err, d.max().item())
            continue
        ref_g = g64[k]
        bound = max(1e-4 * ref_g.abs().max().item(), 8 * (gc[k] - ref_g).abs().max().item())
        err = (gg[k] - ref_g).abs().max().item()
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else float("inf"))
        grad_worst = max(grad_worst, (ratio, k))
        settled = ref_g.abs() > bound
        if settled.any():
            param_err = max(param_err, d[settled].max().item())
        if not settled.all():
            left[k] = int((~settled).sum())
            left_err = max(left_err, d[~settled].max().item())
    head = FusionHead().cuda()
    head.load_state_dict(head_cpu.state_dict())
    opt = make_optimizer(head, lambda n: 1e-3, cfg["optim"]["weight_decay"],
                         cfg["optim"]["grad_clip"], 1)
    step = make_train_step(head, CombinedLoss(weights), opt)
    batch14 = shard_batch(next(batch_iterator(ds, 14, shuffle=False)), torch.device("cuda"))
    gen_drop = torch.Generator("cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(batch14, gen_drop)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(m["total"]))
    step_ms = mean(times[1:])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("train_step_check", loss_rel_err=rel["total"], grad_norm_rel_err=rel["grad_norm"],
         grad_err_over_bound=grad_worst[0], grad_worst_leaf=grad_worst[1],
         max_param_err=param_err, left_out_max_param_err=left_err,
         left_out_elements=sum(left.values()), left_out_leaves=len(left),
         left_out_by_leaf=dict(sorted(left.items(), key=lambda kv: -kv[1])[:40]),
         params=sum(t.numel() for t in sc.values()), bound_rel=1e-4, bound_param=1e-5,
         bound_left_out=2 * lr_check, loss_cuda=mg["total"],
         loss_cpu=mc["total"], losses_20=losses, cached_step_ms=step_ms, batch=14,
         images_per_s=14e3 / step_ms, peak_gib=peak_gib, head_params=sum(
             p.numel() for p in head.parameters()))
    require(rel["total"] <= 1e-4 and rel["grad_norm"] <= 1e-4, f"card against CPU {rel}")
    require(grad_worst[0] <= 1, f"gradient of {grad_worst[1]}: {grad_worst[0]} x its bound")
    require(param_err <= 1e-5, f"updated parameters differ by {param_err}")
    require(left_err <= 2 * lr_check * (1 + 1e-3),
            f"parameters of unsettled gradient sign differ by {left_err}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], f"losses {losses}")
    del head, opt, step, batch14

    # 4. live training through the CLI
    built = []

    class Captured(FreqFusionSR):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            head = {k: t.cpu().clone() for k, t in self.fusion.state_dict().items()}
            built.append((self, head))

    live_cfg = cli_train.load_config(os.path.join(ROOT, "configs", "train_config.yaml"),
                                     argparse.Namespace(batch_size=None, epochs=None,
                                                        data_root=data, cached=False,
                                                        debug=True))
    live_cfg["model_dir"] = model_dir
    live_cfg["train"].update(checkpoint_dir=os.path.join(root, "live_ckpt"),
                             log_dir=os.path.join(root, "live_logs"))
    cli_train.FreqFusionSR = Captured
    reset_launches()
    t0 = time.perf_counter()
    try:
        live_best = cli_train.train(live_cfg, "cuda")
        torch.cuda.synchronize()
    finally:
        cli_train.FreqFusionSR = FreqFusionSR
    live_s = time.perf_counter() - t0
    live_counts = {k: n for k, n in read_launches().items() if n}
    live_model, head0 = built[0]
    # 2 epochs of TRAIN_PAIRS samples in batches of 2; one validation (epoch 1) of as many
    # center crops, in batches of 2
    n_steps, n_val = 2 * (TRAIN_PAIRS // 2), TRAIN_PAIRS // 2
    want = {k: (n_steps + n_val) * n for k, n in expert_forward.items()}
    want.update({k: n_val for k in HEAD_KERNELS})
    ref_experts = ref.experts.state_dict()
    experts_same = all(torch.equal(t, ref_experts[k])
                       for k, t in live_model.experts.state_dict().items())
    head_moved = any(not torch.equal(t.cpu(), head0[k])
                     for k, t in live_model.fusion.state_dict().items() if t.is_floating_point())
    opt = make_optimizer(live_model.fusion, lambda n: 1e-4)
    from freqfusion_tpu_torch.training.steps import make_live_train_step
    live_step = make_live_train_step(live_model, CombinedLoss(weights), opt)
    b_live = {k: v[:2] for k, v in batch2.items() if k in ("lr", "hr")}
    b_live = shard_batch(b_live, torch.device("cuda"))
    live_ms = cuda_ms(lambda: live_step(b_live), iters=2)
    emit("train_live", batch=2, steps=n_steps, seconds=live_s, launches=live_counts,
         best_psnr=live_best, experts_unchanged=experts_same, head_changed=head_moved,
         live_step_ms=live_ms, images_per_s=2e3 / live_ms)
    require(live_counts == want, f"live training launches {live_counts}, {want} expected")
    require(experts_same and head_moved, "a frozen expert changed, or the head did not")
    del live_model, live_step, opt, built
    torch.cuda.empty_cache()

    # 5. the trained checkpoint served through main, against the model in memory
    req_dir = os.path.join(OUT, "requests")
    sr_dir = os.path.join(root, "sr")
    reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # no fusion_head.pth: the .ckpt is the head's file
        served = serve_directory(model_dir, req_dir, sr_dir)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_counts = {k: n for k, n in read_launches().items() if n}
    best_path = sorted(os.path.join(ckpt_dir, n) for n in names if n.startswith("best_"))[0]
    best_record = torch.load(best_path, map_location="cuda", weights_only=True)
    # main serves a checkpoint's EMA weights (infer/io.py: read_native_checkpoint)
    ref.fusion.load_state_dict(best_record["model"])
    with torch.no_grad():
        for k, p in ref.fusion.named_parameters():
            p.copy_(best_record["ema_state"][k])
    pipe = InferencePipeline(ref, "cuda")
    lsb = 0
    for f in list_images(req_dir):
        lr = load_image(f)
        handle = pipe.dispatch_batch_u8([lr], pipe._whole_image_plan(*lr.shape[:2]))
        want_u8 = pipe.materialize_u8(handle)[0].astype(np.int32)
        got_u8 = np.asarray(Image.open(os.path.join(sr_dir, os.path.basename(f)))).astype(
            np.int32)
        lsb = max(lsb, int(np.abs(got_u8 - want_u8).max()))
    emit("train_serve", served=served, seconds=serve_s, launches=serve_counts,
         checkpoint=os.path.basename(best_path), max_lsb_against_ema_head=lsb)
    require(served == len(REQUESTS), f"served {served}")
    require(lsb <= 1, f"served images differ from the EMA head in memory by {lsb} LSB")
    phase_s = time.perf_counter() - t_phase
    emit("train_time", seconds=phase_s, nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    total = {}
    for c in (extract_counts, cached_counts, live_counts, serve_counts):
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def profile_forward(tag: str, forward) -> None:
    """Device time of one `forward()` by kernel (torch.profiler), after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # an operator's row repeats its kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    own = sum(ms for ms, _, k in rows if "(anonymous namespace)::" in k and "at::" not in k)
    emit(f"{tag}_profile", total_device_ms=sum(r[0] for r in rows), hand_written_ms=own,
         top=[dict(ms=round(ms, 3), calls=n, name=k[:90]) for ms, n, k in rows[:24]])


# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "naf_block_stage_a": ("freqfusion_tpu_torch/csrc/nafblock.cu",
                          "freqfusion_tpu/ops/pallas/nafblock.py:164"),
    "naf_block_stage_b": ("freqfusion_tpu_torch/csrc/nafblock.cu",
                          "freqfusion_tpu/ops/pallas/nafblock.py:229"),
    "conv3x3_dense": ("freqfusion_tpu_torch/csrc/conv3x3.cu",
                      "freqfusion_tpu/ops/pallas/cab.py:267"),
    # B4 and B8's attention are one kernel, csrc/hab_attention.cu
    "fused_window_attention_xqkv": ("freqfusion_tpu_torch/csrc/hab_attention.cu",
                                    "freqfusion_tpu/ops/pallas/wattn.py:599"),
    "aim_conv_branch": ("freqfusion_tpu_torch/csrc/aim.cu",
                        "freqfusion_tpu/ops/pallas/aim.py:77"),
    "aim_gates_proj": ("freqfusion_tpu_torch/csrc/aim.cu",
                       "freqfusion_tpu/ops/pallas/aim.py:161"),
    # B6 starts with the fc1 row kernel of csrc/hat_rows.cu
    "fused_sgfn_tail": ("freqfusion_tpu_torch/csrc/sgfn.cu",
                        "freqfusion_tpu/ops/pallas/sgfn.py:82"),
    "cab_chain": ("freqfusion_tpu_torch/csrc/cab.cu", "freqfusion_tpu/ops/pallas/cab.py:145"),
    # B8 and B9 end in the row kernels of csrc/hat_rows.cu
    "fused_hab_block": ("freqfusion_tpu_torch/csrc/hab_attention.cu",
                        "freqfusion_tpu/ops/pallas/wattn.py:273"),
    "fused_overlap_attention": ("freqfusion_tpu_torch/csrc/oca.cu",
                                "freqfusion_tpu/ops/pallas/wattn.py:706"),
    "fused_residual_ln_mlp": ("freqfusion_tpu_torch/csrc/hat_rows.cu",
                              "freqfusion_tpu/ops/pallas/wattn.py:427"),
    "fused_band_mha": ("freqfusion_tpu_torch/csrc/bandmha.cu",
                       "freqfusion_tpu/ops/pallas/bandmha.py:99"),
    "lka_gate": ("freqfusion_tpu_torch/csrc/lka.cu", "freqfusion_tpu/ops/pallas/lka.py:102"),
    "fused_window_attention_qkv": ("freqfusion_tpu_torch/csrc/wattn.cu",
                                   "freqfusion_tpu/ops/pallas/wattn.py:504"),
    # B14's two projections are the row kernel of csrc/hat_rows.cu
    "fused_window_attention": ("freqfusion_tpu_torch/csrc/wattn.cu",
                               "freqfusion_tpu/ops/pallas/wattn.py:780"),
}


def main() -> None:
    t0 = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    gen = torch.Generator("cuda").manual_seed(SEED)
    res = phase_kernels(gen)
    args = sys.argv[1:]
    profiled = set()
    if "--profile" in args:   # --profile [dat|hat|ens|head|tiled], or several: hat,ens
        nxt = args[args.index("--profile") + 1:][:1]
        names = set(nxt[0].split(",")) if nxt else set()
        profiled = names & {"dat", "hat", "ens", "head", "tiled"} or {"dat"}
    paths = [("naf", naf_slice(torch.Generator().manual_seed(SEED)))]
    torch.cuda.empty_cache()
    paths.append(("dat", dat_slice(torch.Generator().manual_seed(SEED), "dat" in profiled)))
    torch.cuda.empty_cache()
    paths.append(("hat", hat_slice(torch.Generator().manual_seed(SEED), "hat" in profiled)))
    torch.cuda.empty_cache()
    solo = {k: sum(n.get(k, 0) for _, n in paths) for k in KERNELS}
    paths.append(("ens", ens_slice(torch.Generator().manual_seed(SEED), profiled, solo)))
    torch.cuda.empty_cache()
    per_forward = {k: n // len(REQUESTS) for k, n in paths[-1][1].items()}
    paths.append(("tiled", tiled_slice(per_forward, "tiled" in profiled)))
    torch.cuda.empty_cache()
    paths.append(("hat_odd", hat_odd_slice(torch.Generator().manual_seed(SEED))))
    torch.cuda.empty_cache()
    paths.append(("train", train_slice(per_forward)))
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(n.get(k, 0) for _, n in paths),
                "launches_by_path": {tag: n[k] for tag, n in paths if k in n},
                "max_abs_err": res[k]["err"], "ms": res[k]["ms"],
                "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound"][0],
                "bound_by": res[k]["bound"][1],
                "bound_f32_ms": res[k].get("bound_f32", res[k]["bound"])[0],
                "library_ms": res[k]["library_ms"], **res[k].get("extra", {})}
               for k, (src, rep) in KERNELS.items()]
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
