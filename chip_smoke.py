#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card and check its kernels.

    python3 chip_smoke.py        # from the repository root; needs one card and nvcc

Phases, each printing JSON lines; any failure raises and the exit code is not 0:
  1. device: the card (nvidia-smi name and power limit), TF32 off for every comparison;
  2. build: nvcc builds freqfusion_tpu_torch/csrc into a library (seconds printed): three
     instantiations of every kernel (f32; bf16; precision "default", f32 storage with bf16
     operands), and ptxas -v must show every instantiation of every tensor-core kernel and
     of B5a (aim_conv_branch_kernel) at <= 128 registers with no spill;
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
 7b. bf16: the same model at bf16 (FREQFUSION_DTYPE=bfloat16): every kernel of the path at
     bf16 at the f32 summaries' shapes against its plain bf16 version (max |Δ| <= 1e-2 x
     max|plain|, the f32 channel sums within 1e-3) and a float64 evaluation of the same bf16
     inputs (at most twice the plain bf16 version's distance), `kernel_bf16` lines with a
     bf16 bound (2-byte elements, bf16 tensor cores at 989 TFLOP/s); infer.io.main at
     dtype="bfloat16" on the three requests (launches equal to the f32 phase's), the
     runner on the 640x480 frame with FREQFUSION_DTYPE=bfloat16 (6 chunks of the per-image
     launches); the whole forward's fused image within 1.5x the plain bf16 path's RMS
     distance from the f32 kernel forward, PSNR of both, ms and PSNR by expert and the
     head's ms at both dtypes; per-image ms at the three buckets on both bf16 paths;
  7c. default: the same model at precision "default" (FREQFUSION_PRECISION=default: f32
     storage, every kernel's matmul operands rounded to bf16, f32 accumulation, TF32 in the
     glue): every kernel's default instantiation (B5a: its f32 one) at the bf16 phase's
     shapes on the same f32 inputs against its plain default version (max |Δ| <= 1e-2 x
     max|plain|, the f32 channel sums within 1e-3), a float64 evaluation (at most twice the
     plain default version's distance) and the rounding check (RMS |kernel - plain default|
     <= 0.25 x RMS |plain default - plain f32|, which the f32 kernel and, for an attention,
     the plain default version with p unrounded must fail; B8's two launches also each
     against its plain half, `kernel_default_half` lines; beside each ratio the plain
     default version's own with float64 sums), `kernel_default` lines with a default bound
     (4-byte elements, bf16 tensor cores at 989 TFLOP/s); infer.io.main at
     precision="default" on the three requests (launches equal to the f32 phase's, both
     TF32 flags on and bf16 operands inside every forward, the caller's state after), the
     runner on the 640x480 frame with FREQFUSION_PRECISION=default; the whole forward's
     fused image within 1.5x the plain default path's RMS distance from the f32 kernel
     forward, PSNR of both; per-image ms at the three buckets on both default paths and the
     f32 kernel path;
 7d. bf16_wide: the bf16 routes that took f32 only before (B5b and B8 at C = 256 and 384,
     B11's wide route at D = 400 and 512 and at 65 and 129 tokens, B12 at C = 1816 and
     2048), each against its plain bf16 version at the bf16 bounds of 7b;
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
     within 1 LSB of the model in memory;
 10b. parallel: the data-parallel paths (parallel_slice): cli/graft_entry.py's entry() (the
     full FreqFusionSR on a 64x64 tile, every kernel of a served forward, against the plain
     path) and dryrun_multichip over nccl on every card present; two gloo ranks sharing the
     card against one process at the same global batch, a cached step of the shipped head
     at batch 14 in float64 and a live step of the full model at batch 2 in float32 with
     dropout and BatchNorm on (loss and grad_norm within 1e-5 relative, gradients within
     1e-5 x max|g|, parameters and statistics within 1e-6, masks equal; in float32 1e-4 on
     loss, grad_norm and gradients, the parameters of near-zero gradient within 2 lr); and
     cli/bucket_histogram.py over the request shapes. Its `parallel` line gives seconds by
     path, the `parallel_cached` / `parallel_live` lines the step seconds and peak GiB of
     each rank and of one process;
 11. eval: the eval path at the towers' published widths (eval_slice): cli/eval.py on the
     ens phase's three served PNGs against seeded targets, with all five towers live from
     seeded random checkpoints (LPIPS-alex, DISTS-VGG16, MUSIQ, MANIQA ViT-B/8, CLIP
     ViT-B/32 with its text tower and a small BPE vocabulary): every column finite, three
     rows and a MEAN row, a total_score, seconds by column and peak memory; each tower on a
     384x512 crop on the card against the CPU and a float64 evaluation; the VGG19 and
     CLIP perceptual losses with their gradients at the training batch [14,256,256,3] on
     the card against the same; two
     cached steps of CombinedLoss with vgg 0.1 and clip 0.05 on the card. The eval path runs
     no kernel, and none may launch;
 12. tsdsr: infer.io.main serves a 512x336 PNG (2048x1344 out) with the ensemble's
     checkpoints, then CompleteSRPipeline(), live from FREQFUSION_TSDSR_WEIGHTS and
     FREQFUSION_SDVAE_WEIGHTS (seeded random tsdsr_base and SD 2.1 AutoencoderKL, written
     as .pth), refines it in student mode (an identity is a failure); the 4-step teacher
     on a 512x512 crop; a 2040x1356 image (latent 255x169) must raise; the VAE and the DiT
     on a 256x256 crop against a float64 evaluation on the card. The path launches exactly
     the ensemble's kernels of one image;
 13. v2_head: the full ExpertEnsemble (the ensemble's checkpoints) on the 512x352 bucket,
     then FusionHeadV2 on its outputs with and without its features, held to float64;
     launches exactly the experts' kernels of one forward (no B11, no B12);
 14. mambair: MambaIR at its published size serves the three requests through
     InferencePipeline, one forward timed, a 64x96 LR held to float64. No kernel launches.
Each of the last three phases ends on a line named after it with its ms, peak GiB, max |Δ|
against float64 (within max(1e-4 x max|float64|, 8x the CPU f32's error), as
`eval_tower_check` holds a score) and launches.
The kernel phase also runs the fusion head at FusionConfig(enable_hierarchical=False) (the
flat multi-resolution fusion of phase 5) once at the shipped width on a 352x512 frame with
the kernels and on the plain path (`repair` line `fusion_head`, `multi_resolution`: B11 and
B12 one launch each, within SLICE_RTOL x max|plain|).
With --profile [dat|hat|ens|head|tiled] (or several, comma-separated: --profile hat,ens),
one forward of each model named (DAT if none is named; `head` is the fusion head alone on
fixed expert outputs, `tiled` one chunk of two 192-px tiles on the kernel path and on the
plain path) is also traced with torch.profiler and its device time is printed by kernel.
The last two lines are the kernels' summary (each kernel's instantiations, its f32 numbers,
its bf16 ones: `ms_bf16`, `plain_ms_bf16`, `bound_bf16_ms`, `max_abs_err_bf16`,
`launches_bf16`, and its default ones: `ms_default`, `plain_ms_default`,
`bound_default_ms`, `max_abs_err_default`, `rounding_gap_default`, `launches_default`) and
{"ok": true, "device": {...}}. It exits non-zero without a CUDA card. The PNGs go to
build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import copy
import json
import math
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
from freqfusion_tpu_torch.infer.io import InferencePipeline, build_pipeline, pinned_precision
from freqfusion_tpu_torch.infer.io import main as serve_directory
from freqfusion_tpu_torch.infer.tiling import num_tiles
from freqfusion_tpu_torch.models import dat as dat_model
from freqfusion_tpu_torch.models.dat import DAT
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import EXPERT_ORDER, FusionConfig, FusionHead
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


# the tensor-core kernels and B5a (every instantiation: f32, bf16 and, but for B5a, precision
# "default"): at most 128 registers a thread (16 warps an SM, or two blocks of 8) and no spill
TC_KERNELS = ("conv3x3_gemm_kernel", "xqkv_attention_kernel", "oca_attn_kernel",
              "wattn_qkv_kernel", "sgfn_gate_fc2_kernel", "rows_pipelined_kernel",
              "naf_stage_a_kernel",
              "naf_stage_b_onchip_kernel", "naf_stage_b_rows_kernel", "aim_gates_proj_kernel",
              "band_mha_kernel", "lka_mix_kernel", "aim_conv_branch_kernel")


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
         instantiations={t: sum(t in k for k, _, _ in report) for t in TC_KERNELS},
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
            attention, tail, _, _ = wattn._hab_block_launchers(*h_args, mask, (ws, ws), heads,
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
    multires_head_repair()
    torch.cuda.empty_cache()
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
      1. extraction: cli/extract_features.py (extract_cached_features with the full
         ExpertEnsemble; the ens phase's seeded weights, from its .pth files) on 4 HR/LR pairs
         at LR 96x96, 4 crops an image at patch 64 in batches of 8 (and 1 crop an image for
         validation): every expert
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

    from freqfusion_tpu_torch.cli import extract_features as cli_extract
    from freqfusion_tpu_torch.cli import train as cli_train
    from freqfusion_tpu_torch.data.cached import CachedFeatureDataset, batch_iterator
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

    # 1. extraction through the CLI (its seeding kept from the phases after it)
    reset_launches()
    t0 = time.perf_counter()
    written = {}
    for split, crops in (("train", 4), ("val", 1)):
        with torch.random.fork_rng(devices=[torch.cuda.current_device()]):
            written[split] = cli_extract.main([
                "--data-root", data, "--split", split, "--out",
                os.path.join(root, f"cache_{split}"), "--model-dir", model_dir, "--patch", "64",
                "--crops-per-image", str(crops), "--batch", "8", "--seed", str(SEED)])
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


PARALLEL_RANKS = 2       # gloo ranks sharing the card in the parallel phase
PARALLEL_LR = 1e-4       # the steps' learning rate (the train phase's check's)


class _Masks:
    """Inside the block, ``layers.dropout`` records each call's kept elements (bit-packed)."""

    def __init__(self):
        from freqfusion_tpu_torch.models import layers
        self.layers, self.real, self.packed = layers, layers.dropout, []

    def __enter__(self):
        def recording(x, p, training):
            y = self.real(x, p, training)
            if training and p:
                keep = (y != 0).cpu().numpy()
                self.packed.append((keep.shape, np.packbits(keep.reshape(keep.shape[0], -1),
                                                            axis=1)))
            return y

        self.layers.dropout = recording
        return self

    def __exit__(self, *exc):
        self.layers.dropout = self.real


def parallel_steps(rank: int, n: int, head_state: dict, batch14: dict, model_dir: str,
                   batch2: dict, weights: dict) -> dict:
    """One of `n` gloo ranks sharing the card (n = 1: one process, the reference): a cached
    step of FusionConfig()'s head in float64 on `batch14` and a live step of the full
    FreqFusionSR (experts from `model_dir`, head from `head_state`) in float32 on `batch2`,
    both with dropout and BatchNorm on, at PARALLEL_LR. Returns each step's metrics,
    gradients, state after, dropout masks, seconds and this process's peak GiB, and the
    live step's launches."""
    from freqfusion_tpu_torch.infer.io import load_expert_checkpoints
    from freqfusion_tpu_torch.losses import CombinedLoss
    from freqfusion_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from freqfusion_tpu_torch.training.steps import (make_frozen_expert_optimizer,
                                                     make_live_train_step, make_optimizer,
                                                     make_train_step)

    mesh = make_mesh(n, "cuda", "gloo" if n > 1 else None, timeout_s=300)
    out = {}

    def run(tag, model, trained, step, batch, dtype):
        gen = torch.Generator(mesh.device).manual_seed(SEED)
        b = shard_batch(batch, mesh)
        b = {k: ({n_: t.to(dtype) for n_, t in v.items()} if isinstance(v, dict)
                 else v.to(dtype)) for k, v in b.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with _Masks() as masks, pinned_precision("highest"):
            m = step(b, gen)
        torch.cuda.synchronize()
        out[tag] = {"seconds": time.perf_counter() - t0,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                    "launches": {k: c for k, c in read_launches().items() if c},
                    "metrics": {k: float(v) for k, v in m.items()},
                    "grads": {k: p.grad.cpu() for k, p in trained.named_parameters()
                              if p.grad is not None},
                    "state": {k: t.cpu() for k, t in trained.state_dict().items()},
                    "masks": masks.packed}

    head = FusionHead().to(mesh.device, torch.float64)
    head.load_state_dict(head_state)
    opt = make_optimizer(head, lambda c: PARALLEL_LR, 1e-4, 1.0, 1)
    run("cached", head, head, make_train_step(head, CombinedLoss(weights), opt, mesh), batch14,
        torch.float64)
    del head, opt
    torch.cuda.empty_cache()
    model = FreqFusionSR()
    load_expert_checkpoints(model, model_dir)
    model.fusion.load_state_dict(head_state)
    model.to(mesh.device)
    opt = make_frozen_expert_optimizer(model, lambda c: PARALLEL_LR, 1e-4, 1.0, 1)
    run("live", model, model.fusion,
        make_live_train_step(model, CombinedLoss(weights), opt, mesh), batch2, torch.float32)
    if n == 1:   # the experts' float32 difference between one batch of 2 and two of 1
        lr = torch.from_numpy(batch2["lr"]).to(mesh.device)
        with torch.inference_mode(), pinned_precision("highest"):
            whole = model.experts(lr)
            parts = [model.experts(lr[i:i + 1]) for i in range(lr.shape[0])]
        out["live"]["experts_batch_rel_diff"] = max(
            float((whole[j][k] - torch.cat([p[j][k] for p in parts])).abs().max()
                  / whole[j][k].abs().max()) for j in range(2) for k in whole[j])
    return out


def hold_ranks(tag: str, one: dict, ranks_out: list, rel: float, leaf_max: bool) -> dict:
    """Each rank's step against one process's: loss and grad_norm within `rel` relative;
    each gradient within `rel` x max|g| (of its leaf where `leaf_max`, float64; else of the
    whole gradient, float32, whose leaves that cancel to near 0 hold rounding); the
    parameters and BatchNorm statistics after the step within 1e-6, but (float32) elements
    whose one-process |g| lies within that gradient bound, where AdamW's first step
    g / (|g| + eps) follows the gradient's last bits: those within 2 lr, counted; the
    dropout masks equal to one process's rows."""
    top = max(float(g.abs().max()) for g in one["grads"].values())
    res = {"loss_rel_err": 0.0, "grad_norm_rel_err": 0.0, "grad_err_over_bound": 0.0,
           "max_state_err": 0.0, "unsettled_elements": 0, "unsettled_max_err": 0.0,
           "masks": len(one["masks"]), "masks_equal": True}
    for r, got in enumerate(ranks_out):
        for k, key in (("total", "loss_rel_err"), ("grad_norm", "grad_norm_rel_err")):
            res[key] = max(res[key], abs(got["metrics"][k] - one["metrics"][k])
                           / abs(one["metrics"][k]))
        require(sorted(got["grads"]) == sorted(one["grads"]), f"{tag}: gradient leaves differ")
        unsettled = {}
        for k, g in one["grads"].items():
            bound = rel * (float(g.abs().max()) if leaf_max else top)
            err = float((got["grads"][k] - g).abs().max())
            res["grad_err_over_bound"] = max(res["grad_err_over_bound"],
                                             err / bound if bound else float(err > 0) * 1e9)
            if not leaf_max:
                unsettled[k] = g.abs() <= bound
        for k, v in one["state"].items():
            if not v.is_floating_point():
                require(torch.equal(got["state"][k], v), f"{tag}: {k} differs")
                continue
            d = (got["state"][k].double() - v.double()).abs()
            u = unsettled.get(k)
            if u is not None and bool(u.any()):
                res["unsettled_elements"] += int(u.sum())
                res["unsettled_max_err"] = max(res["unsettled_max_err"], float(d[u].max()))
                d = d[~u]
            if d.numel():
                res["max_state_err"] = max(res["max_state_err"], float(d.max()))
        require(len(got["masks"]) == len(one["masks"]), f"{tag}: dropout calls differ")
        for (shape, bits), (shape_r, bits_r) in zip(one["masks"], got["masks"]):
            per = shape[0] // len(ranks_out)
            res["masks_equal"] &= (shape_r[0] == per and np.array_equal(
                bits[r * per:(r + 1) * per], bits_r))
    emit(f"parallel_{tag}_check", ranks=len(ranks_out), bound_rel=rel, bound_state=1e-6,
         bound_unsettled=2 * PARALLEL_LR, **res)
    require(res["loss_rel_err"] <= rel and res["grad_norm_rel_err"] <= rel,
            f"{tag}: ranks against one process {res}")
    require(res["grad_err_over_bound"] <= 1, f"{tag}: gradients {res}")
    require(res["max_state_err"] <= 1e-6, f"{tag}: parameters or statistics {res}")
    require(res["unsettled_max_err"] <= 2 * PARALLEL_LR * (1 + 1e-3), f"{tag}: {res}")
    require(res["masks"] > 0 and res["masks_equal"], f"{tag}: dropout masks {res}")
    return res


def parallel_slice(per_forward: dict) -> dict:
    """The data-parallel paths on the card (cli/graft_entry.py, parallel/mesh.py):
      1. entry(): the full FreqFusionSR forward on a 64x64 tile launches every kernel of a
         served forward as often as the ens phase's forward does, and agrees with the
         plain path within SLICE_RTOL;
      2. dryrun_multichip(torch.cuda.device_count()) over nccl: a cached and a live step on
         that many ranks, a tile batch and a ragged uint8 group on as many replicas; its
         four OK lines;
      3. two gloo ranks sharing the card against one process at the same global batch
         (parallel_steps, hold_ranks): a cached step of FusionConfig()'s head at batch 14
         (7 a rank; 64-px LR patches from the train phase's cache) in float64 and a live
         step of the full FreqFusionSR at batch 2 in float32, dropout and BatchNorm on (the
         CPU tests' bounds in float64; in float32 1e-4 on loss, grad_norm and gradients);
      4. cli/bucket_histogram.py over the ens and tiled phases' request shapes: the whole
         and tiled counts those phases planned (3 whole; 1 whole and 2 tiled)."""
    import yaml

    from freqfusion_tpu_torch.cli import bucket_histogram, graft_entry
    from freqfusion_tpu_torch.data.cached import CachedFeatureDataset, batch_iterator
    from freqfusion_tpu_torch.parallel.mesh import run_ranks

    t_phase = time.perf_counter()
    times, counts_total = {}, {}

    def add(counts):
        for k, c in counts.items():
            counts_total[k] = counts_total.get(k, 0) + c

    # 1. entry()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry("cuda")
    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    counts = {k: c for k, c in read_launches().items() if c}
    add(counts)
    set_kernels(args[0], False)
    plain = fn(*args)
    set_kernels(args[0], True)
    times["entry_s"] = time.perf_counter() - t0
    want = {k: c for k, c in per_forward.items() if c}
    require_plain("parallel_entry", list(args[1].shape), {"out": (out, plain)})
    emit("parallel_entry", out=list(out.shape), launches=counts, seconds=times["entry_s"])
    require(tuple(out.shape) == (1, 256, 256, 3), f"entry output {tuple(out.shape)}")
    require(counts == want, f"entry launches {counts}, {want} expected")
    del fn, args, out, plain
    torch.cuda.empty_cache()

    # 2. the JAX twin's dryrun over nccl on every card (the ranks' launches are their own)
    n_cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    reset_launches()
    lines = graft_entry.dryrun_multichip(n_cards, backend="nccl", device="cuda",
                                         timeout_s=400)
    add({k: c for k, c in read_launches().items() if c})
    times["dryrun_s"] = time.perf_counter() - t0
    emit("parallel_dryrun", n=n_cards, backend="nccl", lines=lines, seconds=times["dryrun_s"])
    require(len(lines) == 4 and all(" OK" in line for line in lines), f"dryrun {lines}")

    # 3. two gloo ranks sharing the card against one process
    ds = CachedFeatureDataset(os.path.join(OUT, "train", "cache_train"), augment=False)
    batch14 = next(batch_iterator(ds, 14, shuffle=False))
    batch2 = {k: batch14[k][:2] for k in ("lr", "hr")}
    head = FusionHead()
    randomize_head_(head, torch.Generator().manual_seed(SEED + 1))
    head_state = {k: (v.double() if v.is_floating_point() else v)
                  for k, v in head.state_dict().items()}
    with open(os.path.join(ROOT, "configs", "train_config.yaml")) as f:
        weights = yaml.safe_load(f)["loss"]["stages"][2]["weights"]   # every loss
    model_dir = os.path.join(OUT, "model_dir")
    t0 = time.perf_counter()
    ranks_out = run_ranks(parallel_steps, PARALLEL_RANKS, PARALLEL_RANKS, head_state,
                          batch14, model_dir, batch2, weights, timeout_s=600)
    times["gloo_ranks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = parallel_steps(0, 1, head_state, batch14, model_dir, batch2, weights)
    times["one_process_s"] = time.perf_counter() - t0
    for r in ranks_out:
        add(r["live"]["launches"])
    for tag in ("cached", "live"):
        emit(f"parallel_{tag}", ranks=PARALLEL_RANKS, global_batch=14 if tag == "cached" else 2,
             dtype="float64" if tag == "cached" else "float32",
             step_s_by_rank=[r[tag]["seconds"] for r in ranks_out],
             step_s_one_process=one[tag]["seconds"],
             peak_gib_by_rank=[r[tag]["peak_gib"] for r in ranks_out],
             peak_gib_one_process=one[tag]["peak_gib"],
             launches_by_rank=[r[tag]["launches"] for r in ranks_out],
             loss=one[tag]["metrics"]["total"], grad_norm=one[tag]["metrics"]["grad_norm"],
             experts_batch_rel_diff=one[tag].get("experts_batch_rel_diff"))
        # float64: the CPU tests' 1e-5; float32: 1e-4, since the experts' kernels and cuDNN
        # reduce in another order at batch 1 than at 2 (`experts_batch_rel_diff`)
        hold_ranks(tag, one[tag], [r[tag] for r in ranks_out], 1e-5 if tag == "cached" else 1e-4,
                   leaf_max=tag == "cached")
    expert_forward = {k: c for k, c in per_forward.items() if c and k not in HEAD_KERNELS}
    require(all(r["live"]["launches"] == expert_forward for r in ranks_out),
            f"live step launches {[r['live']['launches'] for r in ranks_out]}")
    require(one["cached"]["launches"] == {} and all(r["cached"]["launches"] == {}
                                                    for r in ranks_out),
            "a cached train step launched a kernel")

    # 4. the bucket histogram of the served request shapes
    t0 = time.perf_counter()
    hist = {name: bucket_histogram.main(["--shapes", ",".join(f"{w}x{h}" for w, h in reqs)])
            for name, reqs in (("ens", REQUESTS), ("tiled", TILED_REQUESTS))}
    times["histogram_s"] = time.perf_counter() - t0
    emit("parallel_histogram", **hist)
    require(hist["ens"]["whole_image"] == len(REQUESTS) and hist["ens"]["tiled"] == 0,
            f"ens plan {hist['ens']}")
    require(hist["tiled"]["whole_image"] == 1 and hist["tiled"]["tiled"] == 2,
            f"tiled plan {hist['tiled']}")
    times["phase_s"] = time.perf_counter() - t_phase
    emit("parallel", **times, nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return counts_total


def multires_head_repair() -> None:
    """C16: the head at FusionConfig(enable_hierarchical=False), whose phase 5 is the flat
    multi-resolution fusion, once at the shipped width (fusion_dim 64) on a 352x512 frame
    with its kernels and on the plain path: B11 and B12 one launch each, the output within
    SLICE_RTOL x max|plain|."""
    gen = torch.Generator().manual_seed(SEED)
    head = FusionHead(FusionConfig(enable_hierarchical=False))
    randomize_head_(head, gen)
    head = head.cuda().eval()
    h, w = 352, 512
    lr = torch.rand(1, h, w, 3, generator=gen)
    up = F.interpolate(lr.permute(0, 3, 1, 2), scale_factor=4, mode="bicubic",
                       align_corners=False).permute(0, 2, 3, 1)
    outs = {n: (up + 0.05 * torch.randn(up.shape, generator=gen)).clamp(0, 1).cuda()
            for n in EXPERT_ORDER}
    lr = lr.cuda()
    before = read_launches()
    with torch.no_grad():
        got = head(lr, outs)
        launched = {k: n - before[k] for k, n in read_launches().items() if n != before[k]}
        set_kernels(head, False)
        want = head(lr, outs)
        plain_ms = cuda_ms(lambda: head(lr, outs), iters=3)
        set_kernels(head, True)
        ms = cuda_ms(lambda: head(lr, outs), iters=3)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    emit("repair", kernel="fusion_head", case="multi_resolution", shape=[1, h, w, 3],
         max_abs_err=err, bound=SLICE_RTOL * scale, max_abs_plain=scale, launches=launched,
         ms=ms, plain_ms=plain_ms)
    require(launched == {"fused_band_mha": 1, "lka_gate": 1},
            f"multi-resolution head: launches {launched}")
    require(bool(torch.isfinite(got).all()) and err <= SLICE_RTOL * scale,
            f"multi-resolution head: error {err} against {SLICE_RTOL * scale}")
    del head, got, want, outs


EVAL_CROP = (384, 512)      # H x W of the crop every tower scores on the card and on the CPU
# a tower's score on the card within max(EVAL_TOWER_RTOL, EVAL_OWN_ERR_FACTOR x the CPU f32
# score's own distance) of a float64 score, relative: random weights make some scores
# ill-conditioned in f32 (DISTS near 0 is 1 - a sum near 1; MANIQA's channel attention over
# random ViT-B/8 features is near one-hot). The float64 reference runs on the card: IEEE
# float64 on any device, and the CPU would take it about 30 s longer
EVAL_RUNS = (("cuda", torch.float32), ("cpu", torch.float32), ("cuda", torch.float64))
EVAL_TOWER_RTOL = 1e-4
EVAL_OWN_ERR_FACTOR = 8
EVAL_LOSS_RTOL = 1e-4       # the same for a loss's value, and for its gradient of max|g|
EVAL_MANIQA_CHECK_CROPS = 4   # MANIQA's random crops in the card-against-CPU check (CLI: 20)
EVAL_MERGES = ("t h", "th e</w>", "a </w>", "o n", "i n", "e r", "h i", "hi gh</w>",
               "q u", "qu a", "qua l", "i t", "it y</w>", "p h", "ph o", "pho t", "phot o",
               "o o", "g oo", "goo d</w>", "b a", "ba d</w>", "i m", "im a", "ima g",
               "imag e</w>", "s h", "sh a", "sha r", "shar p</w>", "b l", "bl u", "blu r")


def write_eval_weights(directory: str, gen: torch.Generator) -> dict:
    """Seeded random checkpoints at the published widths, in the reference key layouts, and
    a small BPE merges file: {variable: path}, the variables that bring every tower and both
    perceptual losses live."""
    from freqfusion_tpu_torch.losses.clip import CLIPVisionTransformer
    from freqfusion_tpu_torch.losses.vgg import VGG19Features
    from freqfusion_tpu_torch.utils.clipiqa import CLIPTextTransformer, SimpleBPETokenizer
    from freqfusion_tpu_torch.utils.dists import DISTS
    from freqfusion_tpu_torch.utils.lpips import AlexLPIPS
    from freqfusion_tpu_torch.utils.maniqa import MANIQA
    from freqfusion_tpu_torch.utils.musiq import MUSIQTransformer

    os.makedirs(directory, exist_ok=True)
    paths = {"FREQFUSION_CLIP_BPE": os.path.join(directory, "bpe_merges.txt")}
    with open(paths["FREQFUSION_CLIP_BPE"], "w") as f:
        f.write("#version: chip_smoke\n" + "\n".join(EVAL_MERGES) + "\n")
    vocab = SimpleBPETokenizer(paths["FREQFUSION_CLIP_BPE"]).vocab_size
    lpips = AlexLPIPS()
    dists = DISTS()
    towers = {"FREQFUSION_LPIPS_WEIGHTS": lpips, "FREQFUSION_DISTS_WEIGHTS": dists,
              "FREQFUSION_MUSIQ_WEIGHTS": MUSIQTransformer(),
              "FREQFUSION_MANIQA_WEIGHTS": MANIQA(),
              "FREQFUSION_VGG19_WEIGHTS": VGG19Features()}
    vision, text = CLIPVisionTransformer(), CLIPTextTransformer(vocab_size=vocab)
    for m in list(towers.values()) + [vision, text]:
        randomize_transformer_(m, gen)
    with torch.no_grad():   # LPIPS heads and DISTS weights are non-negative in the originals
        for k in range(5):
            getattr(lpips, f"lin{k}").model[1].weight.abs_()
        dists.alpha.copy_(0.01 + 0.09 * torch.rand(dists.alpha.shape, generator=gen))
        dists.beta.copy_(0.01 + 0.09 * torch.rand(dists.beta.shape, generator=gen))
    for env, m in towers.items():
        paths[env] = os.path.join(directory, env.lower() + ".pth")
        torch.save(m.state_dict(), paths[env])
    clip_sd = {**{"visual." + k: v for k, v in vision.state_dict().items()},
               **text.state_dict(), "logit_scale": torch.tensor(float(np.log(100.0)))}
    for env in ("FREQFUSION_CLIPIQA_WEIGHTS", "FREQFUSION_CLIP_WEIGHTS"):
        paths[env] = os.path.join(directory, "clip_vit_b32.pth")
    torch.save(clip_sd, paths["FREQFUSION_CLIP_WEIGHTS"])
    return paths


def eval_slice(sr_dir: str) -> dict:
    """The eval path on the card at the towers' published widths, f32 with TF32 off:
      1. cli/eval.py (--device cuda, workers as the CLI's default) on the three PNGs in
         `sr_dir` against targets written from SEED (each output + N(0, 3/255) noise),
         every variable set: PSNR, SSIM, NIQE and the five tower columns finite, three rows
         and a MEAN row, a finite total_score; seconds by column and peak memory;
      2. each tower on a 384x512 crop of the first output on the card, on the CPU and in
         float64: the card's score within the larger of EVAL_TOWER_RTOL and
         EVAL_OWN_ERR_FACTOR x the CPU f32 score's own error, relative to the float64 one
         (MANIQA on EVAL_MANIQA_CHECK_CROPS of its seeded crops);
      3. the VGG19 and CLIP perceptual losses, each with its gradient with respect to the
         prediction, at the training batch [14,256,256,3] on the card, on the CPU and in
         float64 (oneDNN off: its f32 conv backward strays further than the bound):
         the card's value and gradient within the larger of EVAL_LOSS_RTOL (of the value,
         of max|g|) and EVAL_OWN_ERR_FACTOR x the CPU f32 error, against float64; CLIP's
         gradient is zero everywhere, as in the JAX package;
      4. two cached train steps of the head with CombinedLoss({vgg: 0.1, clip: 0.05}) on
         the card: both components computed, the loss and grad_norm finite (the second
         step timed apart from the first).
    The eval path launches no kernel. Returns the launch counts of steps 1 and 4."""
    import csv

    from freqfusion_tpu_torch.cli import eval as cli_eval
    from freqfusion_tpu_torch.losses import CombinedLoss
    from freqfusion_tpu_torch.losses.clip import CLIPPerceptualLoss
    from freqfusion_tpu_torch.losses.vgg import VGGPerceptualLoss
    from freqfusion_tpu_torch.training.steps import make_optimizer, make_train_step
    from freqfusion_tpu_torch.utils.clipiqa import NativeCLIPIQA
    from freqfusion_tpu_torch.utils.dists import NativeDISTS
    from freqfusion_tpu_torch.utils.lpips import NativeLPIPS
    from freqfusion_tpu_torch.utils.maniqa import NativeMANIQA
    from freqfusion_tpu_torch.utils.musiq import NativeMUSIQ

    t_phase = time.perf_counter()
    root = os.path.join(OUT, "eval")
    gt_dir, csv_dir = os.path.join(root, "gt"), os.path.join(root, "csv")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(csv_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(SEED)
    outputs = list_images(sr_dir)
    require(len(outputs) == 3, f"eval: {len(outputs)} served PNGs in {sr_dir}")
    for f in outputs:
        img = load_image(f)
        noise = (3 / 255) * torch.randn(img.shape, generator=gen).numpy()
        save_image(np.clip(img + noise, 0, 1).astype(np.float32),
                   os.path.join(gt_dir, os.path.basename(f)))
    os.environ.update(write_eval_weights(os.path.join(root, "weights"), gen))
    os.environ.pop("FREQFUSION_MANIQA_CROPS", None)
    write_s = time.perf_counter() - t_phase

    # 1. the CLI, the path a user runs
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = cli_eval.main(["--output", sr_dir, "--target", gt_dir, "--csv-dir", csv_dir,
                         "--device", "cuda"])
    cli_counts = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(res["stem"] + ".csv") as f:
        rows = list(csv.reader(f))
    means = res["means"]
    columns = ("psnr", "ssim", "niqe", "lpips", "dists", "clipiqa", "musiq", "maniqa",
               "total_score")
    emit("eval_cli", seconds=res["seconds"], means=means, rows=len(rows) - 2,
         header=rows[0], peak_gib=peak_gib, images=[os.path.basename(f) for f in outputs],
         size=list(load_image(outputs[0]).shape), write_s=write_s)
    require(rows[0] == ["image", "psnr", "ssim", "niqe", "clipiqa", "dists", "lpips", "maniqa",
                        "musiq"], f"eval: header {rows[0]}")
    require(len(rows) == 5 and rows[-1][0] == "MEAN", f"eval: {len(rows)} rows")
    require(all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:]), "eval: a NaN cell")
    require(all(np.isfinite(means[k]) for k in columns), f"eval: means {means}")

    # 2. each tower, card against CPU, on one crop
    crop = (load_image(outputs[0])[:EVAL_CROP[0], :EVAL_CROP[1]] * 255).round().astype(np.uint8)
    crop_t = (load_image(os.path.join(gt_dir, os.path.basename(outputs[0])))
              [:EVAL_CROP[0], :EVAL_CROP[1]] * 255).round().astype(np.uint8)
    worst = 0.0
    makers = {"lpips": NativeLPIPS, "dists": NativeDISTS, "clipiqa": NativeCLIPIQA,
              "musiq": NativeMUSIQ,
              "maniqa": lambda **kw: NativeMANIQA(num_crops=EVAL_MANIQA_CHECK_CROPS, **kw)}
    for name, make in makers.items():
        scores, times = {}, {}
        for dev, dt in EVAL_RUNS:
            tower = make(device=dev, dtype=dt)
            tower(crop, crop_t)
            t = time.perf_counter()
            scores[dev, dt] = tower(crop, crop_t)
            times[dev, dt] = time.perf_counter() - t
            del tower
        card, cpu, ref = scores.values()
        err_card, err_cpu = abs(card - ref) / abs(ref), abs(cpu - ref) / abs(ref)
        bound = max(EVAL_TOWER_RTOL, EVAL_OWN_ERR_FACTOR * err_cpu)
        worst = max(worst, err_card / bound)
        card_s, cpu_s, f64_s = times.values()
        emit("eval_tower_check", tower=name, crop=list(EVAL_CROP), card=card, cpu=cpu, f64=ref,
             rel_err_card_cpu=abs(card - cpu) / abs(cpu), rel_err_card=err_card,
             rel_err_cpu=err_cpu, bound=bound, card_s=card_s, cpu_s=cpu_s, f64_s=f64_s)
        require(np.isfinite(card) and err_card <= bound,
                f"eval: {name} card {card}, CPU {cpu}, float64 {ref}")
    torch.cuda.empty_cache()

    # 3. the perceptual losses with their gradients, card against CPU
    target = torch.rand(14, 256, 256, 3, generator=gen)
    pred = (target + 0.1 * torch.randn(target.shape, generator=gen)).clamp(-0.05, 1.05)
    for name, maker in (("vgg", VGGPerceptualLoss), ("clip", CLIPPerceptualLoss)):
        got = {}
        for dev, dt in EVAL_RUNS:
            loss = maker().to(dt)
            p = pred.to(dev, dt).requires_grad_(True)
            t = time.perf_counter()
            with torch.backends.mkldnn.flags(enabled=False):
                v = loss(p, target.to(dev, dt))
                g = (torch.autograd.grad(v, p)[0] if v.requires_grad
                     else torch.zeros_like(p))
            got[dev, dt] = (float(v.detach()), g.detach().double().cpu(),
                            time.perf_counter() - t)
            del loss, p, v, g
        (vc, gc, tc), (vh, gh, th), (v64, g64, t64) = got.values()
        err_card, err_cpu = abs(vc - v64) / abs(v64), abs(vh - v64) / abs(v64)
        bound = max(EVAL_LOSS_RTOL, EVAL_OWN_ERR_FACTOR * err_cpu)
        g_scale = g64.abs().max().item()
        g_err, g_err_cpu = (gc - g64).abs().max().item(), (gh - g64).abs().max().item()
        g_bound = max(EVAL_LOSS_RTOL * g_scale, EVAL_OWN_ERR_FACTOR * g_err_cpu)
        emit("eval_loss_check", loss=name, batch=list(pred.shape), card=vc, cpu=vh, f64=v64,
             rel_err_card_cpu=abs(vc - vh) / abs(vh), rel_err_card=err_card,
             rel_err_cpu=err_cpu, bound=bound, grad_max_abs_err_card=g_err,
             grad_max_abs_err_cpu=g_err_cpu, grad_max_abs_f64=g_scale, grad_bound=g_bound,
             card_s=tc, cpu_s=th, f64_s=t64)
        require(np.isfinite(vc) and err_card <= bound, f"eval: {name} loss {vc} vs {v64}")
        require(g_err <= g_bound if name == "vgg" else g_scale == g_err == 0,
                f"eval: {name} gradient error {g_err} against {g_bound}")
    torch.cuda.empty_cache()

    # 4. one cached step with both perceptual losses live
    head = FusionHead()
    randomize_head_(head, gen)
    head = head.cuda()
    lr = torch.rand(14, 64, 64, 3, generator=gen)
    hr = torch.rand(14, 256, 256, 3, generator=gen)
    up = F.interpolate(lr.permute(0, 3, 1, 2), scale_factor=4, mode="bicubic",
                       align_corners=False).permute(0, 2, 3, 1).clamp(0, 1)
    batch = {"lr": lr.cuda(), "hr": hr.cuda(),
             "expert_outputs": {n: (up + 0.02 * torch.randn(up.shape, generator=gen))
                                .clamp(0, 1).cuda() for n in EXPERT_ORDER}}
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # nothing may move to FFT
        criterion = CombinedLoss({"vgg": 0.1, "clip": 0.05})
    step = make_train_step(head, criterion, make_optimizer(head, lambda n: 1e-4, 1e-4, 1.0, 1))
    reset_launches()
    step_s = []
    for _ in range(2):   # the first moves the backbones to the card and warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    step_counts = read_launches()
    emit("eval_combined_step", metrics=m, first_step_s=step_s[0], step_s=step_s[1], batch=14,
         weights=criterion.weights)
    require("vgg" in m and "clip" in m, f"eval: components {sorted(m)}")
    require(all(np.isfinite(v) for v in m.values()), f"eval: step metrics {m}")
    counts = {k: cli_counts[k] + step_counts[k] for k in cli_counts}
    require(not any(counts.values()), f"eval: kernels launched {counts}")
    emit("eval_time", seconds=time.perf_counter() - t_phase, worst_tower_err_over_bound=worst)
    return counts


# ---------------------------------------------------------------------------
# The last model families at full width: TSD-SR refinement of a served image, the V2 head
# over the three experts, MambaIR served on its own. None of them runs a TPU kernel of its
# own; the first two go through the experts' kernels.
# ---------------------------------------------------------------------------

TSDSR_LR = (512, 336)      # W x H: HR 2048x1344, latent 256x168, a whole number of patches
TSDSR_ODD_HR = (2040, 1356)   # W x H: latent 255x169, which the DiT cannot refine
TSDSR_TEACHER = (512, 4)   # the teacher's crop side and steps
F64_CROP = 256             # side of the crop the DiT and the VAE are held to float64 on
MAMBAIR_CHECK_LR = (64, 96)   # H x W of the LR that MambaIR is held to float64 on


def cast(tree, device, dtype):
    """Every tensor of a nested dict / list / tuple on `device` in `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, dtype)
    if isinstance(tree, dict):
        return {k: cast(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast(v, device, dtype) for v in tree)
    return tree


def against_f64(module: torch.nn.Module, run, *inputs) -> dict:
    """`run(module, *inputs)` -> {name: tensor} on the card in f32 (`module` itself), on
    the CPU in f32 and on the card in float64 (copies). Returns {name: (card's max |Δ| to
    float64, bound, CPU's max |Δ| to float64, max |float64|)}; the bound is the larger of
    EVAL_TOWER_RTOL x max |float64| and EVAL_OWN_ERR_FACTOR x the CPU's error, as
    `eval_tower_check` holds a score."""
    outs = []
    for i, (dev, dt) in enumerate(EVAL_RUNS):
        m = module if i == 0 else copy.deepcopy(module).to(dev, dt)
        with torch.inference_mode():
            got = run(m, *cast(inputs, dev, dt))
            outs.append({k: v.double().cpu() for k, v in got.items()})
        del m, got
        torch.cuda.empty_cache()
    card, cpu, ref = outs
    res = {}
    for k, r in ref.items():
        scale = r.abs().max().item()
        err, err_cpu = (card[k] - r).abs().max().item(), (cpu[k] - r).abs().max().item()
        res[k] = (err, max(EVAL_TOWER_RTOL * scale, EVAL_OWN_ERR_FACTOR * err_cpu), err_cpu, scale)
        require(bool(torch.isfinite(card[k]).all()), f"{k}: non-finite on the card")
    return res


def report_f64(tag: str, res: dict, **kw) -> float:
    """Emits `tag` with each output's errors and bound, requires each within its bound, and
    returns the worst error over its bound."""
    emit(tag, **kw, **{f"{k}_max_abs_err": e for k, (e, _, _, _) in res.items()},
         **{f"{k}_bound": b for k, (_, b, _, _) in res.items()},
         **{f"{k}_cpu_max_abs_err": c for k, (_, _, c, _) in res.items()},
         **{f"{k}_max_abs_f64": s for k, (_, _, _, s) in res.items()})
    for k, (e, b, _, _) in res.items():
        require(e <= b, f"{tag}: {k} error {e} against float64 > {b}")
    return max(e / b for e, b, _, _ in res.values())


def timed_s(fn):
    """(result, host seconds) of fn(), the card synchronised before and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def write_tsdsr_weights(directory: str, gen: torch.Generator) -> dict:
    """Seeded random weights at the published widths, saved as the loaders read them: the
    SD 2.1 AutoencoderKL (128/256/512/512, 2 resnets, GroupNorm 32) in the diffusers key
    layout, and tsdsr_base (hidden 768, depth 12, 12 heads, patch 2) with its final layer
    and adaLN modulations non-zero. Returns {variable: path}."""
    from freqfusion_tpu_torch.models.tsdsr import tsdsr_base
    from freqfusion_tpu_torch.models.vae import AutoencoderKL

    os.makedirs(directory, exist_ok=True)
    paths = {}
    for env, model in (("FREQFUSION_SDVAE_WEIGHTS", AutoencoderKL()),
                       ("FREQFUSION_TSDSR_WEIGHTS", tsdsr_base())):
        randomize_transformer_(model, gen)
        paths[env] = os.path.join(directory, env.lower() + ".pth")
        torch.save(model.state_dict(), paths[env])
    return paths


def tsdsr_slice(per_forward: dict) -> dict:
    """Serving plus TSD-SR refinement at full width, f32 with TF32 off:
      1. infer.io.main on a 512x336 PNG with the ens phase's checkpoints writes 2048x1344;
      2. CompleteSRPipeline(), live from FREQFUSION_TSDSR_WEIGHTS and
         FREQFUSION_SDVAE_WEIGHTS (seeded random weights, `write_tsdsr_weights`), must be
         available: an identity here is a failure;
      3. the student (one step at t = 500) refines the whole served image (encode to a
         256x168 latent, the DiT over 10752 tokens, decode), twice, timed; the output
         finite, in [0, 1], and not the input;
      4. the teacher at TSDSR_TEACHER's steps on a 512x512 crop;
      5. a 2040x1356 image (latent 255x169) must raise ValueError;
      6. the VAE's mean, the DiT's output and the decoder's output on a 256x256 crop on the
         card against a float64 evaluation (`against_f64`).
    The main path (steps 1 to 5) launches exactly the ens phase's kernels of one image."""
    from freqfusion_tpu_torch.models.tsdsr import CompleteSRPipeline, TSDSRInference
    from freqfusion_tpu_torch.models.vae import SD_SCALE_FACTOR

    t_phase = time.perf_counter()
    root = os.path.join(OUT, "tsdsr")
    lr_dir, sr_dir = os.path.join(root, "lr"), os.path.join(root, "sr")
    write_requests(lr_dir, [TSDSR_LR])
    os.environ.update(write_tsdsr_weights(os.path.join(root, "weights"),
                                          torch.Generator().manual_seed(SEED)))
    write_s = time.perf_counter() - t_phase

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    served, serve_s = timed_s(lambda: serve_directory(os.path.join(OUT, "model_dir"), lr_dir,
                                                      sr_dir))
    serve_counts = {k: n for k, n in read_launches().items() if n}
    sr = torch.from_numpy(load_image(list_images(sr_dir)[0]))[None].cuda()
    require(served == 1 and tuple(sr.shape) == (1, 4 * TSDSR_LR[1], 4 * TSDSR_LR[0], 3),
            f"tsdsr: main served {served}, output {tuple(sr.shape)}")
    pipe, build_s = timed_s(CompleteSRPipeline)
    require(pipe.tsdsr.available, "tsdsr: CompleteSRPipeline is an identity")
    inf = pipe.tsdsr
    emit("tsdsr_setup", lr=list(TSDSR_LR), serve_s=serve_s, write_weights_s=write_s,
         build_s=build_s, vae_params=sum(p.numel() for p in inf.codec.model.parameters()),
         dit_params=sum(p.numel() for p in inf.dit.parameters()), serve_launches=serve_counts)

    torch.cuda.reset_peak_memory_stats()
    out, first_s = timed_s(lambda: pipe(sr))
    out, student_s = timed_s(lambda: pipe(sr))
    student_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    change = (out - sr).abs().max().item()
    require(out.shape == sr.shape and bool(torch.isfinite(out).all())
            and 0.0 <= out.min().item() and out.max().item() <= 1.0,
            f"tsdsr: student output {tuple(out.shape)}")
    require(change > 1e-3, f"tsdsr: the student changed the image by {change} only")
    with torch.inference_mode():   # the student's three stages, one at a time
        lat, encode_s = timed_s(lambda: inf.codec.encode(sr))
        pred, dit_s = timed_s(lambda: inf.dit(lat))
        _, decode_s = timed_s(lambda: inf.codec.decode(pred))
    del lat, pred
    side, steps = TSDSR_TEACHER
    teacher = TSDSRInference(dit=inf.dit, codec=inf.codec, mode="teacher", num_steps=steps)
    crop = sr[:, :side, :side]
    t_out, teacher_s = timed_s(lambda: teacher.refine(crop))
    require(t_out.shape == crop.shape and bool(torch.isfinite(t_out).all()),
            f"tsdsr: teacher output {tuple(t_out.shape)}")
    odd = F.interpolate(sr.permute(0, 3, 1, 2), size=TSDSR_ODD_HR[::-1], mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    try:
        pipe(odd)
        odd_error = None
    except ValueError as e:
        odd_error = str(e)
    require(odd_error is not None, "tsdsr: a 2040x1356 image was refined, not refused")
    counts = {k: n for k, n in read_launches().items() if n}
    require(counts == per_forward,
            f"tsdsr: launches {counts}, expected the ens path's per image {per_forward}")
    emit("tsdsr_refine", output=list(out.shape), latent=[sr.shape[1] // 8, sr.shape[2] // 8],
         student_first_s=first_s, student_s=student_s, student_peak_gib=student_peak,
         encode_s=encode_s, dit_s=dit_s, decode_s=decode_s,
         max_abs_change=change, teacher_crop=side, teacher_steps=steps, teacher_s=teacher_s,
         odd_hr=list(TSDSR_ODD_HR), odd_error=odd_error)
    del out, t_out, odd

    # 6. the VAE and the DiT on a crop against float64
    def run(mods, x):
        mean, _ = mods["vae"].encode(x * 2.0 - 1.0)
        pred = mods["dit"](mean * SD_SCALE_FACTOR)
        return {"vae_mean": mean, "dit": pred,
                "decoded": mods["vae"].decode(pred / SD_SCALE_FACTOR)}

    mods = torch.nn.ModuleDict({"vae": inf.codec.model, "dit": inf.dit})
    res = against_f64(mods, run, sr[:, :F64_CROP, :F64_CROP].contiguous())
    worst = report_f64("tsdsr_check", res, crop=[F64_CROP, F64_CROP])
    emit("tsdsr", ms=1e3 * student_s, peak_gib=student_peak, launches=counts,
         max_abs_err=max(e for e, _, _, _ in res.values()), worst_err_over_bound=worst,
         seconds=time.perf_counter() - t_phase)
    for env in ("FREQFUSION_SDVAE_WEIGHTS", "FREQFUSION_TSDSR_WEIGHTS"):
        os.environ.pop(env)
    return counts


def v2_slice(per_forward: dict) -> dict:
    """The V2 fusion head over the full ExpertEnsemble (the ens phase's checkpoints) at the
    512x352 bucket, f32 with TF32 off: the experts on their kernel path, then
    FusionHeadV2() (seeded random weights) on their outputs with and without their
    features. The main path launches the experts' kernels of one image and neither head
    kernel (the V2 head has none). Each head output on the card against a float64
    evaluation (`against_f64`)."""
    from freqfusion_tpu_torch.infer.io import load_expert_checkpoints
    from freqfusion_tpu_torch.models.fusion_v2 import FusionHeadV2

    t_phase = time.perf_counter()
    holder = FreqFusionSR()
    load_expert_checkpoints(holder, os.path.join(OUT, "model_dir"))
    experts = holder.experts.cuda().eval()
    head = FusionHeadV2()
    randomize_head_(head, torch.Generator().manual_seed(SEED))
    head = head.cuda().eval()
    lr = load_image(list_images(os.path.join(OUT, "requests"))[0])
    x = torch.from_numpy(InferencePipeline._pad([lr], 352, 512)).cuda()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        (outputs, feats), experts_s = timed_s(lambda: experts(x))
        with_f, head_s = timed_s(lambda: head(x, outputs, feats))
        without_f = head(x, outputs)
    torch.cuda.synchronize()
    counts = {k: n for k, n in read_launches().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: n for k, n in per_forward.items() if k not in HEAD_KERNELS}
    require(counts == expected, f"v2_head: launches {counts}, expected {expected}")
    for o in (with_f, without_f):
        require(o.shape == (1, 1408, 2048, 3) and bool(torch.isfinite(o).all()),
                f"v2_head: output {tuple(o.shape)}")
    with torch.inference_mode():
        ms = {"with_features": cuda_ms(lambda: head(x, outputs, feats), iters=3),
              "without_features": cuda_ms(lambda: head(x, outputs), iters=3)}
    emit("v2_head_setup", head_params=sum(p.numel() for p in head.parameters()),
         bucket=[352, 512], experts_s=experts_s, first_head_s=head_s, head_ms=ms,
         share_inside_0_1=((with_f > 0) & (with_f < 1)).float().mean().item())

    res = against_f64(head, lambda m, a, o, f: {"with_features": m(a, o, f),
                                                "without_features": m(a, o)},
                      x, outputs, feats)
    worst = report_f64("v2_head_check", res)
    emit("v2_head", ms=ms["with_features"], ms_without_features=ms["without_features"],
         peak_gib=peak, launches=counts, max_abs_err=max(e for e, _, _, _ in res.values()),
         worst_err_over_bound=worst, seconds=time.perf_counter() - t_phase)
    del holder, experts, head, outputs, feats
    return counts


def randomize_mambair_(model: torch.nn.Module, gen: torch.Generator) -> None:
    """`randomize_transformer_`, then each SS2D near its published initialisation, so that
    the scan keeps the decay rates MambaIR starts from: A_logs log(1..N) + N(0, 0.1), Ds
    N(1, 0.1), dt_projs_bias softplus^-1 of a step log-uniform in [0.001, 0.1],
    x_proj_weight and dt_projs_weight N(0, 1/fan_in); the skip scales N(1, 0.1)."""
    from freqfusion_tpu_torch.models.mambair import SS2D

    randomize_transformer_(model, gen)

    def r(shape, std, mean=0.0):
        return mean + std * torch.randn(shape, generator=gen)

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("skip_scale", "skip_scale2"):
                p.copy_(r(p.shape, 0.1, 1.0))
        for m in model.modules():
            if isinstance(m, SS2D):
                n = m.A_logs.shape[1]
                m.A_logs.copy_(torch.log(torch.arange(1.0, n + 1)) + r(m.A_logs.shape, 0.1))
                m.Ds.copy_(r(m.Ds.shape, 0.1, 1.0))
                dt = torch.exp(math.log(1e-3) + math.log(100.0)
                               * torch.rand(m.dt_projs_bias.shape, generator=gen))
                m.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
                m.x_proj_weight.copy_(r(m.x_proj_weight.shape, m.d_inner ** -0.5))
                m.dt_projs_weight.copy_(r(m.dt_projs_weight.shape, m.dt_rank ** -0.5))


def mambair_slice(gen_cpu: torch.Generator) -> dict:
    """MambaIR at its published size (embed 180, 6 x 6 VSSBlocks, d_state 16, expand 2;
    seeded random weights) serves the three requests through InferencePipeline's uint8
    protocol, image i+1 dispatched before image i is copied back; one forward at the
    512x352 bucket timed; a 64x96 LR on the card against a float64 evaluation
    (`against_f64`). MambaIR launches no kernel."""
    from freqfusion_tpu_torch.models.mambair import SS2D, MambaIR, selective_scan

    t_phase = time.perf_counter()
    model = MambaIR()
    randomize_mambair_(model, gen_cpu)
    pipe = InferencePipeline(model)
    files = list_images(os.path.join(OUT, "requests"))
    lrs = [load_image(f) for f in files]
    plans = [pipe._whole_image_plan(lr.shape[0], lr.shape[1]) for lr in lrs]

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, outs = None, []
    for lr, plan in zip(lrs, plans):
        handle = pipe.dispatch_batch_u8([lr], plan)
        if pending is not None:
            outs.append(pipe.materialize_u8(pending)[0])
        pending = handle
    outs.append(pipe.materialize_u8(pending)[0])
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for lr, arr in zip(lrs, outs):
        require(arr.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3) and arr.dtype == np.uint8,
                f"mambair: output {arr.shape} {arr.dtype}")
    inside = float(np.mean((outs[0] > 0) & (outs[0] < 255)))
    with torch.inference_mode():
        xb = torch.from_numpy(pipe._pad([lrs[0]], *plans[0])).cuda()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        model(xb)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        # one block's selective scan (4 directions at once) at the bucket's shape, on
        # random inputs in the ranges the model feeds it
        ss = next(m for m in model.modules() if isinstance(m, SS2D))
        gen = torch.Generator(xb.device).manual_seed(SEED)
        l, d, n = xb.shape[1] * xb.shape[2], ss.d_inner, ss.d_state

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=xb.device)

        scan_args = (rnd(4, 1, l, d), 0.001 + 0.1 * torch.rand((4, 1, l, d), generator=gen,
                                                               device=xb.device),
                     -torch.exp(ss.A_logs.reshape(4, 1, d, n)), rnd(4, 1, l, n), rnd(4, 1, l, n),
                     ss.Ds.reshape(4, 1, d))
        scan_ms = cuda_ms(lambda: selective_scan(*scan_args), iters=1)
        blocks = sum(isinstance(m, SS2D) for m in model.modules())
    del xb, scan_args
    torch.cuda.empty_cache()
    emit("mambair_serve", params=sum(p.numel() for p in model.parameters()),
         requests=[list(lr.shape) for lr in lrs], buckets=plans, images=len(outs),
         seconds=serve_s, forward_ms=ms, bucket=list(plans[0]), peak_gib=peak,
         share_inside_0_255=inside, scan_ms=scan_ms, scans=blocks,
         scan_share_of_forward=blocks * scan_ms / ms)

    h, w = MAMBAIR_CHECK_LR
    x = torch.rand(1, h, w, 3, generator=gen_cpu).cuda()
    res = against_f64(model, lambda m, v: dict(zip(("sr", "deep"), m(v))), x)
    worst = report_f64("mambair_check", res, lr=[h, w])
    counts = {k: n for k, n in read_launches().items() if n}
    require(not counts, f"mambair: kernels launched {counts}")
    emit("mambair", ms=ms, peak_gib=peak, launches=counts,
         max_abs_err=max(e for e, _, _, _ in res.values()), worst_err_over_bound=worst,
         seconds=time.perf_counter() - t_phase)
    return counts


# ---- bf16 serving (FREQFUSION_DTYPE=bfloat16): every kernel of the path in its bf16
# instantiation (bf16 in device memory, bf16 products accumulated in f32)
BF16 = torch.bfloat16
BF16_REL = 1e-2          # max |kernel - plain| <= BF16_REL * max|plain| (~2.5 bf16 ulps at max)
BF16_SUMS_RTOL = 1e-3    # B1's, B5a's and B7's f32 channel sums, relative to sum|.|
BF16_F64_FACTOR = 2.0    # the kernel's max distance from float64 <= 2x the plain bf16 version's
BF16_FORWARD_FACTOR = 1.5   # the whole forward's RMS distance from f32: kernel <= 1.5x plain
PEAK_BF16_TC = 989e12    # dense bf16 tensor cores; one TF32 pass, as these kernels run, caps
                         # the products at 495e12


def bf16_bound(cuda_flops: float, tc_flops: float, nelems: float) -> tuple:
    """(least milliseconds, what sets it) of a bf16 kernel: the larger of its elements at 2
    bytes over the memory rate, and its products over the bf16 tensor-core peak or its other
    operations over the CUDA cores' f32 peak."""
    t_ops = max(cuda_flops / PEAK_FLOPS, tc_flops / PEAK_BF16_TC)
    t_bytes = 2 * nelems / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def as_dtype(t, dtype):
    return t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point() else t


def bf16_case(res16: dict, key: str, case: str, kernel, plain, args: tuple, bnd: tuple,
              kw: dict = None, summary: bool = True, iters: int = 5, shape=None,
              phase: str = "kernel_bf16") -> None:
    """`key`'s kernel and its plain version on the bf16 copies of `args` (f32 tensors, and
    other arguments as they are), and the plain version on float64 copies of the same bf16
    values: the kernel within BF16_REL * max|plain| of the plain bf16 version, and its
    largest distance from float64 at most BF16_F64_FACTOR times the plain version's. A
    tuple result's second element are f32 channel sums, within BF16_SUMS_RTOL."""
    kw = kw or {}
    a16 = tuple(as_dtype(t, BF16) for t in args)
    k16 = {k: as_dtype(v, BF16) for k, v in kw.items()}
    with torch.inference_mode():
        got, want = kernel(*a16, **k16), plain(*a16, **k16)
        ref = plain(*(as_dtype(t, torch.float64) for t in a16),
                    **{k: as_dtype(v, torch.float64) for k, v in k16.items()})
        torch.cuda.synchronize()
        g, w, r = (o[0] if isinstance(o, tuple) else o for o in (got, want, ref))
        require(g.dtype == BF16 and w.dtype == BF16, f"{key} at bf16 gave {g.dtype}, {w.dtype}")
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        dist, plain_dist = ((t.double() - r).abs().max().item() for t in (g, w))
        finite = bool(torch.isfinite(g).all())
        sums = {}
        if isinstance(got, tuple):
            sums["sums_max_rel_err"] = ((got[1] - want[1]).abs().reshape(want[1].shape[0], -1)
                                        / w.float().abs().sum((1, 2)).reshape(
                                            w.shape[0], -1)).max().item()
        del got, want, ref, g, w, r
        ms = cuda_ms(lambda: kernel(*a16, **k16), iters=iters)
        plain_ms = cuda_ms(lambda: plain(*a16, **k16), iters=iters)
    emit(phase, kernel=key, case=case, shape=shape or list(args[0].shape),
         max_abs_err=err, bound=BF16_REL * scale, max_abs_plain=scale, f64_max_abs=dist,
         plain_f64_max_abs=plain_dist, f64_factor=BF16_F64_FACTOR, ms=ms, plain_ms=plain_ms,
         bound_ms=bnd[0], bound_by=bnd[1], **sums)
    require(finite, f"{key} at bf16: non-finite output at {case}")
    require(err <= BF16_REL * scale, f"{key} at bf16: error {err} > {BF16_REL} x {scale} at {case}")
    require(dist <= BF16_F64_FACTOR * plain_dist,
            f"{key} at bf16: {dist} from float64, the plain version {plain_dist}, at {case}")
    if sums:
        require(sums["sums_max_rel_err"] <= BF16_SUMS_RTOL,
                f"{key} at bf16: sums error {sums['sums_max_rel_err']} at {case}")
    r16 = res16.setdefault(key, {"err": 0.0, "rel": 0.0, "times": []})
    r16["err"], r16["rel"] = max(r16["err"], err), max(r16["rel"], err / scale)
    if summary:
        r16["times"].append((ms, plain_ms, bnd))


# ---- precision "default" (FREQFUSION_PRECISION=default): f32 in device memory, every
# kernel's matmul operands rounded to bf16 where the TPU kernel casts them, f32 accumulation
DEFAULT_REL = 1e-2          # max |kernel - plain default| <= DEFAULT_REL * max|plain default|
DEFAULT_SUMS_RTOL = 1e-3    # f32 channel sums, relative to sum|.|
DEFAULT_F64_FACTOR = 2.0    # max distance from float64 <= 2x the plain default version's
DEFAULT_ROUNDING = 0.25     # RMS |kernel - plain default| <= 0.25 x RMS |plain default -
                            # plain f32|: a kernel that skipped the rounding fails it (the
                            # kernel at f32 operands, which skips every rounding, must fail it)
DEFAULT_FORWARD_FACTOR = 1.5   # the fused image's RMS from f32: kernel <= 1.5x plain default
NO_OPERANDS = ("aim_conv_branch",)   # B5a: no product, its f32 instantiation at default


def default_bound(cuda_flops: float, tc_flops: float, nelems: float) -> tuple:
    """(least milliseconds, what sets it) of a kernel at precision "default": the larger of
    its elements at 4 bytes (f32 storage) over the memory rate, and its products over the
    bf16 tensor-core peak or its other operations over the CUDA cores' f32 peak."""
    t_ops = max(cuda_flops / PEAK_FLOPS, tc_flops / PEAK_BF16_TC)
    t_bytes = 4 * nelems / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def unrounded_probs(module, fn):
    """fn() with `module`'s plain versions leaving the normalised probabilities unrounded
    (``module._probs`` at f32: one rounding point of the TPU kernels, ``softmax(.).astype(dt)``
    or the band attention's p): the partial-skip control of an attention's rounding check."""
    real = module._probs
    module._probs = lambda scores, mdt: real(scores, torch.float32)
    try:
        return fn()
    finally:
        module._probs = real


def rounding_readings(key: str, case: str, got, want, want32, controls: dict,
                      alt=None) -> tuple:
    """The rounding check of a default kernel's output `got` against its plain default version
    `want`, whose RMS distance from the plain f32 version `want32` is the gap: (RMS |got -
    want| / gap, {label: RMS |control - want| / gap}, RMS |alt - want| / gap or None), and
    requires the first at most DEFAULT_ROUNDING and every control above it (a control is
    what a kernel that skipped some rounding gives: the kernel at f32 operands, or the plain
    default version with one rounding point left out). `alt` is the plain default version
    with float64 sums and the same roundings: another correct implementation, whose distance
    is the spread that the bound has to leave room for."""
    gap = rms(want, want32)
    ratio = rms(got, want) / gap
    ctl = {label: rms(c, want) / gap for label, c in controls.items()}
    alt_ratio = None if alt is None else rms(alt, want) / gap
    require(ratio <= DEFAULT_ROUNDING,
            f"{key} at default: RMS {ratio} x the rounding gap {gap} from plain default at "
            f"{case}: did the kernel round its operands?")
    for label, c in ctl.items():
        require(c > DEFAULT_ROUNDING,
                f"{key} at {case}: the control '{label}' sits {c} x the rounding gap from "
                f"plain default, within the rounding check's {DEFAULT_ROUNDING}")
    return ratio, ctl, alt_ratio


def default_case(res: dict, key: str, case: str, kernel, plain, args: tuple, bnd: tuple,
                 kw: dict = None, summary: bool = True, iters: int = 5, shape=None,
                 probs=None) -> None:
    """`key`'s kernel and its plain version at precision "default" (the process-wide bf16
    operands that ``pinned_precision("default")`` sets) on the same f32 `args`, the plain
    version at f32 operands, and on float64 copies (unrounded): the kernel within
    DEFAULT_REL * max|plain default|, at most DEFAULT_F64_FACTOR times the plain default
    version's distance from float64, and the rounding check (``rounding_readings``): its RMS
    distance from the plain default version at most DEFAULT_ROUNDING times the plain default
    version's RMS distance from the plain f32 one, with the kernel at f32 operands as a
    control and, for an attention (`probs`: the module whose ``_probs`` its plain version
    takes), the plain default version with the probabilities left unrounded as another; the
    plain default version on float64 copies (``mxu_dtype`` bf16: the same roundings, other
    sums) is reported beside it. The check takes RMS distances, not maxima: two correct
    implementations of one rounding point disagree where f32 sums in another order put a
    value on the other side of a bf16 rounding boundary, one bf16 ulp of an operand at a few
    elements in 1e4, and over the millions of outputs of a served shape the largest such
    disagreement reaches 0.1 to 0.6 of the largest rounding distance (its max ratio is
    reported). A tuple result's second element are f32 channel sums, within
    DEFAULT_SUMS_RTOL. NO_OPERANDS kernels (B5a) run their f32 instantiation: equal to the
    kernel at f32 operands, bit for bit, and within KERNEL_ATOL of plain."""
    kw = kw or {}
    f32_only = key in NO_OPERANDS

    def at_default(fn):
        with _mma.operands(BF16):
            return fn(*args, **kw)

    def first(o):
        return o[0] if isinstance(o, tuple) else o

    with torch.inference_mode():
        got, want = at_default(kernel), at_default(plain)
        got32, want32 = kernel(*args, **kw), plain(*args, **kw)
        args64 = [as_dtype(t, torch.float64) for t in args]
        kw64 = {k: as_dtype(v, torch.float64) for k, v in kw.items()}
        ref = plain(*args64, **kw64)
        alt = None if f32_only else first(plain(*args64, **kw64, mxu_dtype=BF16))
        controls = {} if probs is None else {
            "p unrounded": first(unrounded_probs(probs, lambda: at_default(plain)))}
        torch.cuda.synchronize()
        g, w, g32, w32, r = (first(o) for o in (got, want, got32, want32, ref))
        require(g.dtype == torch.float32 and w.dtype == torch.float32,
                f"{key} at default gave {g.dtype}, {w.dtype}")
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        gap = (w - w32).abs().max().item()
        dist, plain_dist = ((t.double() - r).abs().max().item() for t in (g, w))
        same_as_f32 = bool(torch.equal(g, g32))
        finite = bool(torch.isfinite(g).all())
        sums = {}
        if isinstance(got, tuple):
            sums["sums_max_rel_err"] = ((got[1] - want[1]).abs().reshape(w.shape[0], -1)
                                        / w.abs().sum((1, 2)).reshape(w.shape[0], -1)
                                        ).max().item()
        readings = {}
        if not f32_only:
            ratio, ctl, alt_ratio = rounding_readings(key, case, g, w, w32,
                                                      {"f32 kernel": g32, **controls}, alt)
            readings = dict(rms_ratio=ratio, control_rms_ratios=ctl,
                            f64_sums_rms_ratio=alt_ratio)
        del got, want, got32, want32, ref, g, w, g32, w32, r, alt, controls
        ms = cuda_ms(lambda: at_default(kernel), iters=iters)
        plain_ms = cuda_ms(lambda: at_default(plain), iters=iters)
    emit("kernel_default", kernel=key, case=case, shape=shape or list(args[0].shape),
         instantiation="f32 (no operand)" if f32_only else "<float, 1 pass>",
         max_abs_err=err, bound=KERNEL_ATOL if f32_only else DEFAULT_REL * scale,
         max_abs_plain=scale, f64_max_abs=dist, plain_f64_max_abs=plain_dist,
         f64_factor=DEFAULT_F64_FACTOR, rounding_gap=gap,
         max_ratio=err / gap if gap else None, **readings,
         rounding_bound=DEFAULT_ROUNDING, ms=ms, plain_ms=plain_ms,
         bound_ms=bnd[0], bound_by=bnd[1], **sums)
    require(finite, f"{key} at default: non-finite output at {case}")
    if f32_only:
        require(same_as_f32 and gap == 0, f"{key} at default is not its f32 path at {case}")
        require(err <= KERNEL_ATOL, f"{key} at default: error {err} at {case}")
    else:
        require(err <= DEFAULT_REL * scale,
                f"{key} at default: error {err} > {DEFAULT_REL} x {scale} at {case}")
        require(dist <= DEFAULT_F64_FACTOR * plain_dist,
                f"{key} at default: {dist} from float64, the plain version {plain_dist}, "
                f"at {case}")
    if sums:
        require(sums["sums_max_rel_err"] <= DEFAULT_SUMS_RTOL,
                f"{key} at default: sums error {sums['sums_max_rel_err']} at {case}")
    rd = res.setdefault(key, {"err": 0.0, "rel": 0.0, "gap": 0.0, "rms_ratio": 0.0,
                              "times": []})
    rd["err"], rd["rel"] = max(rd["err"], err), max(rd["rel"], err / scale)
    rd["gap"] = max(rd["gap"], gap)
    rd["rms_ratio"] = max(rd["rms_ratio"], readings.get("rms_ratio", 0.0))
    if summary:
        rd["times"].append((ms, plain_ms, bnd))


def hab_halves_default(case: str, h_args: tuple, mask, window: int, heads: int, gate,
                       in_shift: int) -> None:
    """B8's two launches at precision "default", each held by the rounding check to its plain
    half on the same inputs: the attention (``wattn._hab_attention_plain``; controls: the f32
    instantiation's attention, the plain default half with p unrounded) and the tail on the
    kernel's heads' output (``wattn._hab_tail_plain``; control: the f32 tail on that output).
    The whole block re-rounds the attention's small disagreements downstream (the heads'
    output as the projection's operand, LN2's and GELU's outputs), so that its ratio sits near
    that of two correct implementations; a half shows a skipped rounding point plainly."""
    x, cx, l1w, l1b, l2w, l2b, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, bias = h_args
    a_args = (x, l1w, l1b, wqkv, bqkv, bias, mask, (window, window), heads, in_shift)
    t_args = (x, cx, l2w, l2b, wproj, bproj, w1, b1, w2, b2, 0.01, gate, in_shift)

    def launchers():
        return wattn._hab_block_launchers(*h_args, mask, (window, window), heads, 0.01, gate,
                                          in_shift)

    with torch.inference_mode():
        with _mma.operands(BF16):
            attention, tail, att, out = launchers()
            attention()
            tail()
            a_d = wattn._hab_attention_plain(*a_args)
            a_p = unrounded_probs(wattn, lambda: wattn._hab_attention_plain(*a_args))
            t_d = wattn._hab_tail_plain(att, *t_args)
        attention32, tail32, att32, out32 = launchers()
        attention32()
        a_f = wattn._hab_attention_plain(*a_args)
        a64 = [as_dtype(t, torch.float64) for t in a_args]
        a_alt = wattn._hab_attention_plain(*a64, mxu_dtype=BF16)
        attn = rounding_readings("fused_hab_block attention", case, att, a_d, a_f,
                                 {"f32 kernel": att32.clone(), "p unrounded": a_p}, a_alt)
        del a_p, a_f, a_alt, a64
        att32.copy_(att)   # the f32 tail on the default attention's output
        tail32()
        t_f = wattn._hab_tail_plain(att, *t_args)
        t_alt = wattn._hab_tail_plain(att.double(),
                                      *[as_dtype(t, torch.float64) for t in t_args],
                                      mxu_dtype=BF16)
        tl = rounding_readings("fused_hab_block tail", case, out, t_d, t_f,
                               {"f32 kernel": out32}, t_alt)
        torch.cuda.synchronize()
    for half, (ratio, ctl, alt) in (("attention", attn), ("tail", tl)):
        emit("kernel_default_half", kernel="fused_hab_block", half=half, case=case,
             rms_ratio=ratio, control_rms_ratios=ctl, f64_sums_rms_ratio=alt,
             rounding_bound=DEFAULT_ROUNDING)


def mode_kernel_cases(gen: torch.Generator, mode: str) -> dict:
    """Every kernel of the path at bf16 (`mode` "bf16": `bf16_case`) or at precision
    "default" (`default_case`), at the shapes of the f32 lines' summaries (the 512x352
    bucket's; NAF's heaviest level; B3 also at NAF's intro and ending convs, its CUDA-core
    kernel). Returns {kernel: {err, rel (err over max|plain|), ms, plain_ms, bound}}."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    check, bound = ((bf16_case, bf16_bound) if mode == "bf16"
                    else (default_case, default_bound))
    # the inputs a case builds from another kernel's plain output: in the mode's storage
    # type and operands
    stored = (lambda t: as_dtype(t, BF16)) if mode == "bf16" else (lambda t: t)
    mdt = BF16 if mode == "default" else None
    # an attention's partial-skip control (default_case: probs), at default only
    probs = (lambda m: {"probs": m}) if mode == "default" else (lambda m: {})

    res16 = {}
    # B1, B2: NAF's first HR level
    _, b, h, w, c = BLOCK_CASES[0]
    npix = b * h * w
    x, p = r(b, h, w, c), block_params(c, gen)
    a_args = (x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"], p["wdw"], p["bdw"])
    check(res16, "naf_block_stage_a", "enc0_hr", nafblock.naf_block_stage_a,
              nafblock.naf_block_stage_a_plain, a_args,
              bound(npix * 45 * c, npix * 4 * c * c, 2 * npix * c + 2 * c * c + 24 * c),
              iters=3)
    with torch.inference_mode():
        g16, sums16 = nafblock.naf_block_stage_a_plain(*map(stored, a_args), mxu_dtype=mdt)
        att = nafblock._att(sums16, h * w, stored(p["sca_w"]), stored(p["sca_b"]))
    b_args = (g16, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"], p["ln2_b"], p["w4"],
              p["b4"], p["w5"], p["b5"], p["gamma"])
    check(res16, "naf_block_stage_b", "enc0_hr", nafblock.naf_block_stage_b,
              nafblock.naf_block_stage_b_plain, b_args,
              bound(npix * 16 * c, npix * 8 * c * c, 3 * npix * c + 4 * c * c + 9 * c),
              iters=3)
    del x, g16, a_args, b_args
    # B3: DAT's 180 -> 180 conv (the summary) and NAF's two CUDA-core convs
    for name, b, h, w, cin, cout in CONV_CASES[:3]:
        args = (r(b, h, w, cin), r(3, 3, cin, cout, std=(9 * cin) ** -0.5), r(cout, std=0.1))
        prod = b * h * w * 18 * cin * cout
        wide = min(cin, cout) >= 32
        check(res16, "conv3x3_dense", name, conv3x3.conv3x3_dense,
                  conv3x3.conv3x3_dense_plain, args,
                  bound(0.0 if wide else prod, prod if wide else 0.0,
                             b * h * w * (cin + cout) + 9 * cin * cout + cout),
                  summary=name == "dat_180", iters=3)
        del args
    # DAT: B4 (both window orientations' first, unshifted and shifted), B5a, B5b, B6
    c, heads, hid = DAT_C, DAT_HEADS, DAT_HIDDEN
    half, mid, co = hid // 2, c // 16, c // 2
    hd = co // heads
    for name, b, h, w, hs, ws, shifted in WATTN_CASES[:2]:
        n, npix, nwin = hs * ws, b * h * w, b * (h // hs) * (w // ws)
        mask = (torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()
                if shifted else None)
        args = (r(b, h, w, c), r(c, 3 * co, std=c ** -0.5), r(3 * co, std=0.1),
                r(heads, n, n, std=0.5), mask, (hs, ws), heads)
        check(res16, "fused_window_attention_xqkv", name, wattn.fused_window_attention_xqkv,
                  wattn.fused_window_attention_xqkv_plain, args,
                  bound(nwin * heads * n * n * 8,
                             npix * 2 * c * 3 * co + nwin * heads * n * n * 4 * hd,
                             npix * (c + co) + c * 3 * co + 3 * co
                             + (heads + (4 if shifted else 0)) * n * n),
                  **probs(wattn))
        del args
    _, b, h, w = DAT_CASES[0]
    npix = b * h * w
    v = r(b, h, w, c)
    a_args = (v, r(3, 3, 1, c, std=1 / 3), r(c, std=0.1), r(c, std=0.2, mean=1.0),
              r(c, std=0.1))
    check(res16, "aim_conv_branch", "bucket", aim.aim_conv_branch,
              aim.aim_conv_branch_plain, a_args,
              bound(npix * c * 30, 0.0, 2 * npix * c + 12 * c + b * c))
    with torch.inference_mode():
        cx16, sums16 = aim.aim_conv_branch_plain(*map(stored, a_args))
    b_args = (r(b, h, w, c), cx16, sums16 / (h * w), r(1, 1, c, mid, std=c ** -0.5),
              r(mid, std=0.1), r(mid, std=0.2, mean=1.0), r(mid, std=0.1),
              r(1, 1, mid, 1, std=mid ** -0.5), r(1, std=0.1), r(c, c, std=c ** -0.5),
              r(c, std=0.1))
    for swap in (False, True):
        check(res16, "aim_gates_proj", f"bucket_swap{int(swap)}", aim.aim_gates_proj,
                  aim.aim_gates_proj_plain, b_args,
                  bound(npix * (2 * c * mid + 2 * mid + 8 * c), npix * 2 * c * c,
                             3 * npix * c + b * c + c * mid + c * c + 3 * mid + c + 2),
                  kw=dict(swap=swap))
    del v, a_args, b_args, cx16
    t_args = (r(b, h, w, c), r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
              r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(half, std=0.1, mean=1.0),
              r(half, std=0.1), r(3, 3, 1, half, std=1 / 3), r(half, std=0.1),
              r(half, c, std=half ** -0.5), r(c, std=0.1))
    check(res16, "fused_sgfn_tail", "bucket", sgfn.fused_sgfn_tail,
              sgfn.fused_sgfn_tail_plain, t_args,
              bound(npix * (8 * c + 10 * hid + 28 * half),
                         npix * (2 * c * hid + 2 * half * c),
                         3 * npix * c + c * hid + half * c + hid + 13 * half + 3 * c))
    del t_args
    # HAT-L: B7 (unshifted and shifted), B10, B8 (unshifted and in_shift), B9
    c, heads, ws, ov, mid, hid = HAT_C, HAT_HEADS, HAT_WINDOW, HAT_OVERLAP, HAT_MID, HAT_HIDDEN
    n, nk, hd, s = ws * ws, (ws + ov) ** 2, HAT_C // HAT_HEADS, HAT_WINDOW // 2
    _, b, h, w = HAT_CASES[0]
    npix, nwin = b * h * w, b * (h // ws) * (w // ws)
    c_args = (r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
              r(3, 3, c, mid, std=(9 * c) ** -0.5), r(mid, std=0.1),
              r(3, 3, mid, c, std=(9 * mid) ** -0.5), r(c, std=0.1))
    for shift in (0, s):
        check(res16, "cab_chain", f"bucket_shift{shift}", cab.cab_chain, cab.cab_chain_plain,
                  c_args, bound(npix * (10 * c + 10 * mid), npix * 36 * c * mid,
                                     2 * npix * c + 18 * c * mid + 3 * c + mid + b * c),
                  kw=dict(out_shift=shift))
    del c_args
    m_args = (r(b, h, w, c), r(b, h, w, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
              r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid, c, std=hid ** -0.5),
              r(c, std=0.1))
    check(res16, "fused_residual_ln_mlp", "bucket", wattn.fused_residual_ln_mlp,
              wattn.fused_residual_ln_mlp_plain, m_args,
              bound(npix * (12 * c + 10 * hid), npix * 4 * c * hid,
                         3 * npix * c + 2 * c * hid + hid + 3 * c))
    del m_args
    h_args = (r(b, h, w, c), r(b, h, w, c, std=3.0), r(c, std=0.1, mean=1.0),
              r(c, std=0.1), r(c, std=0.1, mean=1.0), r(c, std=0.1),
              r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1), r(c, c, std=c ** -0.5),
              r(c, std=0.1), r(c, hid, std=c ** -0.5), r(hid, std=0.1),
              r(hid, c, std=hid ** -0.5), r(c, std=0.1), r(heads, n, n, std=0.5))
    gate = r(b, 1, 1, c, std=0.2, mean=0.5)
    types = torch.from_numpy(windows.shift_mask_types(ws, ws, s, s).copy()).cuda()
    for case, mask, in_shift in (("bucket_unshifted", None, 0), ("bucket_in_shift", types, s)):
        check(res16, "fused_hab_block", case, wattn.fused_hab_block,
                  wattn.fused_hab_block_plain, h_args + (mask, (ws, ws), heads, 0.01),
                  bound(npix * (24 * c + 10 * hid) + nwin * heads * n * n * 8,
                             npix * (8 * c * c + 4 * c * hid) + nwin * heads * n * n * 4 * hd,
                             3 * npix * c + 4 * c * c + 2 * c * hid + 8 * c + hid + b * c
                             + (heads + (4 if in_shift else 0)) * n * n),
                  kw=dict(cab_scale=gate, in_shift=in_shift),
                  **probs(wattn))
        if mode == "default":
            hab_halves_default(case, h_args, mask, ws, heads, gate, in_shift)
    del h_args
    o_args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c), r(c, c, std=c ** -0.5),
              r(c, std=0.1), r(heads, n, nk, std=0.5), ws, ov, heads)
    check(res16, "fused_overlap_attention", "bucket", wattn.fused_overlap_attention,
              wattn.fused_overlap_attention_plain, o_args,
              bound(nwin * heads * n * nk * 8,
                         nwin * heads * n * nk * 4 * hd + npix * 2 * c * c,
                         4 * npix * c + c * c + c + heads * n * nk),
                  **probs(wattn))
    del o_args
    # the head: B11 on the 9 band tokens of 64, B12 on the 9 bands folded into the batch
    _, b, h, w, t, d, heads = MHA_CASES[0]
    hd, npix = d // heads, b * h * w
    args = (r(b, h, w, t, d, std=0.6), r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.1),
            r(d, d, std=d ** -0.5), r(d, std=0.1), r(d, std=0.1, mean=1.0), r(d, std=0.1),
            heads)
    check(res16, "fused_band_mha", "bucket", bandmha.fused_band_mha,
              bandmha.fused_band_mha_plain, args,
              bound(npix * (t * 10 * d + heads * t * t * (4 * hd + 8)), npix * t * 8 * d * d,
                         2 * npix * t * d + 4 * d * d + 6 * d),
                  **probs(bandmha))
    _, b, h, w, c = LKA_CASES[0]
    nel = b * h * w * c
    args = (r(b, h, w, c), r(5, 5, c, std=0.2), r(21, c, std=0.2), r(21, c, std=0.2),
            r(c, c, std=c ** -0.5), r(c, std=0.2, mean=1.0), r(c, std=0.1))
    check(res16, "lka_gate", "bucket", lka.lka_gate, lka.lka_gate_plain, args,
              bound(nel * (2 * (25 + 21 + 21) + 8), nel * 2 * c, 2 * nel + c * c + 69 * c))
    # B13 (DAT's pre-projected windows: the tiled path at 176-px tiles) and B14 (HAT's odd
    # windows), at the table's shapes
    c, heads = DAT_C // 2, DAT_HEADS
    hd = c // heads
    _, b, h, w, hs, ws, _ = QKV_CASES[0]
    n, npix, nwin = hs * ws, b * h * w, b * (h // hs) * (w // ws)
    args = (r(b, h, w, c), r(b, h, w, c), r(b, h, w, c), r(heads, n, n, std=0.5), None,
            (hs, ws), heads)
    check(res16, "fused_window_attention_qkv", "table", wattn.fused_window_attention_qkv,
              wattn.fused_window_attention_qkv_plain, args,
              bound(nwin * heads * n * n * 8, nwin * heads * n * n * 4 * hd,
                         4 * npix * c + heads * n * n),
                  **probs(wattn))
    c, heads = HAT_C, HAT_HEADS
    hd = c // heads
    _, b, h, w, hs, ws, _ = WIN_CASES[0]
    n, npix, nwin = hs * ws, b * h * w, b * (h // hs) * (w // ws)
    args = (r(b, h, w, c), r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
            r(c, c, std=c ** -0.5), r(c, std=0.1), r(heads, n, n, std=0.5), None, (hs, ws),
            heads)
    check(res16, "fused_window_attention", "table", wattn.fused_window_attention,
              wattn.fused_window_attention_plain, args,
              bound(nwin * heads * n * n * 8,
                         npix * 8 * c * c + nwin * heads * n * n * 4 * hd,
                         2 * npix * c + 4 * c * c + 4 * c + heads * n * n),
                  **probs(wattn))
    del args
    torch.cuda.empty_cache()
    for r16 in res16.values():
        times = r16.pop("times")
        r16.update(ms=mean(t[0] for t in times), plain_ms=mean(t[1] for t in times),
                   bound=(mean(t[2][0] for t in times), times[0][2][1]))
    return res16


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def psnr_db(d: float) -> float:
    """PSNR against a peak of 1 for an RMS distance d."""
    return 20 * math.log10(1.0 / d) if d > 0 else float("inf")


def bf16_slice(gen: torch.Generator, ens_counts: dict, per_forward: dict) -> dict:
    """bf16 serving of the full FreqFusionSR (FREQFUSION_DTYPE=bfloat16) at the ensemble
    phase's checkpoints: every kernel at bf16 against its plain bf16 version and float64
    (`kernel_bf16` lines); then infer.io.main(dtype="bfloat16") serves the three requests,
    whose launches must equal the f32 ensemble's, and the submission runner serves the
    640x480 frame in tiles with FREQFUSION_DTYPE=bfloat16 set (launches: the per-image
    counts of each of its 6 chunks); the whole forward at bf16 on both paths is held to the
    f32 kernel forward (RMS distance of the fused image before any clamp, the kernel path's
    at most BF16_FORWARD_FACTOR x the plain path's; PSNR of each); per-image forward times
    at the three buckets on both bf16 paths. Returns {kernel: {...}} with the per-image
    launches."""
    t_phase = time.perf_counter()
    res16 = mode_kernel_cases(gen, "bf16")
    model_dir = os.path.join(OUT, "model_dir")
    req_dir, sr_dir = os.path.join(OUT, "requests"), os.path.join(OUT, "sr_bf16")
    big_dir = os.path.join(OUT, "requests_bf16_tiled")
    save_dir = os.path.join(OUT, "results_bf16")
    for d in (sr_dir, big_dir, os.path.join(save_dir, cli_test.MODEL_NAME, "valid")):
        for f in list_images(d) if os.path.isdir(d) else []:
            os.remove(f)
    files = list_images(req_dir)
    lrs = [load_image(f) for f in files]

    # the main path at bf16: the directory contract with dtype="bfloat16"
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = serve_directory(model_dir, req_dir, sr_dir, dtype="bfloat16")
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: n for k, n in read_launches().items() if n}
    outs = [load_image(os.path.join(sr_dir, os.path.basename(f))) for f in files]
    f32_outs = [load_image(os.path.join(OUT, "sr_ens", os.path.basename(f))) for f in files]
    lsb = max(int(np.abs(np.round(a * 255) - np.round(b * 255)).max())
              for a, b in zip(outs, f32_outs))
    png_psnr = [psnr_db(float(np.sqrt(np.mean((a - b) ** 2)))) for a, b in zip(outs, f32_outs)]
    emit("bf16_serve", images=served, seconds=serve_s, peak_mem_gib=peak, launches=counts,
         per_image={k: n / len(REQUESTS) for k, n in counts.items()},
         png_max_lsb_vs_f32=lsb, png_psnr_vs_f32_db=png_psnr)
    require(served == len(REQUESTS), f"main at bf16 served {served} images")
    for lr, arr in zip(lrs, outs):
        require(arr.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3), f"output {arr.shape}")
    require(counts == ens_counts, f"launches at bf16 {counts}, at f32 {ens_counts}")

    # the 640x480 frame in 192-px tiles through the runner, the dtype from the environment
    write_requests(big_dir, TILED_REQUESTS[:1])
    os.environ["FREQFUSION_MODEL_DIR"] = model_dir
    os.environ["FREQFUSION_DTYPE"] = "bfloat16"
    try:
        reset_launches()
        runtime_ms = cli_test.main(["--input", big_dir, "--save_dir", save_dir])
        tiled_counts = {k: n for k, n in read_launches().items() if n}
    finally:
        del os.environ["FREQFUSION_DTYPE"]
    chunks = -(-num_tiles(480, 640, 192, 32, 2) // 2)
    expected = {k: n * chunks for k, n in per_forward.items()}
    tiled_png = load_image(os.path.join(save_dir, cli_test.MODEL_NAME, "valid",
                                        os.path.basename(list_images(big_dir)[0])))
    emit("bf16_tiled", lr=list(TILED_REQUESTS[0]), chunks=chunks, seconds=runtime_ms / 1e3,
         launches=tiled_counts, output=list(tiled_png.shape),
         finite=bool(np.isfinite(tiled_png).all()))
    require(tiled_counts == expected, f"tiled launches at bf16 {tiled_counts}, expected {expected}")
    require(tiled_png.shape == (1920, 2560, 3), f"tiled output {tiled_png.shape}")

    # the whole forward of image 0 at bf16, both paths, against the f32 kernel forward
    pipe32 = build_pipeline(model_dir)
    pipe16 = build_pipeline(model_dir, dtype=BF16)
    m16 = pipe16.model
    plans = [pipe16._whole_image_plan(lr.shape[0], lr.shape[1]) for lr in lrs]
    with torch.inference_mode():
        x = torch.from_numpy(pipe32._pad([lrs[0]], *plans[0])).cuda()
        outs32, _, fused32, out32 = ens_forward(pipe32.model, x)
        # by expert and the head (on each dtype's own expert outputs): ms of both dtypes;
        # an expert's PSNR of its bf16 output against its f32 one (the model's: out_psnr)
        outs16 = m16.experts(x.to(BF16))[0]
        parts = {}
        for name in ("hat", "dat", "nafnet"):
            e32, e16 = getattr(pipe32.model.experts, name), getattr(m16.experts, name)
            parts[name] = dict(
                f32_ms=cuda_ms(lambda: e32(x), iters=2),
                bf16_ms=cuda_ms(lambda: e16(x.to(BF16)), iters=2),
                psnr_db=psnr_db(rms(outs16[name].clamp(0, 1), outs32[name].clamp(0, 1))))
        parts["head"] = dict(
            f32_ms=cuda_ms(lambda: pipe32.model.fusion(x, outs32), iters=3),
            bf16_ms=cuda_ms(lambda: m16.fusion(x.to(BF16), outs16), iters=3))
        del pipe32, outs16
        torch.cuda.empty_cache()
        _, _, fused_k, out_k = ens_forward(m16, x.to(BF16))
        set_kernels(m16, False)
        _, _, fused_p, out_p = ens_forward(m16, x.to(BF16))
        set_kernels(m16, True)
        torch.cuda.synchronize()
    d_k, d_p = rms(fused_k, fused32), rms(fused_p, fused32)
    o_k, o_p = rms(out_k, out32), rms(out_p, out32)
    finite = bool(torch.isfinite(fused_k).all() and torch.isfinite(out_k).all())
    emit("bf16_forward", bucket=list(plans[0]), by_part=parts, fused_rms_vs_f32_kernel=d_k,
         fused_rms_vs_f32_plain=d_p, fused_psnr_kernel_db=psnr_db(d_k),
         fused_psnr_plain_db=psnr_db(d_p), out_psnr_kernel_db=psnr_db(o_k),
         out_psnr_plain_db=psnr_db(o_p),
         fused_max_abs_kernel=(fused_k.double() - fused32.double()).abs().max().item(),
         fused_max_abs_plain=(fused_p.double() - fused32.double()).abs().max().item(),
         factor=BF16_FORWARD_FACTOR, finite=finite, dtype=str(out_k.dtype))
    require(finite, "non-finite bf16 forward")
    require(fused_k.dtype == BF16, f"the bf16 forward gave {fused_k.dtype}")
    require(d_k <= BF16_FORWARD_FACTOR * d_p,
            f"bf16 forward {d_k} from f32, the plain bf16 path {d_p}")
    del fused32, out32, fused_k, out_k, fused_p, out_p, outs32

    # per-image device time of the bf16 forward at each bucket, both paths
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for lr, plan in zip(lrs, plans):
            xb = torch.from_numpy(pipe16._pad([lr], *plan)).cuda().to(BF16)
            ms = {}
            for path, on in (("kernel", True), ("plain", False)):
                set_kernels(m16, on)
                ms[path] = cuda_ms(lambda: m16(xb), iters=2)
            set_kernels(m16, True)
            times.append(dict(lr=[lr.shape[1], lr.shape[0]], bucket=list(plan),
                              kernel_ms=ms["kernel"], plain_ms=ms["plain"]))
    emit("bf16_time", per_image=times, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         serve_seconds=serve_s, seconds=time.perf_counter() - t_phase)
    for k, r16 in res16.items():
        r16["launches"] = counts.get(k, 0) // len(REQUESTS)
    return res16


def default_slice(gen: torch.Generator, ens_counts: dict, per_forward: dict) -> dict:
    """Serving at precision "default" (FREQFUSION_PRECISION=default: f32 storage, every
    kernel's matmul operands rounded to bf16, TF32 in the glue) of the full FreqFusionSR at
    the ensemble phase's checkpoints: every kernel's default instantiation against its plain
    default version, the plain f32 version and float64 (`kernel_default` lines); then
    infer.io.main(precision="default") serves the three requests, whose launches must equal
    the f32 ensemble's, with both TF32 flags on and bf16 operands inside every forward and
    the caller's state after; the submission runner serves the 640x480 frame in tiles with
    FREQFUSION_PRECISION=default set (launches: the per-image counts of each of its 6
    chunks); the whole forward at default on both paths is held to the f32 kernel forward
    (RMS distance of the fused image before any clamp, the kernel path's at most
    DEFAULT_FORWARD_FACTOR x the plain default path's; PSNR of each); per-image forward
    times at the three buckets on both default paths and the f32 kernel path. Returns
    {kernel: {...}} with the per-image launches."""
    t_phase = time.perf_counter()
    resd = mode_kernel_cases(gen, "default")
    model_dir = os.path.join(OUT, "model_dir")
    req_dir, sr_dir = os.path.join(OUT, "requests"), os.path.join(OUT, "sr_default")
    big_dir = os.path.join(OUT, "requests_default_tiled")
    save_dir = os.path.join(OUT, "results_default")
    for d in (sr_dir, big_dir, os.path.join(save_dir, cli_test.MODEL_NAME, "valid")):
        for f in list_images(d) if os.path.isdir(d) else []:
            os.remove(f)
    files = list_images(req_dir)
    lrs = [load_image(f) for f in files]

    def state():
        return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                str(_mma.operand_dtype(torch.float32)))

    # the main path at default: the directory contract with precision="default", the TF32
    # flags and the operand dtype recorded inside every forward
    seen, forward = [], FreqFusionSR.forward

    def recording(self, *a, **k):
        seen.append(state())
        return forward(self, *a, **k)

    before = state()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    FreqFusionSR.forward = recording
    try:
        t0 = time.perf_counter()
        served = serve_directory(model_dir, req_dir, sr_dir, precision="default")
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    finally:
        FreqFusionSR.forward = forward
    after = state()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {k: n for k, n in read_launches().items() if n}
    outs = [load_image(os.path.join(sr_dir, os.path.basename(f))) for f in files]
    f32_outs = [load_image(os.path.join(OUT, "sr_ens", os.path.basename(f))) for f in files]
    lsb = max(int(np.abs(np.round(a * 255) - np.round(b * 255)).max())
              for a, b in zip(outs, f32_outs))
    png_psnr = [psnr_db(float(np.sqrt(np.mean((a - b) ** 2)))) for a, b in zip(outs, f32_outs)]
    inside = sorted(set(seen))
    emit("default_serve", images=served, seconds=serve_s, peak_mem_gib=peak, launches=counts,
         per_image={k: n / len(REQUESTS) for k, n in counts.items()},
         png_max_lsb_vs_f32=lsb, png_psnr_vs_f32_db=png_psnr,
         state_inside=[list(s) for s in inside], state_before=list(before),
         state_after=list(after))
    require(served == len(REQUESTS), f"main at default served {served} images")
    for lr, arr in zip(lrs, outs):
        require(arr.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3), f"output {arr.shape}")
    require(counts == ens_counts, f"launches at default {counts}, at f32 {ens_counts}")
    require(inside == [(True, True, str(BF16))], f"state inside the forwards {inside}")
    require(after == before, f"state after main {after}, before {before}")

    # the 640x480 frame in 192-px tiles through the runner, the precision from the environment
    write_requests(big_dir, TILED_REQUESTS[:1])
    os.environ["FREQFUSION_MODEL_DIR"] = model_dir
    os.environ["FREQFUSION_PRECISION"] = "default"
    try:
        reset_launches()
        runtime_ms = cli_test.main(["--input", big_dir, "--save_dir", save_dir])
        tiled_counts = {k: n for k, n in read_launches().items() if n}
    finally:
        del os.environ["FREQFUSION_PRECISION"]
    chunks = -(-num_tiles(480, 640, 192, 32, 2) // 2)
    expected = {k: n * chunks for k, n in per_forward.items()}
    tiled_png = load_image(os.path.join(save_dir, cli_test.MODEL_NAME, "valid",
                                        os.path.basename(list_images(big_dir)[0])))
    emit("default_tiled", lr=list(TILED_REQUESTS[0]), chunks=chunks, seconds=runtime_ms / 1e3,
         launches=tiled_counts, output=list(tiled_png.shape),
         finite=bool(np.isfinite(tiled_png).all()))
    require(tiled_counts == expected,
            f"tiled launches at default {tiled_counts}, expected {expected}")
    require(tiled_png.shape == (1920, 2560, 3), f"tiled output {tiled_png.shape}")

    # the whole forward of image 0 at default, both paths, against the f32 kernel forward
    pipe = build_pipeline(model_dir, precision="default")
    model = pipe.model
    plans = [pipe._whole_image_plan(lr.shape[0], lr.shape[1]) for lr in lrs]
    with torch.inference_mode():
        x = torch.from_numpy(pipe._pad([lrs[0]], *plans[0])).cuda()
        _, _, fused32, out32 = ens_forward(model, x)
        with pinned_precision("default"):
            _, _, fused_k, out_k = ens_forward(model, x)
            set_kernels(model, False)
            _, _, fused_p, out_p = ens_forward(model, x)
            set_kernels(model, True)
        torch.cuda.synchronize()
    d_k, d_p = rms(fused_k, fused32), rms(fused_p, fused32)
    o_k, o_p = rms(out_k, out32), rms(out_p, out32)
    finite = bool(torch.isfinite(fused_k).all() and torch.isfinite(out_k).all())
    emit("default_forward", bucket=list(plans[0]), fused_rms_vs_f32_kernel=d_k,
         fused_rms_vs_f32_plain=d_p, fused_psnr_kernel_db=psnr_db(d_k),
         fused_psnr_plain_db=psnr_db(d_p), out_psnr_kernel_db=psnr_db(o_k),
         out_psnr_plain_db=psnr_db(o_p),
         fused_kernel_vs_plain_rms=rms(fused_k, fused_p),
         fused_max_abs_kernel=(fused_k.double() - fused32.double()).abs().max().item(),
         fused_max_abs_plain=(fused_p.double() - fused32.double()).abs().max().item(),
         factor=DEFAULT_FORWARD_FACTOR, finite=finite, dtype=str(out_k.dtype))
    require(finite, "non-finite forward at default")
    require(fused_k.dtype == torch.float32, f"the default forward gave {fused_k.dtype}")
    require(0 < d_k <= DEFAULT_FORWARD_FACTOR * d_p,
            f"default forward {d_k} from f32, the plain default path {d_p}")
    del fused32, out32, fused_k, out_k, fused_p, out_p

    # per-image device time of the forward at each bucket: both default paths, f32 kernels
    times = []
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for lr, plan in zip(lrs, plans):
            xb = torch.from_numpy(pipe._pad([lr], *plan)).cuda()
            ms = {"f32_kernel": cuda_ms(lambda: model(xb), iters=2)}
            with pinned_precision("default"):
                for path, on in (("kernel", True), ("plain", False)):
                    set_kernels(model, on)
                    ms[path] = cuda_ms(lambda: model(xb), iters=2)
                set_kernels(model, True)
            times.append(dict(lr=[lr.shape[1], lr.shape[0]], bucket=list(plan),
                              kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                              f32_kernel_ms=ms["f32_kernel"]))
    emit("default_time", per_image=times,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, serve_seconds=serve_s,
         seconds=time.perf_counter() - t_phase)
    del pipe, model
    torch.cuda.empty_cache()
    for k, rd in resd.items():
        rd["launches"] = counts.get(k, 0) // len(REQUESTS)
    return resd


def bf16_wide_cases(gen: torch.Generator) -> None:
    """The bf16 routes that took f32 only until the K pieces summed in an f32 scratch: B5b
    and B8 above C = 192 (C = 256 and 384 on [1,128,256,C]; B5b's S-Map 16 and 32 wide), B11's
    wide route (the repair shapes D = 400 and 512, 65 tokens at D = 128, 129 at D = 64) and
    B12 above C = 1808 (1816 and 2048): each one launch of its kernel against its plain bf16
    version and float64, at the bounds of `bf16_case` (`bf16_wide` lines)."""
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    res = {}

    def one(key, case, counts, kernel, plain, args, bnd, kw=None, shape=None):
        before = counts[key]
        bf16_case(res, key, case, kernel, plain, args, bnd, kw=kw, summary=False, iters=2,
                  shape=shape, phase="bf16_wide")
        require(counts[key] > before, f"{key} at {case}: the kernel did not launch")

    b, h, w, ws = 1, 128, 256, HAT_WINDOW
    npix, n = b * h * w, ws * ws
    types = torch.from_numpy(windows.shift_mask_types(ws, ws, ws // 2, ws // 2).copy()).cuda()
    for c in WIDE_ROWS:
        for mid in (16, 32):
            args = (r(b, h, w, c), r(b, h, w, c), r(b, 1, 1, c), r(1, 1, c, mid, std=c ** -0.5),
                    r(mid, std=0.1), r(mid, std=0.2, mean=1.0), r(mid, std=0.1),
                    r(1, 1, mid, 1, std=mid ** -0.5), r(1, std=0.1), r(c, c, std=c ** -0.5),
                    r(c, std=0.1))
            one("aim_gates_proj", f"c{c}_mid{mid}", aim.launches, aim.aim_gates_proj,
                aim.aim_gates_proj_plain, args,
                bf16_bound(npix * (2 * c * mid + 2 * mid + 8 * c), npix * 2 * c * c,
                           3 * npix * c + c * mid + c * c))
        hid, heads = 2 * c, c // 32
        hd, nwin = c // heads, b * (h // ws) * (w // ws)
        ln = (r(c, std=0.1, mean=1.0), r(c, std=0.1))
        args = (r(b, h, w, c), r(b, h, w, c, std=3.0), *ln, *ln, r(c, 3 * c, std=c ** -0.5),
                r(3 * c, std=0.1), r(c, c, std=c ** -0.5), r(c, std=0.1),
                r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(hid, c, std=hid ** -0.5),
                r(c, std=0.1), r(heads, n, n, std=0.5), types, (ws, ws), heads, 0.01)
        one("fused_hab_block", f"c{c}", wattn.launches, wattn.fused_hab_block,
            wattn.fused_hab_block_plain, args,
            bf16_bound(npix * (24 * c + 10 * hid) + nwin * heads * n * n * 8,
                       npix * (8 * c * c + 4 * c * hid) + nwin * heads * n * n * 4 * hd,
                       3 * npix * c + 4 * c * c + 2 * c * hid),
            kw=dict(cab_scale=r(b, 1, 1, c, std=0.2, mean=0.5), in_shift=ws // 2))
        del args
    for case, (b, h, w, t, d, heads) in (("d400", (1, 16, 24, 9, 400, 4)),
                                         ("d512", (1, 16, 24, 9, 512, 4)),
                                         ("t65_d128", (1, 8, 12, 65, 128, 4)),
                                         ("t129_d64", (1, 8, 12, 129, 64, 4))):
        npix, hd = b * h * w, d // heads
        args = (r(b, h, w, t, d, std=0.6), r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.1),
                r(d, d, std=d ** -0.5), r(d, std=0.1), r(d, std=0.1, mean=1.0), r(d, std=0.1),
                heads)
        one("fused_band_mha", case, bandmha.launches, bandmha.fused_band_mha,
            bandmha.fused_band_mha_plain, args,
            bf16_bound(npix * (t * 10 * d + heads * t * t * (4 * hd + 8)), npix * t * 8 * d * d,
                       2 * npix * t * d + 4 * d * d + 6 * d))
    for case, (b, h, w, c) in (("c1816", (1, 32, 48, 1816)), ("c2048", (1, 32, 48, 2048))):
        nel = b * h * w * c
        args = (r(b, h, w, c), r(5, 5, c, std=0.2), r(21, c, std=0.2), r(21, c, std=0.2),
                r(c, c, std=c ** -0.5), r(c, std=0.2, mean=1.0), r(c, std=0.1))
        one("lka_gate", case, lka.launches, lka.lka_gate, lka.lka_gate_plain, args,
            bf16_bound(nel * (2 * (25 + 21 + 21) + 8), nel * 2 * c, 2 * nel + c * c + 69 * c))
    torch.cuda.empty_cache()


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
    # bf16 serving: its own lines, outside `paths` (the f32 lines keep their launches)
    res16 = bf16_slice(gen, paths[-1][1], per_forward)
    torch.cuda.empty_cache()
    # precision "default": its own lines too
    resd = default_slice(gen, paths[-1][1], per_forward)
    torch.cuda.empty_cache()
    bf16_wide_cases(gen)
    paths.append(("tiled", tiled_slice(per_forward, "tiled" in profiled)))
    torch.cuda.empty_cache()
    paths.append(("hat_odd", hat_odd_slice(torch.Generator().manual_seed(SEED))))
    torch.cuda.empty_cache()
    paths.append(("train", train_slice(per_forward)))
    torch.cuda.empty_cache()
    paths.append(("parallel", parallel_slice(per_forward)))
    torch.cuda.empty_cache()
    paths.append(("eval", eval_slice(os.path.join(OUT, "sr_ens"))))
    torch.cuda.empty_cache()
    paths.append(("tsdsr", tsdsr_slice(per_forward)))
    torch.cuda.empty_cache()
    paths.append(("v2_head", v2_slice(per_forward)))
    torch.cuda.empty_cache()
    paths.append(("mambair", mambair_slice(torch.Generator().manual_seed(SEED))))
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(n.get(k, 0) for _, n in paths),
                "launches_by_path": {tag: n[k] for tag, n in paths if k in n},
                "max_abs_err": res[k]["err"], "ms": res[k]["ms"],
                "plain_ms": res[k]["plain_ms"], "bound_ms": res[k]["bound"][0],
                "bound_by": res[k]["bound"][1],
                "bound_f32_ms": res[k].get("bound_f32", res[k]["bound"])[0],
                "library_ms": res[k]["library_ms"], **res[k].get("extra", {}),
                "ms_bf16": res16[k]["ms"], "plain_ms_bf16": res16[k]["plain_ms"],
                "bound_bf16_ms": res16[k]["bound"][0], "bound_bf16_by": res16[k]["bound"][1],
                "max_abs_err_bf16": res16[k]["err"], "max_rel_err_bf16": res16[k]["rel"],
                "launches_bf16": res16[k]["launches"],
                "instantiations": (["f32", "bf16"] if k in NO_OPERANDS
                                   else ["f32", "bf16", "default"]),
                "ms_default": resd[k]["ms"], "plain_ms_default": resd[k]["plain_ms"],
                "bound_default_ms": resd[k]["bound"][0],
                "bound_default_by": resd[k]["bound"][1],
                "max_abs_err_default": resd[k]["err"], "max_rel_err_default": resd[k]["rel"],
                "rounding_gap_default": resd[k]["gap"],
                "rounding_rms_ratio_default": resd[k]["rms_ratio"],
                "launches_default": resd[k]["launches"]}
               for k, (src, rep) in KERNELS.items()]
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
