"""Published peaks of one H100 SXM and the least time each of the program's hand-written
kernel launches could take, from its shape.

Peaks (NVIDIA's data sheet, dense, at the 700 W limit): products on the tensor cores at the
peak of the configuration's numerics (``core/precision.py``: 495 TFLOP/s in TF32 for float32
at ``highest``, 989 TFLOP/s in bf16 for bfloat16 and for float32 at ``default``), every other
operation at 67 TFLOP/s on the CUDA cores, memory at 3.35 TB/s. A launch's bound is the
largest of its products over the tensor-core peak, its other operations over the CUDA-core
peak and its bytes over the memory rate, each input read once and each output written once,
in elements of the stored dtype. The operation and element counts are those the kernels'
own correctness checks use, one formula per kernel; a model's file (``models/<name>.py``,
``launches``) lists the launches of its forward from its sizes and the image.
"""

from __future__ import annotations

from perfbench.core.precision import numerics

CUDA_CORE = 67e12
MEMORY = 3.35e12


def launch_s(cuda_flops: float, tc_flops: float, elements: float, dtype: str,
             precision: str = "highest") -> float:
    num = numerics(dtype, precision)
    return max(cuda_flops / CUDA_CORE, tc_flops / num.tensor_core,
               elements * num.element_bytes / MEMORY)


# one function a kernel: (CUDA-core FLOPs, tensor-core FLOPs, elements)

def conv3x3(b, h, w, cin, cout):
    """B3: the wide case (both widths 32 or more) on the tensor cores, else CUDA cores."""
    prod = b * h * w * 18 * cin * cout
    wide = min(cin, cout) >= 32
    return (0.0 if wide else prod, prod if wide else 0.0,
            b * h * w * (cin + cout) + 9 * cin * cout + cout)


def naf_stage_a(b, h, w, c):
    npix = b * h * w
    return npix * 45 * c, npix * 4 * c * c, 2 * npix * c + 2 * c * c + 24 * c + b * c


def naf_stage_b(b, h, w, c):
    npix = b * h * w
    return npix * 16 * c, npix * 8 * c * c, 3 * npix * c + 4 * c * c + 9 * c + b * c


def window_attention_xqkv(b, h, w, c, co, heads, hs, ws, shifted):
    """B4: one branch's projection from the image and its window attention."""
    npix, n = b * h * w, hs * ws
    nwin, hd = npix // n, co // heads
    return (nwin * heads * n * n * 8, npix * 2 * c * 3 * co + nwin * heads * n * n * 4 * hd,
            npix * (c + co) + c * 3 * co + 3 * co + (heads + (4 if shifted else 0)) * n * n)


def aim_conv_branch(b, h, w, c):
    npix = b * h * w
    return npix * c * 30, 0.0, 2 * npix * c + 12 * c + b * c


def aim_gates_proj(b, h, w, c, mid):
    npix = b * h * w
    return (npix * (2 * c * mid + 2 * mid + 8 * c), npix * 2 * c * c,
            3 * npix * c + b * c + c * mid + c * c + 3 * mid + c + 2)


def sgfn_tail(b, h, w, c, hid):
    npix, half = b * h * w, hid // 2
    return (npix * (8 * c + 10 * hid + 28 * half), npix * (2 * c * hid + 2 * half * c),
            3 * npix * c + c * hid + half * c + hid + 13 * half + 3 * c)


def cab_chain(b, h, w, c, mid):
    npix = b * h * w
    return (npix * (10 * c + 10 * mid), npix * 36 * c * mid,
            2 * npix * c + 18 * c * mid + 3 * c + mid + b * c)


def hab_block(b, h, w, c, hid, heads, ws, shifted):
    npix, n = b * h * w, ws * ws
    nwin, hd = npix // n, c // heads
    return (npix * (24 * c + 10 * hid) + nwin * heads * n * n * 8,
            npix * (8 * c * c + 4 * c * hid) + nwin * heads * n * n * 4 * hd,
            3 * npix * c + 4 * c * c + 2 * c * hid + 8 * c + hid + b * c
            + (heads + (4 if shifted else 0)) * n * n)


def overlap_attention(b, h, w, c, heads, ws, wse):
    npix, n, nk = b * h * w, ws * ws, wse * wse
    nwin, hd = npix // n, c // heads
    return (nwin * heads * n * nk * 8, nwin * heads * n * nk * 4 * hd + npix * 2 * c * c,
            4 * npix * c + c * c + c + heads * n * nk)


def residual_ln_mlp(b, h, w, c, hid):
    npix = b * h * w
    return npix * (12 * c + 10 * hid), npix * 4 * c * hid, 3 * npix * c + 2 * c * hid + hid + 3 * c


def band_mha(b, h, w, t, d, heads):
    npix, hd = b * h * w, d // heads
    return (npix * (t * 10 * d + heads * t * t * (4 * hd + 8)), npix * t * 8 * d * d,
            2 * npix * t * d + 4 * d * d + 6 * d)


def lka_gate(b, h, w, c):
    n = b * h * w * c
    return n * (2 * (25 + 21 + 21) + 8), n * 2 * c, 2 * n + c * c + 69 * c


def forward_bound(model, cfg: dict, b: int, h: int, w: int, dtype: str,
                  precision: str = "highest") -> float:
    """Least seconds the card could take for the hand-written kernels of one forward of
    `model` (a ``perfbench/models`` file) on a [b, h, w, 3] batch."""
    return sum(launch_s(*work, dtype, precision) for _, work in model.launches(cfg, b, h, w))
