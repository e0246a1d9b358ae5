"""The fusion head's per-pixel band attention: kernel B11 and its plain version.

Twin of ``freqfusion_tpu/ops/pallas/bandmha.py:fused_band_mha``. On ``stacked``
[B,H,W,T,D], whose T band tokens of one pixel attend to each other:

    n = LN(stacked)                                   eps 1e-5, over D
    q, k, v = split(n @ wqkv + bqkv)                  the packed in_proj, [D,3D]
    a = softmax(q k^T * (D/heads)^-1/2) v             per pixel and head, T x T scores
    out = stacked + a @ wproj + bproj

On a CUDA tensor the wrapper launches the kernel from ``csrc/bandmha.cu`` or raises; on a
CPU tensor it runs the plain PyTorch version. Weights come as ``x @ w`` matrices ([in,out]),
as the JAX package's ``TorchMHA`` stores them; they may be views (the head passes
``in_proj_weight.t()``). The kernel's products run f32-exact on the tensor cores (3xTF32)
on the weights laid out as B fragments once for each weight (``band_weights``). A pixel's
tokens that do not fit one group (more than ``max_tokens``, or wider than ``MAX_D``) take the
kernel's wide route (``band_mha_wide``: LN, the row product, the attention with an online
softmax over any number of keys, the row product, the residual, through device memory).

Every tensor of a call is float32, or every one bfloat16: then LN's output, q, k, v and the
heads' output, the products' operands, are rounded to bf16 (the TPU kernel casts them to its
operand dtype), and so are each product of a score and of p v, exp(s - the row's max) in the
softmax's sum and the probabilities, where the TPU kernel rounds them; the sums run in f32,
and the output is rounded to bf16 once, on either route (the wide route keeps its scratch
and the residual in f32). At float32 with bf16 operands (``mxu_dtype``, or precision
"default": ``_mma.operand_dtype``) the same operands and the weights are rounded to bf16 and
the output stays f32.
"""

from __future__ import annotations

import torch

from ..common import layernorm
from . import _build, _mma

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_band_mha": 0}

#: What the fused route of csrc/bandmha.cu takes: D a multiple of 16 up to MAX_D, heads of
#: any width that is a multiple of 4, and T band tokens up to the rows of a group
#: (``max_tokens``); wider or more tokens take the wide route. The wrapper zero-pads any other
#: D or head width to those steps: LN's statistics and the softmax scale keep the real widths.
MAX_D = 384


def max_tokens(d: int) -> int:
    """The most band tokens a pixel may have at token width d (after padding to the kernel's
    steps): the rows of the largest group that fits (csrc/bandmha.cu: band_mha_rows)."""
    return 128 if d <= 96 else 64 if d <= 192 else 32


def padded_widths(d: int, num_heads: int) -> tuple[int, int]:
    """(dk, hdp): the kernel's token width and head width for D = d over num_heads heads:
    the head width rounded up to 4, then the whole width (and at least the heads' sum)
    rounded up to 16. (d, d // num_heads) where no padding is needed."""
    hdp = -(-(d // num_heads) // 4) * 4
    return -(-max(d, num_heads * hdp) // 16) * 16, hdp


def _probs(e: torch.Tensor, mdt) -> torch.Tensor:
    """e / (its sum over the keys), where e = exp(scores - the row's max): the sum taken of e
    rounded to the operand dtype and the quotient rounded to it (``zsum`` and ``p`` of the TPU
    kernel)."""
    return _mma.rnd(e / _mma.rnd(e, mdt).sum(-1, keepdim=True), mdt)


def fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int,
                         mxu_dtype=None):
    """At bf16 operands every rounding of the TPU kernel: LN's output, q, k, v, each
    product q_c scale k_c of a score (summed in f32), exp(s - the row's max) in the sum, the
    probabilities, each product p v (summed in f32) and the heads' output."""
    *lead, t, d = stacked.shape
    hd = d // num_heads
    dt = stacked.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b = map(
        _mma.up, (stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b))
    wqkv, wproj = _mma.rnd(wqkv, mdt), _mma.rnd(wproj, mdt)
    qkv = _mma.rnd(_mma.rnd(layernorm(stacked, ln_w, ln_b), mdt) @ wqkv + bqkv, mdt)
    # [..., T, 3, heads, hd] -> three [..., heads, T, hd]
    q, k, v = qkv.reshape(*lead, t, 3, num_heads, hd).movedim(-3, 0).transpose(-2, -3)
    q = q * hd ** -0.5
    if mdt != torch.bfloat16:
        a = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    else:
        s = _mma.rnd(q.unsqueeze(-2) * k.unsqueeze(-3), mdt).sum(-1)
        # exp(s - the row's max over every head and key), as the TPU kernel takes it: a
        # constant of each head's softmax, but not of what its roundings give (a head whose
        # scores all lie some 87 below the row's max divides 0 by 0 there as on the TPU)
        p = _probs(torch.exp(s - s.amax(dim=(-3, -1), keepdim=True)), mdt)
        a = _mma.rnd(p.unsqueeze(-1) * v.unsqueeze(-3), mdt).sum(-2)
    a = a.transpose(-2, -3).reshape(*lead, t, d)
    return (stacked + _mma.rnd(a, mdt) @ wproj + bproj).to(dt)


def band_weights(wqkv: torch.Tensor, wproj: torch.Tensor):
    """(wqkv [D,3D], wproj [D,D]) as the kernel's B fragments, unsplit (``_mma.fragments``),
    made once for each weight, so that the views the head passes will do."""
    return _mma.fragments(wqkv), _mma.fragments(wproj)


def _padded(wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int, dk: int, hdp: int):
    """The parameters laid out for a kernel width dk and head width hdp: head h's q, k and v
    columns at h * hdp of each third of wqkv [dk, 3 dk] (rows past D, columns past the head's
    width zero), wproj's rows likewise [dk, dk], the biases and LN's affine zero-padded."""
    d = wqkv.shape[0]
    hd = d // num_heads
    w = wqkv.new_zeros(dk, 3, num_heads, hdp)
    w[:d, :, :, :hd] = wqkv.reshape(d, 3, num_heads, hd)
    b = bqkv.new_zeros(3, num_heads, hdp)
    b[:, :, :hd] = bqkv.reshape(3, num_heads, hd)
    p = wproj.new_zeros(num_heads, hdp, dk)
    p[:, :hd, :d] = wproj.reshape(num_heads, hd, d)
    # columns past the heads' sum, up to dk, stay zero in every third
    wq = w.reshape(dk, 3, num_heads * hdp)
    wq = torch.nn.functional.pad(wq, (0, dk - num_heads * hdp)).reshape(dk, 3 * dk)
    bq = torch.nn.functional.pad(b.reshape(3, num_heads * hdp),
                                 (0, dk - num_heads * hdp)).reshape(3 * dk)
    wp = torch.nn.functional.pad(p.reshape(num_heads * hdp, dk),
                                 (0, 0, 0, dk - num_heads * hdp))
    pad = (0, dk - d)
    return (wq.contiguous(), bq.contiguous(), wp.contiguous(),
            *(torch.nn.functional.pad(t, pad).contiguous() for t in (bproj, ln_w, ln_b)))


def _padded_params(wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int, dk: int, hdp: int):
    """``_padded`` with wqkv and wproj as the fused route's B fragments, made once for each
    weight (``_mma.kept``)."""
    def make():
        wq, bq, wp, *rest = _padded(*map(_mma.up, (wqkv, bqkv, wproj, bproj, ln_w, ln_b)),
                                    num_heads, dk, hdp)
        return (_mma.b_fragments(wq), bq, _mma.b_fragments(wp), *rest)

    return _mma.kept(("band_padded", num_heads, dk, hdp), make, wqkv, bqkv, wproj, bproj,
                     ln_w, ln_b)


def _wide_params(wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int, dk: int, hdp: int,
                 bf16: bool = False):
    """``_padded`` with wqkv and wproj as the row product's split planes (``_mma.mma_planes``;
    of their bf16 roundings with `bf16`, or of bf16 weights), the rest f32, for the wide route;
    made once for each weight (``_mma.kept``)."""
    def make():
        wq, bq, wp, *rest = _padded(*map(_mma.up, (wqkv, bqkv, wproj, bproj, ln_w, ln_b)),
                                    num_heads, dk, hdp)
        return (_mma.mma_planes(_mma.bf16_planes(wq, bf16)), bq,
                _mma.mma_planes(_mma.bf16_planes(wp, bf16)), *rest)

    return _mma.kept(("band_wide", num_heads, dk, hdp, bf16), make, wqkv, bqkv, wproj, bproj,
                     ln_w, ln_b)


def fused_band_mha(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads: int,
                   mxu_dtype=None):
    """Kernel B11 on CUDA, its plain version on the CPU. Returns [B,H,W,T,D]. `mxu_dtype`:
    the matmul operand dtype (``_mma.operand_dtype``; None: the process-wide one)."""
    _build.require_no_grad("fused_band_mha", stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b)
    _build.require_dtypes("fused_band_mha", stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b)
    if stacked.device.type == "cpu":
        return fused_band_mha_plain(stacked, wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads,
                                    mxu_dtype)
    if stacked.dim() != 5:
        raise ValueError(f"fused_band_mha: expected [B,H,W,T,D], got {tuple(stacked.shape)}")
    b, h, w, t, d = stacked.shape
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"fused_band_mha: D={d} is not a whole number of {num_heads} heads")
    dk, hdp = padded_widths(d, num_heads)
    if t < 1:
        raise ValueError(f"fused_band_mha: T={t}; expected at least one token")
    wide = dk > MAX_D or t > max_tokens(dk)
    io = _build.io_code(stacked, "stacked", mxu_dtype)
    _build.require(stacked, "stacked")
    # wqkv and wproj are laid out anew (band_weights, _padded_params): views will do
    for name, p, shape, contiguous in (("wqkv", wqkv, (d, 3 * d), False),
                                       ("bqkv", bqkv, (3 * d,), True),
                                       ("wproj", wproj, (d, d), False),
                                       ("bproj", bproj, (d,), True), ("ln_w", ln_w, (d,), True),
                                       ("ln_b", ln_b, (d,), True)):
        _build.require(p, name, shape, contiguous=contiguous)
    x = stacked
    if (dk, hdp) != (d, d // num_heads):   # zero-padded to the kernel's steps
        x = torch.nn.functional.pad(stacked, (0, dk - d)).contiguous()
    lib = _build.library()
    out = torch.empty_like(x)
    scale = (d // num_heads) ** -0.5   # LN and the scale keep the real widths
    if wide:
        wq, bq, wp, bp, lw, lb = _wide_params(wqkv, bqkv, wproj, bproj, ln_w, ln_b, num_heads,
                                              dk, hdp, io == 2)
        # f32 scratch in every mode: LN's output and the heads' output, then q | k | v (and
        # at bf16 the projection before the residual)
        n = torch.empty(x.shape, device=x.device, dtype=torch.float32)
        qkv = torch.empty((*x.shape[:-1], 3 * dk), device=x.device, dtype=torch.float32)
        with torch.cuda.device(stacked.device):
            err = lib.band_mha_wide(x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wp.data_ptr(),
                                    bp.data_ptr(), lw.data_ptr(), lb.data_ptr(), n.data_ptr(),
                                    qkv.data_ptr(), out.data_ptr(), b * h * w, t, dk, d,
                                    num_heads, hdp, scale, io,
                                    _build.stream_ptr(stacked.device))
        _build.check(err, "band_mha_wide")
    else:
        if (dk, hdp) == (d, d // num_heads):
            (wqkv_f, wproj_f) = band_weights(wqkv, wproj)
            params = tuple(map(_mma.f32, (bqkv, bproj, ln_w, ln_b)))
        else:
            wqkv_f, bq, wproj_f, bp, lw, lb = _padded_params(wqkv, bqkv, wproj, bproj, ln_w,
                                                             ln_b, num_heads, dk, hdp)
            params = (bq, bp, lw, lb)
        with torch.cuda.device(stacked.device):
            err = lib.band_mha(x.data_ptr(), wqkv_f.data_ptr(), params[0].data_ptr(),
                               wproj_f.data_ptr(), params[1].data_ptr(), params[2].data_ptr(),
                               params[3].data_ptr(), out.data_ptr(), b * h * w, t, dk, d,
                               num_heads, hdp, scale, io, _build.stream_ptr(stacked.device))
        _build.check(err, "band_mha")
    _build.count(launches, "fused_band_mha")
    return out if dk == d else out[..., :d].contiguous()
