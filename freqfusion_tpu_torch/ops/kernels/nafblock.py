"""The fused NAFBlock: kernels B1 (stage A) and B2 (stage B), with their plain versions.

Twin of ``freqfusion_tpu/ops/pallas/nafblock.py``. On a CUDA tensor each wrapper launches
its kernel from ``csrc/nafblock.cu`` or raises; on a CPU tensor it runs the plain PyTorch
version, which computes the same math. There is no fallback from one to the other. Both
stages run their 1x1 products f32-exact on the tensor cores (3xTF32): w1, w3, w4 and w5 are
split into TF32 hi and lo parts and laid out for them once for each weight
(``stage_a_planes``, ``stage_b_planes``).

Layouts (NHWC): x, g [B,H,W,C]; w1, w4 [C,2C]; w3, w5 [C,C]; wdw [9,2C] (the 3x3
depthwise taps, row dy*3+dx); every other parameter a vector. w1, w3, w4 and w5 may be views
(a model passes its convs' weights as views, so that their planes are kept on them).

Dtypes: every tensor of a call float32, or every one bfloat16. At bfloat16 both versions
compute what the TPU kernels compute on bf16 refs: f32 math with each matmul operand
rounded to bf16 (LN outputs, g * att, the gate, and the weights), f32 accumulation, f32 sums,
and bf16 outputs. At float32 with bf16 operands (``mxu_dtype=torch.bfloat16``, or precision
"default": ``_mma.operand_dtype``) the same operands are rounded and everything is stored in
f32, as the TPU kernels compute on f32 refs with a bf16 ``mxu_dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import channel_layernorm
from . import _build, _mma

#: Kernel launches since the last reset, by kernel. Plain runs are not counted.
launches = {"naf_block_stage_a": 0, "naf_block_stage_b": 0}


def _gate(t: torch.Tensor) -> torch.Tensor:
    a, b = t.chunk(2, dim=-1)
    return a * b


def naf_block_stage_a_plain(x, ln_w, ln_b, w1, b1, wdw, bdw, mxu_dtype=None):
    """x [B,H,W,C] → (g [B,H,W,C], sums [B,C] = Σ_{H,W} g, float32)."""
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    x, ln_w, ln_b, w1, b1, wdw, bdw = map(_mma.up, (x, ln_w, ln_b, w1, b1, wdw, bdw))
    t = _mma.rnd(channel_layernorm(x, ln_w, ln_b), mdt) @ _mma.rnd(w1, mdt) + b1
    dw = t.shape[-1]
    # SAME padding zeroes t, the depthwise conv's input, not x
    t = F.conv2d(t.permute(0, 3, 1, 2), wdw.t().reshape(dw, 1, 3, 3), bdw,
                 padding=1, groups=dw).permute(0, 2, 3, 1)
    g = _gate(t).contiguous()
    return g.to(dt), g.sum(dim=(1, 2))


def naf_block_stage_b_plain(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5,
                            gamma, mxu_dtype=None):
    """Pointwise second half; att [B,C]. Returns the block output [B,H,W,C]."""
    dt = g.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5, gamma = map(
        _mma.up, (g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5, gamma))
    w3, w4, w5 = (_mma.rnd(t, mdt) for t in (w3, w4, w5))
    y = x + (_mma.rnd(g * att[:, None, None, :], mdt) @ w3 + b3) * beta
    h = _mma.rnd(_gate(_mma.rnd(channel_layernorm(y, ln2_w, ln2_b), mdt) @ w4 + b4), mdt)
    return (y + (h @ w5 + b5) * gamma).to(dt)


#: Gate channels of one pass of stage A's product; the pass's 64 columns are those channels
#: and their partners (csrc/nafblock.cu: kPassC).
STAGE_A_PASS = 32
#: Widest C that stage A's kernel takes: the halo's LN(x) is staged whole.
STAGE_A_MAX_C = 256


def stage_a_planes(w1: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """w1 [C,2C] zero-padded to [Cp,2Cp] (Cp = C rounded up to a pass's 32 gate channels;
    gate channel j in column j, its partner C+j in Cp+j) with its columns pass by pass (gate
    channels 32p.. 32p+31, then their partners Cp+32p..) as tile_mma's B fragments, hi and
    lo (``_mma.mma_planes``): [Cp/8, Cp/4, 32, 4], made once for each weight
    (``_mma.kept``); with `bf16`, of its bf16 rounding (``_mma.bf16_planes``)."""
    c = w1.shape[0]
    cp = -(-c // STAGE_A_PASS) * STAGE_A_PASS

    def make():
        w = _mma.bf16_planes(w1, bf16)
        wp = w.new_zeros(cp, 2, cp)
        wp[:c, :, :c] = w.reshape(c, 2, c)
        cols = wp.reshape(cp, 2, cp // STAGE_A_PASS, STAGE_A_PASS).permute(0, 2, 1, 3)
        return _mma.mma_planes(cols.reshape(cp, 2 * cp))

    return _mma.kept(("naf_stage_a", bf16), make, w1)


def stage_b_planes(w3: torch.Tensor, w4: torch.Tensor, w5: torch.Tensor,
                   bf16: bool = False) -> tuple:
    """Stage B's weights as tile_mma's B fragments, hi and lo (``_mma.mma_planes``), each
    zero-padded to Cp = C rounded up to the products' steps of 8 and made once for each
    weight (``_mma.kept``): w3 and w5 [Cp,Cp]; w4 [Cp,2Cp] with gate channel j in column 2j
    and its partner C+j in column 2j+1, so that the kernel's epilogue holds both halves of a
    gate in one thread. With `bf16`, of their bf16 roundings (``_mma.bf16_planes``)."""
    c = w3.shape[0]
    cp = -(-c // 8) * 8

    def w4_make():
        w4r = _mma.bf16_planes(w4, bf16)
        w = w4r.new_zeros(cp, cp, 2)
        w[:c, :c] = w4r.reshape(c, 2, c).permute(0, 2, 1)
        return _mma.mma_planes(w.reshape(cp, 2 * cp))

    return (_mma.planes(w3, cp, cp, bf16), _mma.kept(("naf_stage_b_w4", cp, bf16), w4_make, w4),
            _mma.planes(w5, cp, cp, bf16))


def naf_block_stage_a(x, ln_w, ln_b, w1, b1, wdw, bdw, mxu_dtype=None):
    """Kernel B1 on CUDA, its plain version on the CPU. Returns (g, sums [B,C]).
    `mxu_dtype`: the matmul operand dtype (``_mma.operand_dtype``; None: the process-wide
    one), as in the JAX signature."""
    _build.require_no_grad("naf_block_stage_a", x, ln_w, ln_b, w1, b1, wdw, bdw)
    _build.require_dtypes("naf_block_stage_a", x, ln_w, ln_b, w1, b1, wdw, bdw)
    if x.device.type == "cpu":
        return naf_block_stage_a_plain(x, ln_w, ln_b, w1, b1, wdw, bdw, mxu_dtype)
    b, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"naf_block_stage_a: C={c} is not a multiple of 4")
    if c > STAGE_A_MAX_C:
        raise ValueError(f"naf_block_stage_a: C={c}; the kernel takes C up to {STAGE_A_MAX_C} "
                         "(it stages the halo's LN(x) whole)")
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    _build.require(x, "x")
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)), ("b1", b1, (2 * c,)),
                           ("wdw", wdw, (9, 2 * c)), ("bdw", bdw, (2 * c,))):
        _build.require(t, name, shape)
    # laid out anew: a view will do
    _build.require(w1, "w1", (c, 2 * c), contiguous=False)
    w1p = stage_a_planes(w1, io == 2)
    ln_w, ln_b, b1, wdw, bdw = (_mma.f32(t) for t in (ln_w, ln_b, b1, wdw, bdw))
    lib = _build.library()
    g = torch.empty_like(x)
    with torch.cuda.device(x.device):
        # the tile, hence the blocks, follows the image and the card (csrc: stage_a_rows)
        nblk = lib.naf_stage_a_blocks(b, h, w, c)
        if nblk < 0:
            raise RuntimeError("naf_stage_a: the CUDA device cannot be queried")
        part = torch.empty((b, nblk, c), device=x.device, dtype=torch.float32)
        sums = torch.empty((b, c), device=x.device, dtype=torch.float32)
        err = lib.naf_stage_a(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                              w1p.data_ptr(), b1.data_ptr(), wdw.data_ptr(),
                              bdw.data_ptr(), g.data_ptr(), part.data_ptr(),
                              sums.data_ptr(), b, h, w, c, io,
                              _build.stream_ptr(x.device))
    _build.check(err, "naf_stage_a")
    _build.count(launches, "naf_block_stage_a")
    return g, sums


def naf_block_stage_b(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4, w5, b5, gamma,
                      mxu_dtype=None, *, on_chip: bool = True):
    """Kernel B2 on CUDA, its plain version on the CPU; any C that is a multiple of 4, as
    stage A takes (the products run at C rounded up to 8 on zero-padded weights). At C = 64
    the kernel keeps y and the hidden in shared memory; on_chip=False sends them through
    device memory there too, as the other widths always do (to time and test the two designs
    against each other)."""
    _build.require_no_grad("naf_block_stage_b", g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4,
                           w5, b5, gamma)
    _build.require_dtypes("naf_block_stage_b", g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4,
                          w5, b5, gamma)
    if g.device.type == "cpu":
        return naf_block_stage_b_plain(g, x, att, w3, b3, beta, ln2_w, ln2_b, w4, b4,
                                       w5, b5, gamma, mxu_dtype)
    b, h, w, c = g.shape
    if c % 4:
        raise ValueError(f"naf_block_stage_b: C={c} is not a multiple of 4")
    io = _build.io_code(g, "g", mxu_dtype)
    _build.require(g, "g")
    _build.require(x, "x", g.shape)
    _build.require(att, "att", (b, c))
    for name, t, shape in (("b3", b3, (c,)), ("beta", beta, (c,)), ("ln2_w", ln2_w, (c,)),
                           ("ln2_b", ln2_b, (c,)), ("b4", b4, (2 * c,)), ("b5", b5, (c,)),
                           ("gamma", gamma, (c,))):
        _build.require(t, name, shape)
    # laid out anew (stage_b_planes): views will do
    for name, t, shape in (("w3", w3, (c, c)), ("w4", w4, (c, 2 * c)), ("w5", w5, (c, c))):
        _build.require(t, name, shape, contiguous=False)
    w3p, w4p, w5p = stage_b_planes(w3, w4, w5, io == 2)
    b3, beta, ln2_w, ln2_b, b4, b5, gamma = (_mma.f32(t)
                                             for t in (b3, beta, ln2_w, ln2_b, b4, b5, gamma))
    lib = _build.library()
    out = torch.empty_like(g)
    # f32 scratch: the hidden where it does not stay on chip (C != 64, or not on_chip), with
    # y beside it at bf16 (out holds y at f32), the products' partial sums where K comes in
    # pieces (Cp > MAX_ROW_K)
    cp = -(-c // 8) * 8
    f32 = dict(device=g.device, dtype=torch.float32)
    hid = torch.empty(g.shape, **f32) if c != 64 or not on_chip else None
    y = torch.empty(g.shape, **f32) if hid is not None and io == 1 else None
    part = torch.empty((b, h, w, 2 * cp), **f32) if cp > _mma.MAX_ROW_K else None
    with torch.cuda.device(g.device):
        err = lib.naf_stage_b(g.data_ptr(), x.data_ptr(), att.data_ptr(), w3p.data_ptr(),
                              b3.data_ptr(), beta.data_ptr(), ln2_w.data_ptr(),
                              ln2_b.data_ptr(), w4p.data_ptr(), b4.data_ptr(),
                              w5p.data_ptr(), b5.data_ptr(), gamma.data_ptr(),
                              out.data_ptr(), None if y is None else y.data_ptr(),
                              None if hid is None else hid.data_ptr(),
                              None if part is None else part.data_ptr(), b, h, w, c, io,
                              _build.stream_ptr(g.device))
    _build.check(err, "naf_stage_b")
    _build.count(launches, "naf_block_stage_b")
    return out


def _att(sums, hw, sca_w, sca_b):
    # the [B,C]x[C,C] SCA product between the stages stays torch, as it stays XLA in JAX:
    # in f32 on the f32 sums, cast to the weights' dtype (the JAX twin's .astype(x.dtype))
    return ((sums / hw) @ _mma.up(sca_w) + _mma.up(sca_b)).to(sca_w.dtype)


def fused_naf_block(x, p):
    """The whole NAFBlock: stage A, the SCA product, stage B.

    `p` holds ln1_w, ln1_b, w1, b1, wdw, bdw, sca_w [C,C], sca_b, w3, b3, beta, ln2_w,
    ln2_b, w4, b4, w5, b5, gamma in the layouts of the module docstring."""
    g, sums = naf_block_stage_a(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"], p["wdw"],
                                p["bdw"])
    att = _att(sums, x.shape[1] * x.shape[2], p["sca_w"], p["sca_b"])
    return naf_block_stage_b(g, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"],
                             p["ln2_b"], p["w4"], p["b4"], p["w5"], p["b5"], p["gamma"])


def fused_naf_block_plain(x, p):
    """fused_naf_block through the plain versions on any device."""
    g, sums = naf_block_stage_a_plain(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"],
                                      p["wdw"], p["bdw"])
    att = _att(sums, x.shape[1] * x.shape[2], p["sca_w"], p["sca_b"])
    return naf_block_stage_b_plain(g, x, att, p["w3"], p["b3"], p["beta"], p["ln2_w"],
                                   p["ln2_b"], p["w4"], p["b4"], p["w5"], p["b5"],
                                   p["gamma"])
