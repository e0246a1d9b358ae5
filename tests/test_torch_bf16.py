"""bf16 serving of the port (``FREQFUSION_DTYPE=bfloat16``) against the JAX package at bf16.

* Each kernel's plain version on bf16 inputs and weights against the Pallas kernel in
  interpret mode on the same bf16 values: interpret mode keeps the input dtype as the
  operand dtype (``wattn._mxu_dtype``), so both round every matmul operand to bf16 and
  accumulate in f32. Bound: max |Δ| <= 1e-2 x max|JAX| (about 2.5 bf16 ulps of the output
  scale); the f32 channel sums within 1e-3 of their sum of |.|; the output is bfloat16.
* A tiny ``FreqFusionSR`` at bf16 against the JAX model at bf16 (its variables cast as
  ``tests/test_bf16_dtype.py`` casts them) and both against the JAX model at f32: PSNR >=
  50 dB each. Measured on this file's inputs: 51.7 dB port-JAX at bf16, 53.4 dB port-bf16
  against JAX f32 (the JAX package's own bf16 model: 54.5 dB).
* ``main`` at bf16, by keyword and through ``FREQFUSION_DTYPE``, against the JAX ``main`` with
  ``FREQFUSION_DTYPE=bfloat16``, whole and tiled (``WHOLE_IMAGE_MAX_PX = 0``). Two bf16
  computations that round at other places differ by about sqrt(2) times what each differs
  from f32, so the bounds are set against the JAX ``main``'s own bf16-to-f32 distance on the
  same images: RMS at most MAIN_RMS_FACTOR times it, at most MAIN_BEYOND_2 of the values
  more than 2 levels apart, and MAIN_LSB levels at most. Measured: 4 levels whole, 5 tiled,
  RMS 1.2 times the JAX package's own, 0.09-0.15% of the values beyond 2; the JAX package's
  bf16 PNGs differ from its f32 ones by up to 5 levels here, so a 3-level bound is out of
  reach.
* The JAX ``main``'s switches: a ``FREQFUSION_CONFIG`` yaml that shrinks the model read
  alike by both packages, and ``FREQFUSION_U8_BATCH``, ``FREQFUSION_WHOLE_IMAGE_PX``,
  ``FREQFUSION_WHOLE_IMAGE_SHAPES`` and ``FREQFUSION_PRECISION`` (``default`` refused).
* Refusals: a wrapper given float16, or float32 and bfloat16 in one call, raises.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from freqfusion_tpu.infer import io as jio
from freqfusion_tpu.models.experts import FreqFusionSR as JFreqFusionSR
from freqfusion_tpu.models.fusion import FusionConfig as JFusionConfig
from freqfusion_tpu.ops import windows as JW
from freqfusion_tpu.ops.pallas import aim as jaim
from freqfusion_tpu.ops.pallas.bandmha import fused_band_mha as j_band_mha
from freqfusion_tpu.ops.pallas.cab import cab_chain as j_cab_chain
from freqfusion_tpu.ops.pallas.cab import conv3x3_dense as j_conv3x3
from freqfusion_tpu.ops.pallas.lka import lka_gate as j_lka_gate
from freqfusion_tpu.ops.pallas.nafblock import naf_block_stage_a as j_stage_a
from freqfusion_tpu.ops.pallas.nafblock import naf_block_stage_b as j_stage_b
from freqfusion_tpu.ops.pallas.sgfn import fused_sgfn_tail as j_sgfn_tail
from freqfusion_tpu.ops.pallas.wattn import fused_hab_block as j_hab_block
from freqfusion_tpu.ops.pallas.wattn import fused_overlap_attention as j_overlap
from freqfusion_tpu.ops.pallas.wattn import fused_residual_ln_mlp as j_residual_mlp
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention as j_window_attention
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention_qkv as j_wattn_qkv
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention_xqkv as j_wattn_xqkv
from freqfusion_tpu_torch.infer import io as tio
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig
from freqfusion_tpu_torch.ops import windows as TW
from freqfusion_tpu_torch.ops.kernels import (_build, _mma, aim, bandmha, cab, conv3x3, lka,
                                              nafblock, sgfn, wattn)
from freqfusion_tpu_torch.utils.convert import freqfusion_params_from_flax
from test_torch_ensemble import EXPERTS, random_variables

torch.set_num_threads(2)
BF = torch.bfloat16
REL = 1e-2          # max |plain - Pallas| <= REL * max|Pallas|
SUMS_RTOL = 1e-3    # f32 channel sums, relative to the sum of |.|
MIN_PSNR_DB = 50.0
MAIN_LSB = 5        # uint8 levels between the two packages' served PNGs at bf16 (measured)
MAIN_RMS_FACTOR = 1.5  # their RMS distance over the JAX main's bf16-to-f32 (measured: 1.2)
MAIN_BEYOND_2 = 2e-3   # share of the values more than 2 levels apart (measured: 1.5e-3)


def _r(rng, *shape, std=1.0, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def _bf(*arrays):
    """The bf16 values of f32 arrays: (torch bf16 tensors, JAX bf16 arrays), equal."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(BF) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in ts]


def _close(got, want):
    """got: the plain version's bf16 torch tensor; want: the Pallas kernel's bf16 array."""
    assert got.dtype == BF
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _sums_close(got, want, values):
    denom = np.abs(np.asarray(values, np.float32)).sum(axis=(1, 2)).reshape(-1)
    diff = np.abs(got.float().numpy().reshape(got.shape[0], -1)
                  - np.asarray(want, np.float32).reshape(got.shape[0], -1))
    assert (diff / denom.reshape(got.shape[0], -1)).max() <= SUMS_RTOL


def test_naf_stages_bf16_match_pallas():
    b, h, w, c = 2, 12, 16, 16
    rng = np.random.default_rng(0)
    x, lnw, lnb = _r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1)
    w1, b1 = _r(rng, c, 2 * c, std=c ** -0.5), _r(rng, 2 * c, std=0.1)
    wdw, bdw = _r(rng, 9, 2 * c, std=1 / 3), _r(rng, 2 * c, std=0.1)
    (tx, tlnw, tlnb, tw1, tb1, twdw, tbdw), (jx, jlnw, jlnb, jw1, jb1, jwdw, jbdw) = _bf(
        x, lnw, lnb, w1, b1, wdw, bdw)
    g, sums = nafblock.naf_block_stage_a(tx, tlnw, tlnb, tw1, tb1, twdw, tbdw)
    jg, jsums = j_stage_a(jx, jlnw, jlnb, jw1.reshape(1, 1, c, 2 * c), jb1,
                          jwdw.reshape(3, 3, 1, 2 * c), jbdw, interpret=True)
    _close(g, jg)
    assert sums.dtype == torch.float32
    _sums_close(sums, jsums, np.asarray(jg.astype(jnp.float32)))

    att = _r(rng, b, c, std=0.5)
    rest = (_r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1), _r(rng, c, std=0.5),
            _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
            _r(rng, c, 2 * c, std=c ** -0.5), _r(rng, 2 * c, std=0.1),
            _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1), _r(rng, c, std=0.5))
    (tatt, *trest), (jatt, *jrest) = _bf(att, *rest)
    got = nafblock.naf_block_stage_b(g, tx, tatt, *trest)
    want = j_stage_b(jg, jx, jatt.reshape(b, 1, 1, c), *jrest, interpret=True)
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 3), (36, 36)])
def test_conv3x3_bf16_matches_pallas(cin, cout):
    rng = np.random.default_rng(cin + cout)
    (tx, tw, tb), (jx, jw, jb) = _bf(_r(rng, 2, 10, 14, cin),
                                     _r(rng, 3, 3, cin, cout, std=(9 * cin) ** -0.5),
                                     _r(rng, cout, std=0.1))
    _close(conv3x3.conv3x3_dense(tx, tw, tb), j_conv3x3(jx, jw, jb, interpret=True))


@pytest.mark.parametrize("hs,ws,shifted", [(2, 8, False), (8, 2, True)])
def test_window_attention_xqkv_bf16_matches_pallas(hs, ws, shifted):
    b, h, w, cin, co, nh = 2, 16, 16, 24, 12, 2
    n = hs * ws
    rng = np.random.default_rng(hs + 10 * ws)
    (tx, twq, tbq, tbias), (jx, jwq, jbq, jbias) = _bf(
        _r(rng, b, h, w, cin), _r(rng, cin, 3 * co, std=cin ** -0.5), _r(rng, 3 * co, std=0.1),
        _r(rng, nh, n, n, std=0.5))
    jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if shifted else None
    tmask = TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if shifted else None
    _close(wattn.fused_window_attention_xqkv(tx, twq, tbq, tbias, tmask, (hs, ws), nh),
           j_wattn_xqkv(jx, jwq, jbq, jbias, jmask, (hs, ws), nh, interpret=True))


def test_aim_bf16_matches_pallas():
    b, h, w, c, mid = 2, 9, 14, 32, 2
    rng = np.random.default_rng(3)
    (tv, twdw, tbdw, ts, tsh), (jv, jwdw, jbdw, js, jsh) = _bf(
        _r(rng, b, h, w, c), _r(rng, 3, 3, 1, c, std=1 / 3), _r(rng, c, std=0.1),
        _r(rng, c, std=0.2, mean=1.0), _r(rng, c, std=0.1))
    cx, sums = aim.aim_conv_branch(tv, twdw, tbdw, ts, tsh)
    jcx, jsums = jaim.aim_conv_branch(jv, jwdw, jbdw, js, jsh, interpret=True)
    _close(cx, jcx)
    _sums_close(sums, jsums, np.asarray(jcx.astype(jnp.float32)))
    # the C-Map comes in f32 from B5a's f32 sums, as the JAX model hands it over
    chmap = _r(rng, b, 1, 1, c, std=0.5)
    (tatt, *tw), (jatt, *jw) = _bf(
        _r(rng, b, h, w, c), _r(rng, 1, 1, c, mid, std=c ** -0.5), _r(rng, mid, std=0.1),
        _r(rng, mid, std=0.2, mean=1.0), _r(rng, mid, std=0.1),
        _r(rng, 1, 1, mid, 1, std=mid ** -0.5), _r(rng, 1, std=0.1),
        _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1))
    for swap in (False, True):
        got = aim.aim_gates_proj(tatt, cx, torch.from_numpy(chmap), *tw, swap=swap)
        want = jaim.aim_gates_proj(jatt, jcx, jnp.asarray(chmap), *jw, swap=swap,
                                   interpret=True)
        _close(got, want)


def test_sgfn_tail_bf16_matches_pallas():
    b, h, w, c, hid = 2, 8, 12, 20, 40
    half = hid // 2
    rng = np.random.default_rng(4)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0),
                 _r(rng, c, std=0.1), _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.05),
                 _r(rng, half, std=0.1, mean=1.0), _r(rng, half, std=0.1),
                 _r(rng, 3, 3, 1, half, std=1 / 3), _r(rng, half, std=0.1),
                 _r(rng, half, c, std=half ** -0.5), _r(rng, c, std=0.05))
    _close(sgfn.fused_sgfn_tail(*ts), j_sgfn_tail(*js, interpret=True))


@pytest.mark.parametrize("shift", [0, 4])
def test_cab_chain_bf16_matches_pallas(shift):
    b, h, w, c, mid = 1, 16, 24, 12, 4
    rng = np.random.default_rng(5 + shift)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
                 _r(rng, 3, 3, c, mid, std=(9 * c) ** -0.5), _r(rng, mid, std=0.1),
                 _r(rng, 3, 3, mid, c, std=(9 * mid) ** -0.5), _r(rng, c, std=0.1))
    u, sums = cab.cab_chain(*ts, out_shift=shift)
    ju, jsums = j_cab_chain(*js, interpret=True, out_shift=shift)
    _close(u, ju)
    assert sums.dtype == torch.float32
    _sums_close(sums, jsums, np.asarray(ju.astype(jnp.float32)))


@pytest.mark.parametrize("in_shift", [0, 4])
def test_hab_block_bf16_matches_pallas(in_shift):
    b, h, w, c, nh, win, hid = 2, 16, 16, 24, 4, 8, 48
    n = win * win
    rng = np.random.default_rng(6 + in_shift)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, b, h, w, c, std=2.0),
                 _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
                 _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
                 _r(rng, c, 3 * c, std=c ** -0.5), _r(rng, 3 * c, std=0.02),
                 _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
                 _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.02),
                 _r(rng, hid, c, std=hid ** -0.5), _r(rng, c, std=0.02),
                 _r(rng, nh, n, n, std=0.3))
    # the CA gate in f32, as the model computes it from B7's f32 sums
    gate = _r(rng, b, 1, 1, c, std=0.2, mean=0.5)
    jmask = JW.shift_attn_mask(h, w, win, win, in_shift, in_shift) if in_shift else None
    tmask = (torch.from_numpy(np.array(TW.shift_mask_types(win, win, in_shift, in_shift)))
             if in_shift else None)
    got = wattn.fused_hab_block(*ts, tmask, (win, win), nh, 0.01,
                                cab_scale=torch.from_numpy(gate), in_shift=in_shift)
    want = j_hab_block(*js, jmask, (win, win), nh, 0.01, cab_scale=jnp.asarray(gate),
                       interpret=True, in_shift=in_shift)
    _close(got, want)


def test_overlap_attention_bf16_matches_pallas():
    b, h, w, c, nh, ws = 1, 16, 24, 12, 2, 8
    ov = ws // 2
    rng = np.random.default_rng(7)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, b, h, w, c),
                 _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
                 _r(rng, nh, ws * ws, (ws + ov) ** 2, std=0.3))
    _close(wattn.fused_overlap_attention(*ts, ws, ov, nh),
           j_overlap(*js, ws, ov, nh, interpret=True))


def test_residual_ln_mlp_bf16_matches_pallas():
    c, hid = 36, 72
    rng = np.random.default_rng(8)
    ts, js = _bf(_r(rng, 2, 12, 20, c), _r(rng, 2, 12, 20, c), _r(rng, c, std=0.1, mean=1.0),
                 _r(rng, c, std=0.1), _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.02),
                 _r(rng, hid, c, std=hid ** -0.5), _r(rng, c, std=0.02))
    _close(wattn.fused_residual_ln_mlp(*ts), j_residual_mlp(*js, interpret=True))


def test_band_mha_bf16_matches_pallas():
    b, h, w, t, d, heads = 2, 8, 16, 9, 64, 4
    rng = np.random.default_rng(9)
    ts, js = _bf(_r(rng, b, h, w, t, d, std=0.4), _r(rng, d, 3 * d, std=d ** -0.5),
                 _r(rng, 3 * d, std=0.1), _r(rng, d, d, std=d ** -0.5), _r(rng, d, std=0.1),
                 _r(rng, d, std=0.1, mean=1.0), _r(rng, d, std=0.1))
    _close(bandmha.fused_band_mha(*ts, heads), j_band_mha(*js, heads, interpret=True))


def test_lka_gate_bf16_matches_pallas():
    b, h, w, c = 2, 24, 32, 64
    rng = np.random.default_rng(10)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, 5, 5, c, std=0.1), _r(rng, 21, c, std=0.1),
                 _r(rng, 21, c, std=0.1), _r(rng, c, c, std=0.1),
                 rng.uniform(0.5, 1.5, c).astype(np.float32), _r(rng, c, std=0.1))
    _close(lka.lka_gate(*ts), j_lka_gate(*js, block_h=8, interpret=True))


def test_window_attention_qkv_bf16_matches_pallas():
    b, h, w, c, nh, hs, ws = 2, 16, 16, 12, 2, 4, 8
    n = hs * ws
    rng = np.random.default_rng(11)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, b, h, w, c),
                 _r(rng, nh, n, n, std=0.3))
    jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
    tmask = torch.from_numpy(np.array(TW.shift_mask_types(hs, ws, hs // 2, ws // 2)))
    _close(wattn.fused_window_attention_qkv(*ts, tmask, (hs, ws), nh),
           j_wattn_qkv(*js, jmask, (hs, ws), nh, interpret=True))


def test_window_attention_bf16_matches_pallas():
    b, h, w, c, nh, win = 2, 16, 24, 36, 6, 8
    n = win * win
    rng = np.random.default_rng(12)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, c, 3 * c, std=c ** -0.5),
                 _r(rng, 3 * c, std=0.02), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
                 _r(rng, nh, n, n, std=0.3))
    _close(wattn.fused_window_attention(*ts, None, (win, win), nh),
           j_window_attention(*js, None, (win, win), nh, interpret=True))


def test_mma_planes_of_a_bf16_weight():
    """A bf16 weight's planes: hi the exact values, lo zero; kept apart from an f32 copy."""
    w32 = torch.randn(16, 24)
    w16 = w32.to(BF)
    hi, lo = _mma.split_tf32(w16)
    assert hi.dtype == torch.float32 and torch.equal(hi, w16.float())
    assert not lo.any()
    p16, p32 = _mma.planes(w16, 16, 24), _mma.planes(w32, 16, 24)
    assert p16.dtype == torch.float32 and p16.shape == p32.shape
    assert torch.equal(p16[..., :2], _mma.b_fragments(w16.float()))
    assert not p16[..., 2:].any()
    assert not torch.equal(p16, p32)
    assert _mma.f32(w32) is w32 and torch.equal(_mma.f32(w16), w16.float())


# ---- refusals


def test_wrappers_refuse_float16_and_mixes():
    x = torch.randn(1, 8, 8, 16)
    w, b = torch.randn(3, 3, 16, 16), torch.randn(16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3.conv3x3_dense(x.half(), w.half(), b.half())
    with pytest.raises(ValueError, match="one dtype"):
        conv3x3.conv3x3_dense(x.to(BF), w, b)
    args = (torch.randn(1, 8, 8, 16), torch.randn(5, 5, 16), torch.randn(21, 16),
            torch.randn(21, 16), torch.randn(16, 16), torch.randn(16), torch.randn(16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lka.lka_gate(*(a.half() for a in args))
    with pytest.raises(ValueError, match="one dtype"):
        lka.lka_gate(args[0].to(BF), *args[1:])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _build.io_code(x.half())
    assert _build.io_code(x) == 0 and _build.io_code(x.to(BF)) == 1


# ---- the tiny model and main


@pytest.fixture(scope="module")
def bf16_pair():
    jm = JFreqFusionSR(JFusionConfig(), **EXPERTS)
    variables = random_variables(jm, 0)
    tm = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
    tm.load_state_dict(freqfusion_params_from_flax(variables), strict=False)
    return jm, variables, tm


def _bf16_tree(tree):
    """The JAX variables cast as tests/test_bf16_dtype.py:_bf16 casts them."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if hasattr(a, "dtype") and a.dtype == jnp.float32
        else a, tree)


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


def test_tiny_freqfusion_bf16_matches_jax(bf16_pair):
    jm, variables, tm = bf16_pair
    lr = np.random.default_rng(1).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    j32 = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(lr)))
    j16 = np.asarray(jax.jit(jm.apply)(_bf16_tree(variables),
                                       jnp.asarray(lr).astype(jnp.bfloat16)).astype(jnp.float32))
    t16 = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
    t16.load_state_dict(tm.state_dict())
    t16 = t16.to(BF)
    with torch.inference_mode():
        got = t16(torch.from_numpy(lr).to(BF))
    assert got.dtype == BF and got.shape == (1, 128, 128, 3)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert _psnr(got, j16) >= MIN_PSNR_DB
    assert _psnr(got, j32) >= MIN_PSNR_DB
    assert _psnr(j16, j32) >= MIN_PSNR_DB


def _write_pngs(directory, sizes, seed):
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        base = rng.uniform(0.15, 0.85, (h // 4 + 1, w // 4 + 1, 3))
        img = np.kron(base, np.ones((4, 4, 1)))[:h, :w] + 0.05 * rng.standard_normal((h, w, 3))
        Image.fromarray((np.clip(img, 0, 1) * 255).round().astype(np.uint8)).save(
            os.path.join(directory, f"im{i}.png"))


def _read(directory):
    return {f: np.asarray(Image.open(os.path.join(directory, f))).astype(np.int32)
            for f in sorted(os.listdir(directory))}


@pytest.fixture(scope="module")
def served_pair(bf16_pair, tmp_path_factory):
    """The checkpoints of the tiny pair written for both packages' main (the experts'
    .pth, the head's .pth), and the JAX main's PNGs at bf16, whole and tiled."""
    jm, variables, tm = bf16_pair
    root = tmp_path_factory.mktemp("bf16_main")
    model_dir, inp = root / "model", root / "in"
    for name, module in (("hat", tm.experts.hat), ("dat", tm.experts.dat)):
        os.makedirs(model_dir / "pretrained" / name)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    os.makedirs(model_dir / "pretrained" / "nafnet")
    torch.save({f"nafnet.{k}": v for k, v in tm.experts.nafnet.nafnet.state_dict().items()},
               model_dir / "pretrained" / "nafnet" / "nafnet.pth")
    torch.save(tm.fusion.state_dict(), model_dir / "fusion_head.pth")
    _write_pngs(inp, [(40, 48), (36, 44)], seed=2)
    yaml_path = root / "config.yaml"
    return dict(root=root, model_dir=str(model_dir), inp=str(inp), yaml=yaml_path)


def _jax_main(dtype, monkeypatch, pair, out, tiled: bool):
    monkeypatch.setenv("FREQFUSION_DTYPE", dtype)
    monkeypatch.setattr(jio.InferencePipeline, "WHOLE_IMAGE_MAX_PX",
                        0 if tiled else jio.InferencePipeline.WHOLE_IMAGE_MAX_PX)
    jio.main(pair["model_dir"], pair["inp"], out, None)
    return _read(out)


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_main_bf16_matches_jax_main(served_pair, monkeypatch, tiled):
    import yaml

    pair = served_pair
    tag = "tiled" if tiled else "whole"
    with open(pair["yaml"], "w") as f:   # the tiny model, and tiles that suit it
        yaml.safe_dump({"model": {"expert_kwargs": EXPERTS},
                        "infer": {"tile": 32, "overlap": 8, "tile_batch": 2}}, f)
    monkeypatch.setenv("FREQFUSION_CONFIG", str(pair["yaml"]))
    monkeypatch.setenv("FREQFUSION_USE_PALLAS", "0")
    want = _jax_main("bfloat16", monkeypatch, pair, str(pair["root"] / f"jax_{tag}"), tiled)
    want32 = _jax_main("float32", monkeypatch, pair, str(pair["root"] / f"jax32_{tag}"), tiled)
    monkeypatch.setattr(tio.InferencePipeline, "WHOLE_IMAGE_MAX_PX",
                        0 if tiled else tio.InferencePipeline.WHOLE_IMAGE_MAX_PX)
    # by keyword (the environment says float32), then through FREQFUSION_DTYPE
    monkeypatch.setenv("FREQFUSION_DTYPE", "float32")
    out_kw = str(pair["root"] / f"kw_{tag}")
    assert tio.main(pair["model_dir"], pair["inp"], out_kw, "cpu", dtype="bfloat16") == 2
    monkeypatch.setenv("FREQFUSION_DTYPE", "bfloat16")
    out_env = str(pair["root"] / f"env_{tag}")
    tio.main(pair["model_dir"], pair["inp"], out_env, "cpu")
    got_kw, got_env = _read(out_kw), _read(out_env)
    assert got_kw.keys() == want.keys() == got_env.keys()
    for f in want:
        assert got_kw[f].shape == want[f].shape
        np.testing.assert_array_equal(got_kw[f], got_env[f])
        diff = np.abs(got_kw[f] - want[f])
        own = np.sqrt(np.mean((want[f] - want32[f]) ** 2.0))
        assert diff.max() <= MAIN_LSB, f
        assert np.sqrt(np.mean(diff ** 2.0)) <= MAIN_RMS_FACTOR * own, f
        assert (diff > 2).mean() <= MAIN_BEYOND_2, f


def test_serving_switches_are_read_as_the_jax_main_reads_them(served_pair, monkeypatch):
    import yaml

    with open(served_pair["yaml"], "w") as f:
        yaml.safe_dump({"model": {"fusion_dim": 16, "num_heads": 2,
                                  "expert_kwargs": {"nafnet_kwargs": {"width": 8}}},
                        "infer": {"tile": 64, "overlap": 16, "tile_batch": 3}}, f)
    monkeypatch.setenv("FREQFUSION_CONFIG", str(served_pair["yaml"]))
    for k, v in (("FREQFUSION_DTYPE", "bfloat16"), ("FREQFUSION_PRECISION", "high"),
                 ("FREQFUSION_U8_BATCH", "3"), ("FREQFUSION_WHOLE_IMAGE_PX", "0"),
                 ("FREQFUSION_WHOLE_IMAGE_SHAPES", "4")):
        monkeypatch.setenv(k, v)
    opt = tio.serving_options(fusion_config=None, expert_kwargs=None, tile=None)
    assert opt["dtype"] == BF and opt["precision"] == "high" and opt["group_max"] == 3
    assert opt["whole_image_px"] == 0 and opt["whole_image_shapes"] == 4
    assert (opt["tile"], opt["overlap"], opt["tile_batch"]) == (64, 16, 3)
    assert opt["expert_kwargs"] == {"nafnet_kwargs": {"width": 8}}
    assert (opt["fusion_config"].fusion_dim, opt["fusion_config"].num_heads) == (16, 2)
    # the JAX package's reader of the same yaml, and its FusionConfig of the same keys
    from freqfusion_tpu.utils.runtime import runtime_overrides as jax_overrides
    from freqfusion_tpu_torch.utils.runtime import runtime_overrides
    assert runtime_overrides() == jax_overrides()
    m = dict(jax_overrides()["model"])
    m.pop("expert_kwargs")
    assert JFusionConfig(**m).fusion_dim == opt["fusion_config"].fusion_dim
    # a keyword wins over its switch; without the switches the defaults hold
    assert tio.serving_options(dtype="float32", group_max=1)["dtype"] == torch.float32
    for k in ("FREQFUSION_DTYPE", "FREQFUSION_PRECISION", "FREQFUSION_U8_BATCH",
              "FREQFUSION_WHOLE_IMAGE_PX", "FREQFUSION_WHOLE_IMAGE_SHAPES",
              "FREQFUSION_CONFIG"):
        monkeypatch.delenv(k)
    opt = tio.serving_options()
    assert (opt["dtype"], opt["precision"], opt["group_max"]) == (torch.float32, "highest", 1)
    assert "whole_image_px" not in opt or opt["whole_image_px"] is None
    assert (opt["tile"], opt["overlap"], opt["tile_batch"]) == (tio.TILE, tio.OVERLAP,
                                                                tio.TILE_BATCH)
    assert opt["fusion_config"] is None and opt["expert_kwargs"] is None


def test_main_applies_the_whole_image_switches(served_pair, monkeypatch):
    """FREQFUSION_WHOLE_IMAGE_PX=0 sends every image to the tiled path, as in the JAX main."""
    import yaml

    with open(served_pair["yaml"], "w") as f:
        yaml.safe_dump({"model": {"expert_kwargs": EXPERTS},
                        "infer": {"tile": 32, "overlap": 8, "tile_batch": 2}}, f)
    monkeypatch.setenv("FREQFUSION_CONFIG", str(served_pair["yaml"]))
    monkeypatch.setenv("FREQFUSION_WHOLE_IMAGE_PX", "0")
    monkeypatch.setenv("FREQFUSION_WHOLE_IMAGE_SHAPES", "1")
    seen = {}
    real = tio.InferencePipeline.run_tiled_u8

    def spy(self, lr):
        seen["px"], seen["shapes"] = self.WHOLE_IMAGE_MAX_PX, self.WHOLE_IMAGE_MAX_SHAPES
        seen["n"] = seen.get("n", 0) + 1
        return real(self, lr)

    monkeypatch.setattr(tio.InferencePipeline, "run_tiled_u8", spy)
    out = str(served_pair["root"] / "switch_out")
    assert tio.main(served_pair["model_dir"], served_pair["inp"], out, "cpu") == 2
    assert seen == {"px": 0, "shapes": 1, "n": 2}


@pytest.mark.parametrize("bad", [{"precision": "default"}, {"dtype": "float16"}])
def test_main_refuses_precision_default_and_other_dtypes(served_pair, bad):
    with pytest.raises(ValueError, match="ROADMAP B-ii" if "precision" in bad else "dtype"):
        tio.main(served_pair["model_dir"], served_pair["inp"],
                 str(served_pair["root"] / "refused"), "cpu", **bad)


def test_precision_default_from_the_environment_names_the_roadmap_item(monkeypatch):
    monkeypatch.setenv("FREQFUSION_PRECISION", "default")
    with pytest.raises(ValueError, match="ROADMAP B-ii"):
        tio.serving_options()
