"""Precision "default" of the port (f32 storage, bf16 matmul operands, f32 accumulation: the
JAX pipeline's own default) against the JAX package, and the four bf16 routes that take the
K pieces, the wide band attention and the unstaged LKA product.

* Each kernel's plain version on f32 inputs with ``mxu_dtype=torch.bfloat16`` against the
  Pallas kernel in interpret mode with ``mxu_dtype=jnp.bfloat16`` on the same f32 inputs:
  both round every matmul operand to bf16 where the TPU kernel casts it and accumulate in
  f32. Bounds: max |Δ| <= 1e-2 x max|JAX|; the f32 channel sums within 1e-3 of their sum of
  |.|; the output stays float32; and the rounding held to JAX's own: RMS |plain default -
  JAX default| <= ROUNDING x RMS |JAX default - JAX f32| (the Pallas kernel at f32
  operands), which the plain f32 version and, for each attention, the plain default version
  with the probabilities unrounded must fail (``_rounds_as_jax``; ``pytest -s`` prints the
  ratios). B5a takes no product (and no ``mxu_dtype``): at default it
  is its f32 path, bit for bit. B12's JAX function pins its operand dtype itself
  (``lka.py:134``: f32 in interpret mode), so it is held to its JAX reference chain
  (``lka.py:163``) recomputed here with the 1x1 product's operands rounded to bf16.
* A tiny ``FreqFusionSR`` at default against the JAX model at f32: at least 50 dB, and no
  further from it than the port's bf16 path is.
* ``main`` at default, by keyword (whole) and through ``FREQFUSION_PRECISION`` (tiled),
  against the JAX ``main`` at f32 (on the CPU its "default" is f32): within MAIN_LSB levels
  and MAIN_RMS levels RMS. Measured on this file's images: 1 level, 0.30-0.32 RMS; the JAX
  ``main``'s own bf16 PNGs lie 0.59-0.62 RMS from its f32 ones.
* The operand mode: ``pinned_precision("default")`` sets bf16 operands and TF32 for the
  glue, and restores the caller's; a float64 reference is never rounded; "highest" inside a
  "default" block (training, eval, TSD-SR pin it) takes f32 operands.
* The bf16 routes that the kernels took in f32 only (B5b and B8 above C = 192, B11's wide
  route, B12 above C = 1808): plain bf16 versions against the Pallas kernels in interpret
  mode at bf16 at small versions of the card's repair shapes, within 1e-2 x max|JAX|.
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
from freqfusion_tpu.ops.pallas import lka as jlka
from freqfusion_tpu.ops.pallas.bandmha import fused_band_mha as j_band_mha
from freqfusion_tpu.ops.pallas.cab import cab_chain as j_cab_chain
from freqfusion_tpu.ops.pallas.cab import conv3x3_dense as j_conv3x3
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
JBF = jnp.bfloat16
REL = 1e-2          # max |plain - Pallas| <= REL * max|Pallas|
SUMS_RTOL = 1e-3    # f32 channel sums, relative to the sum of |.|
ROUNDING = 0.25     # RMS |plain default - JAX default| <= ROUNDING x RMS |JAX default - JAX f32|
MIN_PSNR_DB = 50.0
MAIN_LSB = 2        # uint8 levels between the port's default PNGs and the JAX main's f32 ones
MAIN_RMS = 0.5      # and their RMS distance in levels (measured 0.32; JAX bf16 from f32: 0.62)


def _r(rng, *shape, std=1.0, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def _pair(*arrays):
    """f32 arrays as (torch tensors, JAX arrays) of the same values."""
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _bf(*arrays):
    """The bf16 values of f32 arrays: (torch bf16 tensors, JAX bf16 arrays), equal."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(BF) for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(JBF) for t in ts]


def _close(got, want, dtype=torch.float32):
    """got: the plain version's torch tensor of `dtype`; want: the Pallas kernel's array."""
    assert got.dtype == dtype
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


def _sums_close(got, want, values):
    denom = np.abs(np.asarray(values, np.float32)).sum(axis=(1, 2)).reshape(-1)
    diff = np.abs(got.float().numpy().reshape(got.shape[0], -1)
                  - np.asarray(want, np.float32).reshape(got.shape[0], -1))
    assert (diff / denom.reshape(got.shape[0], -1)).max() <= SUMS_RTOL


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t).astype(jnp.float32))).astype(np.float64)


def _rms(a, b):
    return float(np.sqrt(np.mean((_np(a) - _np(b)) ** 2)))


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def _rounds_as_jax(name, port, pallas, skips=()):
    """port(mdt): the plain version at operand dtype mdt; pallas(mdt): the Pallas kernel in
    interpret mode at mxu_dtype=mdt, on the same f32 inputs. The plain default version
    within REL x max|JAX| of the Pallas kernel at bf16 operands (``_close``), and rounded
    where it rounds: RMS |plain default - JAX default| <= ROUNDING x RMS |JAX default - JAX
    f32|, the distance that JAX's own roundings make. The controls must fail that bound: the
    plain version at f32 operands (a version that rounds nothing), and each of `skips`, a
    plain default version that leaves one rounding point out. Prints the ratios.
    Returns (plain default, JAX default)."""
    got, want = port(BF), pallas(JBF)
    g, w, w32 = _first(got), _first(want), _first(pallas(jnp.float32))
    _close(g, w)
    gap = _rms(w, w32)
    ratio = _rms(g, w) / gap
    controls = {"f32": _rms(_first(port(torch.float32)), w) / gap}
    for label, skipped in skips:
        controls[label] = _rms(_first(skipped()), w) / gap
    print(f"rounding {name}: RMS ratio {ratio:.4f} (bound {ROUNDING}); controls "
          + ", ".join(f"{k} {v:.3f}" for k, v in controls.items()))
    assert gap > 0 and ratio <= ROUNDING, (ratio, gap)
    for label, c in controls.items():
        assert c > ROUNDING, (label, c)
    return got, want


# ---- each kernel's plain default version against the Pallas kernel at bf16 operands


def test_naf_stages_default_match_pallas():
    b, h, w, c = 2, 12, 16, 16
    rng = np.random.default_rng(20)
    (tx, *ta), (jx, jlnw, jlnb, jw1, jb1, jwdw, jbdw) = _pair(
        _r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
        _r(rng, c, 2 * c, std=c ** -0.5), _r(rng, 2 * c, std=0.1), _r(rng, 9, 2 * c, std=1 / 3),
        _r(rng, 2 * c, std=0.1))
    (g, sums), (jg, jsums) = _rounds_as_jax(
        "B1", lambda m: nafblock.naf_block_stage_a(tx, *ta, mxu_dtype=m),
        lambda m: j_stage_a(jx, jlnw, jlnb, jw1.reshape(1, 1, c, 2 * c), jb1,
                            jwdw.reshape(3, 3, 1, 2 * c), jbdw, interpret=True, mxu_dtype=m))
    assert sums.dtype == torch.float32
    _sums_close(sums, jsums, np.asarray(jg))
    rest = (_r(rng, b, c, std=0.5), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1),
            _r(rng, c, std=0.5), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
            _r(rng, c, 2 * c, std=c ** -0.5), _r(rng, 2 * c, std=0.1),
            _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1), _r(rng, c, std=0.5))
    (tatt, *trest), (jatt, *jrest) = _pair(*rest)
    _rounds_as_jax(
        "B2", lambda m: nafblock.naf_block_stage_b(g, tx, tatt, *trest, mxu_dtype=m),
        lambda m: j_stage_b(jnp.asarray(g.numpy()), jx, jatt.reshape(b, 1, 1, c), *jrest,
                            interpret=True, mxu_dtype=m))


@pytest.mark.parametrize("cin,cout", [(3, 16), (16, 3), (36, 36)])
def test_conv3x3_default_matches_pallas(cin, cout):
    """Every case rounds its operands at default, the narrow CUDA-core ones too (the TPU
    kernel applies its operand dtype to every case, cab.py:276)."""
    rng = np.random.default_rng(21 + cin + cout)
    ts, js = _pair(_r(rng, 2, 10, 14, cin), _r(rng, 3, 3, cin, cout, std=(9 * cin) ** -0.5),
                   _r(rng, cout, std=0.1))
    _rounds_as_jax(f"B3 {cin}->{cout}", lambda m: conv3x3.conv3x3_dense(*ts, mxu_dtype=m),
                   lambda m: j_conv3x3(*js, interpret=True, mxu_dtype=m))


def _unrounded_probs(module, fn):
    """fn() with `module`'s plain versions leaving the normalised probabilities unrounded
    (one of their rounding points, ``softmax(.).astype(dt)`` in the TPU kernels): a control
    that the rounding check must catch."""
    real = module._probs
    module._probs = lambda scores, mdt: real(scores, torch.float32)
    try:
        return fn()
    finally:
        module._probs = real


@pytest.mark.parametrize("hs,ws,shifted", [(2, 8, False), (8, 2, True)])
def test_window_attention_xqkv_default_matches_pallas(hs, ws, shifted):
    b, h, w, cin, co, nh = 2, 16, 16, 24, 12, 2
    n = hs * ws
    rng = np.random.default_rng(22 + hs)
    (tx, twq, tbq, tbias), (jx, jwq, jbq, jbias) = _pair(
        _r(rng, b, h, w, cin), _r(rng, cin, 3 * co, std=cin ** -0.5), _r(rng, 3 * co, std=0.1),
        _r(rng, nh, n, n, std=0.5))
    jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if shifted else None
    tmask = TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if shifted else None
    port = lambda m: wattn.fused_window_attention_xqkv(  # noqa: E731
        tx, twq, tbq, tbias, tmask, (hs, ws), nh, mxu_dtype=m)
    _rounds_as_jax("B4", port,
                   lambda m: j_wattn_xqkv(jx, jwq, jbq, jbias, jmask, (hs, ws), nh,
                                          interpret=True, mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(wattn, lambda: port(BF)))])


def test_aim_default_matches_pallas():
    """B5b against the Pallas kernel at bf16 operands; B5a at default is its f32 path."""
    b, h, w, c, mid = 2, 9, 14, 32, 2
    rng = np.random.default_rng(23)
    ta, ja = _pair(_r(rng, b, h, w, c), _r(rng, 3, 3, 1, c, std=1 / 3), _r(rng, c, std=0.1),
                   _r(rng, c, std=0.2, mean=1.0), _r(rng, c, std=0.1))
    cx, sums = aim.aim_conv_branch(*ta)
    with _mma.operands(BF):
        cx_d, sums_d = aim.aim_conv_branch(*ta)
    assert torch.equal(cx, cx_d) and torch.equal(sums, sums_d)
    jcx, _ = jaim.aim_conv_branch(*ja, interpret=True)
    chmap = _r(rng, b, 1, 1, c, std=0.5)
    (tatt, *tw), (jatt, *jw) = _pair(
        _r(rng, b, h, w, c), _r(rng, 1, 1, c, mid, std=c ** -0.5), _r(rng, mid, std=0.1),
        _r(rng, mid, std=0.2, mean=1.0), _r(rng, mid, std=0.1),
        _r(rng, 1, 1, mid, 1, std=mid ** -0.5), _r(rng, 1, std=0.1),
        _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1))
    for swap in (False, True):
        _rounds_as_jax(
            f"B5b swap={swap}",
            lambda m: aim.aim_gates_proj(tatt, torch.from_numpy(np.asarray(jcx)),
                                         torch.from_numpy(chmap), *tw, swap=swap, mxu_dtype=m),
            lambda m: jaim.aim_gates_proj(jatt, jcx, jnp.asarray(chmap), *jw, swap=swap,
                                          interpret=True, mxu_dtype=m))


def test_sgfn_tail_default_matches_pallas():
    b, h, w, c, hid = 2, 8, 12, 20, 40
    half = hid // 2
    rng = np.random.default_rng(24)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0),
                   _r(rng, c, std=0.1), _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.05),
                   _r(rng, half, std=0.1, mean=1.0), _r(rng, half, std=0.1),
                   _r(rng, 3, 3, 1, half, std=1 / 3), _r(rng, half, std=0.1),
                   _r(rng, half, c, std=half ** -0.5), _r(rng, c, std=0.05))
    _rounds_as_jax("B6", lambda m: sgfn.fused_sgfn_tail(*ts, mxu_dtype=m),
                   lambda m: j_sgfn_tail(*js, interpret=True, mxu_dtype=m))


@pytest.mark.parametrize("shift", [0, 4])
def test_cab_chain_default_matches_pallas(shift):
    b, h, w, c, mid = 1, 16, 24, 12, 4
    rng = np.random.default_rng(25 + shift)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
                   _r(rng, 3, 3, c, mid, std=(9 * c) ** -0.5), _r(rng, mid, std=0.1),
                   _r(rng, 3, 3, mid, c, std=(9 * mid) ** -0.5), _r(rng, c, std=0.1))
    (u, sums), (ju, jsums) = _rounds_as_jax(
        f"B7 shift={shift}", lambda m: cab.cab_chain(*ts, out_shift=shift, mxu_dtype=m),
        lambda m: j_cab_chain(*js, interpret=True, out_shift=shift, mxu_dtype=m))
    assert sums.dtype == torch.float32
    _sums_close(sums, jsums, np.asarray(ju))


def _hab_args(rng, b, h, w, c, nh, win, hid):
    n = win * win
    return (_r(rng, b, h, w, c), _r(rng, b, h, w, c, std=2.0),
            _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
            _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1),
            _r(rng, c, 3 * c, std=c ** -0.5), _r(rng, 3 * c, std=0.02),
            _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
            _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.02),
            _r(rng, hid, c, std=hid ** -0.5), _r(rng, c, std=0.02),
            _r(rng, nh, n, n, std=0.3))


@pytest.mark.parametrize("in_shift", [0, 4])
def test_hab_block_default_matches_pallas(in_shift):
    b, h, w, c, nh, win, hid = 2, 16, 16, 24, 4, 8, 48
    rng = np.random.default_rng(26 + in_shift)
    ts, js = _pair(*_hab_args(rng, b, h, w, c, nh, win, hid))
    gate = _r(rng, b, 1, 1, c, std=0.2, mean=0.5)
    jmask = JW.shift_attn_mask(h, w, win, win, in_shift, in_shift) if in_shift else None
    tmask = (torch.from_numpy(np.array(TW.shift_mask_types(win, win, in_shift, in_shift)))
             if in_shift else None)
    port = lambda m: wattn.fused_hab_block(  # noqa: E731
        *ts, tmask, (win, win), nh, 0.01, cab_scale=torch.from_numpy(gate), in_shift=in_shift,
        mxu_dtype=m)
    _rounds_as_jax(f"B8 in_shift={in_shift}", port,
                   lambda m: j_hab_block(*js, jmask, (win, win), nh, 0.01,
                                         cab_scale=jnp.asarray(gate), interpret=True,
                                         in_shift=in_shift, mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(wattn, lambda: port(BF)))])


def test_overlap_attention_default_matches_pallas():
    b, h, w, c, nh, ws = 1, 16, 24, 12, 2, 8
    ov = ws // 2
    rng = np.random.default_rng(27)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, b, h, w, c),
                   _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
                   _r(rng, nh, ws * ws, (ws + ov) ** 2, std=0.3))
    port = lambda m: wattn.fused_overlap_attention(*ts, ws, ov, nh, mxu_dtype=m)  # noqa: E731
    _rounds_as_jax("B9", port, lambda m: j_overlap(*js, ws, ov, nh, interpret=True, mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(wattn, lambda: port(BF)))])


def test_residual_ln_mlp_default_matches_pallas():
    c, hid = 36, 72
    rng = np.random.default_rng(28)
    ts, js = _pair(_r(rng, 2, 12, 20, c), _r(rng, 2, 12, 20, c), _r(rng, c, std=0.1, mean=1.0),
                   _r(rng, c, std=0.1), _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, std=0.02),
                   _r(rng, hid, c, std=hid ** -0.5), _r(rng, c, std=0.02))
    _rounds_as_jax("B10", lambda m: wattn.fused_residual_ln_mlp(*ts, mxu_dtype=m),
                   lambda m: j_residual_mlp(*js, interpret=True, mxu_dtype=m))


def test_band_mha_default_matches_pallas():
    b, h, w, t, d, heads = 2, 8, 16, 9, 64, 4
    rng = np.random.default_rng(29)
    ts, js = _pair(_r(rng, b, h, w, t, d, std=0.4), _r(rng, d, 3 * d, std=d ** -0.5),
                   _r(rng, 3 * d, std=0.1), _r(rng, d, d, std=d ** -0.5), _r(rng, d, std=0.1),
                   _r(rng, d, std=0.1, mean=1.0), _r(rng, d, std=0.1))
    port = lambda m: bandmha.fused_band_mha(*ts, heads, mxu_dtype=m)  # noqa: E731
    _rounds_as_jax("B11", port, lambda m: j_band_mha(*js, heads, interpret=True, mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(bandmha, lambda: port(BF)))])


def _lka_chain(x, w5, wh, wv, wp, scale, shift, mdt=JBF):
    """The JAX package's reference chain (lka.py:lka_gate_reference) with the 1x1 product's
    operands rounded to `mdt`, where the TPU kernel casts them (lka.py:87)."""
    c = x.shape[-1]

    def dw(t, kern, kh, kw):
        return jax.lax.conv_general_dilated(
            t, kern.reshape(kh, kw, 1, c), (1, 1), [(kh // 2, kh // 2), (kw // 2, kw // 2)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c,
            precision=jax.lax.Precision.HIGHEST)

    a = dw(dw(dw(x, w5, 5, 5), wh.reshape(1, jlka.K, c), 1, jlka.K),
           wv.reshape(jlka.K, 1, c), jlka.K, 1)
    r = lambda t: t.astype(mdt).astype(jnp.float32)   # noqa: E731
    mixed = jnp.einsum("bhwc,cd->bhwd", r(a), r(wp), precision=jax.lax.Precision.HIGHEST)
    return x * jax.nn.sigmoid(mixed * scale + shift)


def test_lka_gate_default_matches_its_jax_reference_chain():
    b, h, w, c = 2, 24, 32, 64
    rng = np.random.default_rng(30)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, 5, 5, c, std=0.1), _r(rng, 21, c, std=0.1),
                   _r(rng, 21, c, std=0.1), _r(rng, c, c, std=0.1),
                   rng.uniform(0.5, 1.5, c).astype(np.float32), _r(rng, c, std=0.1))
    _rounds_as_jax("B12", lambda m: lka.lka_gate(*ts, mxu_dtype=m),
                   lambda m: _lka_chain(*js, mdt=m))
    # the chain's own f32 reference agrees with the Pallas kernel (interpret mode: f32)
    _close(lka.lka_gate(*ts), jlka.lka_gate_reference(*js))


def test_window_attention_qkv_default_matches_pallas():
    b, h, w, c, nh, hs, ws = 2, 16, 16, 12, 2, 4, 8
    n = hs * ws
    rng = np.random.default_rng(31)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, b, h, w, c),
                   _r(rng, nh, n, n, std=0.3))
    jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
    tmask = torch.from_numpy(np.array(TW.shift_mask_types(hs, ws, hs // 2, ws // 2)))
    port = lambda m: wattn.fused_window_attention_qkv(  # noqa: E731
        *ts, tmask, (hs, ws), nh, mxu_dtype=m)
    _rounds_as_jax("B13", port,
                   lambda m: j_wattn_qkv(*js, jmask, (hs, ws), nh, interpret=True, mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(wattn, lambda: port(BF)))])


def test_window_attention_default_matches_pallas():
    b, h, w, c, nh, win = 2, 16, 24, 36, 6, 8
    n = win * win
    rng = np.random.default_rng(32)
    ts, js = _pair(_r(rng, b, h, w, c), _r(rng, c, 3 * c, std=c ** -0.5),
                   _r(rng, 3 * c, std=0.02), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
                   _r(rng, nh, n, n, std=0.3))
    port = lambda m: wattn.fused_window_attention(  # noqa: E731
        *ts, None, (win, win), nh, mxu_dtype=m)
    _rounds_as_jax("B14", port,
                   lambda m: j_window_attention(*js, None, (win, win), nh, interpret=True,
                                                mxu_dtype=m),
                   skips=[("p", lambda: _unrounded_probs(wattn, lambda: port(BF)))])


# ---- the operand mode


def test_process_wide_mode_is_what_an_explicit_mxu_dtype_gives():
    """None means the process-wide mode (``pinned_precision``); an explicit value wins, as
    ``_mxu_dtype``'s override does; bf16 storage always takes bf16 operands."""
    rng = np.random.default_rng(33)
    ts, _ = _pair(_r(rng, 1, 10, 12, 36), _r(rng, 3, 3, 36, 36, std=36 ** -0.5),
                  _r(rng, 36, std=0.1))
    explicit = conv3x3.conv3x3_dense(*ts, mxu_dtype=BF)
    f32 = conv3x3.conv3x3_dense(*ts)
    with tio.pinned_precision("default"):
        assert _mma.operand_dtype(torch.float32) == BF
        assert torch.equal(conv3x3.conv3x3_dense(*ts), explicit)
        assert torch.equal(conv3x3.conv3x3_dense(*ts, mxu_dtype=torch.float32), f32)
        assert _build.io_code(ts[0]) == 2 and _build.io_code(ts[0].to(BF)) == 1
        assert _mma.operand_dtype(torch.float64) == torch.float64   # a reference: unrounded
        with tio.pinned_precision("highest"):   # training, eval and TSD-SR pin it
            assert torch.equal(conv3x3.conv3x3_dense(*ts), f32)
            assert _build.io_code(ts[0]) == 0
        assert _mma.operand_dtype(torch.float32) == BF
    assert _mma.operand_dtype(torch.float32) == torch.float32
    assert _build.io_code(ts[0]) == 0


@pytest.mark.parametrize("precision,tf32,operands", [
    ("highest", False, torch.float32), ("high", True, torch.float32), ("default", True, BF)])
def test_pinned_precision_sets_tf32_and_operands_and_restores_them(precision, tf32, operands):
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with tio.pinned_precision(precision):
                assert torch.backends.cudnn.allow_tf32 == tf32
                assert torch.backends.cuda.matmul.allow_tf32 == tf32
                assert _mma.operand_dtype(torch.float32) == operands
                raise RuntimeError("inside")
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            True, False)
        assert _mma.operand_dtype(torch.float32) == torch.float32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


# ---- the tiny model and main at default


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JFreqFusionSR(JFusionConfig(), **EXPERTS)
    variables = random_variables(jm, 0)
    tm = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
    tm.load_state_dict(freqfusion_params_from_flax(variables), strict=False)
    return jm, variables, tm


def _psnr(a, b):
    return 10 * np.log10(1.0 / np.mean((np.asarray(a, np.float64) - b) ** 2))


def test_tiny_freqfusion_default_matches_jax(tiny_pair):
    jm, variables, tm = tiny_pair
    lr = np.random.default_rng(1).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    j32 = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(lr)))
    with torch.inference_mode():
        with tio.pinned_precision("default"):
            got = tm(torch.from_numpy(lr))
        f32 = tm(torch.from_numpy(lr)).numpy()
        t16 = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
        t16.load_state_dict(tm.state_dict())
        bf = t16.to(BF)(torch.from_numpy(lr).to(BF)).float().numpy()
    assert got.dtype == torch.float32 and got.shape == (1, 128, 128, 3)
    got = got.numpy()
    assert np.isfinite(got).all()
    assert _psnr(got, j32) >= MIN_PSNR_DB
    assert _psnr(got, j32) >= _psnr(bf, j32)   # no further from f32 than the bf16 path
    assert np.abs(got - f32).max() > 0         # it did round


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
def served(tiny_pair, tmp_path_factory):
    """The tiny pair's checkpoints for both packages' main, the LR PNGs and a yaml path."""
    _, _, tm = tiny_pair
    root = tmp_path_factory.mktemp("default_main")
    model_dir, inp = root / "model", root / "in"
    for name, module in (("hat", tm.experts.hat), ("dat", tm.experts.dat)):
        os.makedirs(model_dir / "pretrained" / name)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    os.makedirs(model_dir / "pretrained" / "nafnet")
    torch.save({f"nafnet.{k}": v for k, v in tm.experts.nafnet.nafnet.state_dict().items()},
               model_dir / "pretrained" / "nafnet" / "nafnet.pth")
    torch.save(tm.fusion.state_dict(), model_dir / "fusion_head.pth")
    _write_pngs(inp, [(40, 48), (36, 44)], seed=3)
    return dict(root=root, model_dir=str(model_dir), inp=str(inp), yaml=root / "config.yaml")


@pytest.mark.parametrize("tiled", [False, True], ids=["whole", "tiled"])
def test_main_default_matches_jax_main(served, monkeypatch, tiled):
    import yaml

    tag = "tiled" if tiled else "whole"
    with open(served["yaml"], "w") as f:   # the tiny model, and tiles that suit it
        yaml.safe_dump({"model": {"expert_kwargs": EXPERTS},
                        "infer": {"tile": 32, "overlap": 8, "tile_batch": 2}}, f)
    monkeypatch.setenv("FREQFUSION_CONFIG", str(served["yaml"]))
    monkeypatch.setenv("FREQFUSION_USE_PALLAS", "0")
    monkeypatch.setattr(jio.InferencePipeline, "WHOLE_IMAGE_MAX_PX",
                        0 if tiled else jio.InferencePipeline.WHOLE_IMAGE_MAX_PX)
    monkeypatch.setenv("FREQFUSION_DTYPE", "float32")
    jio.main(served["model_dir"], served["inp"], str(served["root"] / f"jax_{tag}"), None)
    want = _read(str(served["root"] / f"jax_{tag}"))
    monkeypatch.setattr(tio.InferencePipeline, "WHOLE_IMAGE_MAX_PX",
                        0 if tiled else tio.InferencePipeline.WHOLE_IMAGE_MAX_PX)
    out = str(served["root"] / f"port_{tag}")
    if tiled:   # through FREQFUSION_PRECISION
        monkeypatch.setenv("FREQFUSION_PRECISION", "default")
        assert tio.main(served["model_dir"], served["inp"], out, "cpu") == 2
    else:       # by keyword, over the environment's highest
        monkeypatch.setenv("FREQFUSION_PRECISION", "highest")
        assert tio.main(served["model_dir"], served["inp"], out, "cpu",
                        precision="default") == 2
    assert _mma.operand_dtype(torch.float32) == torch.float32   # restored after main
    got = _read(out)
    assert got.keys() == want.keys()
    for f in got:
        diff = np.abs(got[f] - want[f])
        assert got[f].shape == want[f].shape, f
        assert diff.max() <= MAIN_LSB, f
        assert np.sqrt(np.mean(diff ** 2.0)) <= MAIN_RMS, f


def test_serving_options_read_precision_default(monkeypatch):
    monkeypatch.delenv("FREQFUSION_CONFIG", raising=False)
    monkeypatch.setenv("FREQFUSION_PRECISION", "default")
    assert tio.serving_options()["precision"] == "default"
    assert tio.serving_options(precision="high")["precision"] == "high"
    monkeypatch.setenv("FREQFUSION_PRECISION", "medium")
    with pytest.raises(ValueError, match="precision"):
        tio.serving_options()
    # bf16 storage with precision default: the bf16 instantiation, TF32 glue
    monkeypatch.setenv("FREQFUSION_PRECISION", "default")
    opt = tio.serving_options(dtype="bfloat16")
    assert (opt["dtype"], opt["precision"]) == (BF, "default")
    with tio.pinned_precision(opt["precision"]):
        assert _build.io_code(torch.zeros(4, dtype=BF)) == 1


def test_cli_passes_precision_default(served, monkeypatch, tmp_path):
    from freqfusion_tpu_torch.cli import test as cli

    seen = []
    real = tio.build_pipeline

    def spy(*args):
        seen.append(args[7])   # precision
        return real(*args)

    monkeypatch.setattr(tio, "build_pipeline", spy)
    monkeypatch.setenv("FREQFUSION_MODEL_DIR", served["model_dir"])
    monkeypatch.delenv("FREQFUSION_CONFIG", raising=False)
    cli.main(["--input", served["inp"], "--save_dir", str(tmp_path), "--device", "cpu",
              "--precision", "default"], expert_kwargs=EXPERTS, tile=32, overlap=8)
    assert seen == ["default"]
    assert len(os.listdir(tmp_path / cli.MODEL_NAME / "valid")) == 2


# ---- the four bf16 routes that the kernels took in f32 only


def test_aim_gates_proj_bf16_above_192_matches_pallas():
    b, h, w, c, mid = 1, 6, 10, 256, 16
    rng = np.random.default_rng(34)
    (tatt, tcx, *tw), (jatt, jcx, *jw) = _bf(
        _r(rng, b, h, w, c), _r(rng, b, h, w, c), _r(rng, 1, 1, c, mid, std=c ** -0.5),
        _r(rng, mid, std=0.1), _r(rng, mid, std=0.2, mean=1.0), _r(rng, mid, std=0.1),
        _r(rng, 1, 1, mid, 1, std=mid ** -0.5), _r(rng, 1, std=0.1),
        _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.1))
    chmap = _r(rng, b, 1, 1, c, std=0.5)
    for swap in (False, True):
        _close(aim.aim_gates_proj(tatt, tcx, torch.from_numpy(chmap), *tw, swap=swap),
               jaim.aim_gates_proj(jatt, jcx, jnp.asarray(chmap), *jw, swap=swap,
                                   interpret=True), BF)


def test_hab_block_bf16_above_192_matches_pallas():
    b, h, w, c, nh, win, hid = 1, 16, 16, 256, 8, 8, 512
    rng = np.random.default_rng(35)
    ts, js = _bf(*_hab_args(rng, b, h, w, c, nh, win, hid))
    _close(wattn.fused_hab_block(*ts, None, (win, win), nh, 0.01),
           j_hab_block(*js, None, (win, win), nh, 0.01, interpret=True), BF)


@pytest.mark.parametrize("t,d,heads", [(65, 128, 4), (3, 400, 4)], ids=["tokens", "width"])
def test_band_mha_bf16_wide_route_matches_pallas(t, d, heads):
    b, h, w = 1, 1, 2
    rng = np.random.default_rng(36 + t)
    ts, js = _bf(_r(rng, b, h, w, t, d, std=0.4), _r(rng, d, 3 * d, std=d ** -0.5),
                 _r(rng, 3 * d, std=0.1), _r(rng, d, d, std=d ** -0.5), _r(rng, d, std=0.1),
                 _r(rng, d, std=0.1, mean=1.0), _r(rng, d, std=0.1))
    dk, _ = bandmha.padded_widths(d, heads)
    assert dk > bandmha.MAX_D or t > bandmha.max_tokens(dk)   # the wide route's shapes
    _close(bandmha.fused_band_mha(*ts, heads), j_band_mha(*js, heads, interpret=True), BF)


def test_lka_gate_bf16_above_1808_matches_pallas():
    b, h, w, c = 1, 8, 8, 1816
    rng = np.random.default_rng(37)
    ts, js = _bf(_r(rng, b, h, w, c), _r(rng, 5, 5, c, std=0.1), _r(rng, 21, c, std=0.1),
                 _r(rng, 21, c, std=0.1), _r(rng, c, c, std=c ** -0.5),
                 rng.uniform(0.5, 1.5, c).astype(np.float32), _r(rng, c, std=0.1))
    assert c > lka.STAGED_MAX_C
    _close(lka.lka_gate(*ts), jlka.lka_gate(*js, block_h=8, interpret=True), BF)
