"""Port parity at the widths and windows that the card's kernels newly take: the plain
versions of B13 (more than 256 tokens, heads wider than 32), B9 (HAT's window 32), B6
(hidden/2 above 384), B1 and B2 (NAFNet widths 32 and 48), B11 (D above 128, heads of 96,
more than 64 band tokens; D of 400 and 512, 129 tokens) and B12 (C of 6, 130, 400, 1816
and 2048) against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs, and the predicates that send a window
to B4 and B8 or to B13 and B14. Tolerance atol 5e-5 + rtol 1e-4 (f32; the Pallas bodies
use an erf approximation good to 1.5e-7 and other summation orders)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.ops import windows as JW
from freqfusion_tpu.ops.pallas.bandmha import fused_band_mha as j_band_mha
from freqfusion_tpu.ops.pallas.lka import lka_gate as j_lka_gate
from freqfusion_tpu.ops.pallas.nafblock import fused_naf_block as j_fused_naf_block
from freqfusion_tpu.ops.pallas.sgfn import fused_sgfn_tail as j_sgfn_tail
from freqfusion_tpu.ops.pallas.wattn import fused_overlap_attention as j_overlap_attention
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention_qkv as j_wattn_qkv
from freqfusion_tpu_torch.models import dat as tdat
from freqfusion_tpu_torch.models import hat as that
from freqfusion_tpu_torch.ops import windows as TW
from freqfusion_tpu_torch.ops.kernels import bandmha, lka, nafblock, sgfn, wattn
from test_torch_nafblock import _jax_block_params, _port_params

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=1e-4)


def _r(rng, *shape, std=1.0, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (h, w, hs, ws, c, heads, masked): 144 and 576 tokens (HAT's windows 12 and 24, DAT's split
# (6, 24)), heads of 48, 64 and 96
@pytest.mark.parametrize("h,w,hs,ws,c,heads,masked", [
    (24, 24, 12, 12, 96, 2, True), (24, 48, 6, 24, 96, 2, False), (24, 24, 24, 24, 96, 2, False),
    (16, 16, 8, 8, 128, 2, True), (16, 16, 8, 8, 192, 2, False)])
def test_window_attention_qkv_plain_matches_pallas_at_new_shapes(h, w, hs, ws, c, heads,
                                                                masked):
    n = hs * ws
    rng = np.random.default_rng(n + c)
    q, k, v = (_r(rng, 1, h, w, c, std=0.3) for _ in range(3))
    bias = _r(rng, heads, n, n, std=0.3)
    jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if masked else None
    tmask = TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if masked else None
    want = j_wattn_qkv(*_j(q, k, v, bias), jmask, (hs, ws), heads, interpret=True)
    got = wattn.fused_window_attention_qkv(*_t(q, k, v, bias), tmask, (hs, ws), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_window_attention_qkv"] == 0


@pytest.mark.parametrize("c,heads", [(24, 2), (96, 2)])
def test_overlap_attention_plain_matches_pallas_at_window_32(c, heads):
    """HAT's window 32 with overlap 16: 2304 keys a window (heads of 12 and of 48)."""
    ws, ov = 32, 16
    rng = np.random.default_rng(c)
    args = (_r(rng, 1, 32, 64, c, std=0.5), _r(rng, 1, 32, 64, c, std=0.5),
            _r(rng, 1, 32, 64, c, std=0.5), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
            _r(rng, heads, ws * ws, (ws + ov) ** 2, std=0.3))
    got = wattn.fused_overlap_attention(*_t(*args), ws, ov, heads)
    want = j_overlap_attention(*_j(*args), ws, ov, heads, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sgfn_tail_plain_matches_pallas_at_hidden_800():
    """hidden/2 = 400: DAT above 192 channels at expansion 4 (C = 200)."""
    b, h, w, c, hidden = 1, 6, 8, 200, 800
    half = hidden // 2
    rng = np.random.default_rng(7)
    args = (_r(rng, b, h, w, c, std=0.3), _r(rng, b, h, w, c, std=0.3),
            _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.1), _r(rng, c, hidden, std=c ** -0.5),
            _r(rng, hidden, std=0.05), _r(rng, half, std=0.1, mean=1.0), _r(rng, half, std=0.1),
            _r(rng, 3, 3, 1, half, std=1 / 3), _r(rng, half, std=0.1),
            _r(rng, half, c, std=half ** -0.5), _r(rng, c, std=0.05))
    got = sgfn.fused_sgfn_tail(*_t(*args))
    want = j_sgfn_tail(*_j(*args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [32, 48, 36, 44, 100])
def test_naf_block_plain_matches_pallas_at_narrow_widths(c):
    """NAFNet-width32 (and 48): stage A and stage B at C that is not a multiple of 64; and at
    C that is not a multiple of 8 (36, 44, 100), which B2 takes on zero-padded weights."""
    p = _jax_block_params(c, c)
    x = (0.5 * np.random.default_rng(c + 1).standard_normal((1, 12, 16, c))).astype(np.float32)
    jp = dict(ln1_w=p["norm1"]["weight"], ln1_b=p["norm1"]["bias"],
              w1=p["conv1"]["kernel"], b1=p["conv1"]["bias"],
              wdw=p["conv2"]["kernel"], bdw=p["conv2"]["bias"],
              w3=p["conv3"]["kernel"], b3=p["conv3"]["bias"], beta=p["beta"],
              ln2_w=p["norm2"]["weight"], ln2_b=p["norm2"]["bias"],
              w4=p["conv4"]["kernel"], b4=p["conv4"]["bias"],
              w5=p["conv5"]["kernel"], b5=p["conv5"]["bias"], gamma=p["gamma"])
    want = j_fused_naf_block(jnp.asarray(x), jp, p["sca"]["kernel"], p["sca"]["bias"],
                             interpret=True)
    got = nafblock.fused_naf_block(torch.from_numpy(x), _port_params(p, c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stage_a_planes_pad_to_whole_passes():
    """At C = 48 the stage-A weights are laid out at 64 (two passes of 32 gate channels):
    the gate channels' columns keep their values, the padded rows and columns are 0."""
    c, cp = 48, 64
    w1 = torch.from_numpy(_r(np.random.default_rng(3), c, 2 * c))
    planes = nafblock.stage_a_planes(w1)
    assert planes.shape == (cp // 8, cp // 4, 32, 4)
    hi = planes[..., :2]   # hi of (t, g) and (t + 4, g) of each 8 x 8 tile
    dense = hi.reshape(cp // 8, cp // 4, 8, 4, 2).permute(0, 4, 3, 1, 2).reshape(cp, 2 * cp)
    cols = dense.reshape(cp, cp // 32, 2, 32).permute(0, 2, 1, 3).reshape(cp, 2, cp)
    want = torch.zeros(cp, 2, cp)
    want[:c, :, :c] = w1.reshape(c, 2, c)
    torch.testing.assert_close(cols, want, atol=2e-3 * w1.abs().max().item(), rtol=0)
    assert not cols[c:].any() and not cols[:, :, c:].any()


# (b, h, w, t, d, heads): D = 144 and 256, one head of 96, T = 65 at D = 96, and widths that
# the kernel takes zero-padded (D = 100 in heads of 25, D = 6 in heads of 3); then what the
# kernel's wide route takes: D = 400 and 512, T = 65 at D = 128, T = 129 at D = 64
@pytest.mark.parametrize("case", [(1, 2, 4, 9, 144, 4), (1, 2, 2, 9, 256, 4),
                                  (1, 2, 4, 9, 96, 1), (1, 2, 2, 65, 96, 4),
                                  (1, 2, 4, 9, 100, 4), (1, 2, 4, 9, 6, 2),
                                  (1, 2, 2, 9, 400, 4), (1, 2, 2, 9, 512, 4),
                                  (1, 2, 2, 65, 128, 4), (1, 1, 1, 129, 64, 4)])
def test_band_mha_plain_matches_pallas_at_new_widths(case):
    b, h, w, t, d, heads = case
    rng = np.random.default_rng(d + t)
    args = (_r(rng, b, h, w, t, d, std=0.4), _r(rng, d, 3 * d, std=d ** -0.5),
            _r(rng, 3 * d, std=0.1), _r(rng, d, d, std=d ** -0.5), _r(rng, d, std=0.1),
            _r(rng, d, std=0.1, mean=1.0), _r(rng, d, std=0.1))
    want = j_band_mha(*_j(*args), heads, interpret=True)
    got = bandmha.fused_band_mha(*_t(*args), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bandmha.launches["fused_band_mha"] == 0


@pytest.mark.parametrize("d,heads,want", [(64, 4, (64, 16)), (96, 1, (96, 96)),
                                          (100, 4, (112, 28)), (6, 2, (16, 4)),
                                          (144, 4, (144, 36))])
def test_band_mha_pads_to_the_kernels_steps(d, heads, want):
    assert bandmha.padded_widths(d, heads) == want
    dk, _ = want
    assert bandmha.max_tokens(dk) >= (65 if d == 96 else 9)


@pytest.mark.parametrize("shape", [(1, 6, 9, 6), (1, 5, 8, 130), (1, 4, 6, 400),
                                   (1, 32, 48, 1816), (1, 32, 48, 2048)])
def test_lka_plain_matches_pallas_at_any_width(shape):
    b, h, w, c = shape
    rng = np.random.default_rng(c)
    args = (_r(rng, b, h, w, c), _r(rng, 5, 5, c, std=0.2), _r(rng, 21, c, std=0.2),
            _r(rng, 21, c, std=0.2), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.2, mean=1.0),
            _r(rng, c, std=0.1))
    want = j_lka_gate(*_j(*args), block_h=8, interpret=True)
    got = lka.lka_gate(*_t(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert lka.launches["lka_gate"] == 0


@pytest.mark.parametrize("tokens,head_dim,fused", [
    (64, 30, True), (128, 32, True), (192, 16, True), (256, 30, True),
    (144, 30, False), (576, 30, False), (512, 16, False), (32, 8, False),
    (256, 48, False), (64, 33, False)])
def test_window_predicates_send_what_b4_and_b8_refuse_to_b13_and_b14(tokens, head_dim, fused):
    """B4 and B8's attention kernel takes 64 to 256 tokens in steps of 64 and heads up to 32
    wide; DAT sends any other whole-window shape to torch's qkv and B13, a HAB inside the
    JAX gate to B7 + B14 + B10."""
    assert wattn.xqkv_takes(tokens, head_dim) == fused
    assert tdat.dat_is_fused(tokens, head_dim) == fused
    side = int(round(tokens ** 0.5))
    if side * side == tokens and side >= 8:   # a square HAT window
        assert that.hab_is_fused(side, 4 * side, 2 * side, head_dim) == fused
        assert that.hab_keeps_kernels(side, 4 * side, 2 * side)


def test_hab_keeps_its_kernels_only_inside_the_jax_gate():
    assert that.hab_keeps_kernels(12, 24, 48) and that.hab_keeps_kernels(24, 48, 48)
    assert not that.hab_keeps_kernels(15, 225, 225)   # odd H, W: torch CAB and MLP
    assert not that.hab_keeps_kernels(4, 8, 8)        # under 8 px
    assert not that.hab_is_fused(12, 24, 48, 30) and that.hab_is_fused(16, 32, 48, 30)
