"""Port parity: the plain versions of DAT's five kernels (window attention with fused qkv
and from pre-projected q, k, v, the two AIM kernels, the SGFN tail) against the JAX package
on the same numpy inputs, and a small DAT at the shapes that choose between them: the
Pallas kernels in interpret mode, and for AIM also the XLA branches of models/dat.py.
Tolerance atol 5e-5 rtol 1e-4 (f32; the Pallas bodies use an erf approximation good to
1.5e-7 and other summation orders)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.models.layers import apply_ln
from freqfusion_tpu.ops import windows as JW
from freqfusion_tpu.ops.pallas import aim as jaim
from freqfusion_tpu.ops.pallas.sgfn import fused_sgfn_tail as j_sgfn_tail
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention_qkv as j_wattn_qkv
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention_xqkv as j_wattn_xqkv
from freqfusion_tpu_torch.ops import windows as TW
from freqfusion_tpu_torch.ops.kernels import aim, sgfn, wattn

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("hs,ws,with_mask", [(2, 8, True), (8, 2, False), (8, 2, True),
                                             (2, 8, False), (8, 8, True)])
def test_window_attention_xqkv_plain_matches_pallas(hs, ws, with_mask):
    b, h, w, cin, co, nh = 2, 16, 16, 24, 12, 2
    n = hs * ws
    rng = np.random.default_rng(hs * 100 + ws + with_mask)
    x = (0.3 * rng.standard_normal((b, h, w, cin))).astype(np.float32)
    wqkv = (0.05 * rng.standard_normal((cin, 3 * co))).astype(np.float32)
    bqkv = (0.02 * rng.standard_normal(3 * co)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((nh, n, n))).astype(np.float32)
    mask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if with_mask else None
    want = j_wattn_xqkv(*_j(x, wqkv, bqkv, bias), mask, (hs, ws), nh, interpret=True)
    tmask = TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if with_mask else None
    got = wattn.fused_window_attention_xqkv(*_t(x, wqkv, bqkv, bias), tmask, (hs, ws), nh)
    assert got.shape == (b, h, w, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the wrapper on a CPU tensor is the plain version, and counts no launch
    assert wattn.launches["fused_window_attention_xqkv"] == 0
    q, k, v = (torch.from_numpy(x) @ torch.from_numpy(wqkv) + torch.from_numpy(bqkv)).chunk(3, -1)
    np.testing.assert_allclose(
        wattn.fused_window_attention_qkv_plain(q, k, v, torch.from_numpy(bias), tmask, (hs, ws),
                                     nh).numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("hs,ws,with_mask", [(2, 8, True), (8, 2, True), (8, 2, False),
                                             (4, 16, True), (3, 5, True)])
def test_window_attention_qkv_plain_matches_pallas(hs, ws, with_mask):
    """Pre-projected q, k, v in rectangular windows; (3, 5) is a token count no kernel tile
    divides. The mask goes in as the whole image's numpy mask or as its 4 window types."""
    b, c, nh = 2, 12, 2
    h, w, n = 2 * hs * (2 if hs < 4 else 1), 2 * ws, hs * ws
    rng = np.random.default_rng(hs * 10 + ws + with_mask)
    q, k, v = ((0.3 * rng.standard_normal((b, h, w, c))).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.standard_normal((nh, n, n))).astype(np.float32)
    jmask = tmask = None
    if with_mask:
        jmask = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
        tmask = (torch.from_numpy(np.array(TW.shift_mask_types(hs, ws, hs // 2, ws // 2)))
                 if hs == 4 else TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2))
    want = j_wattn_qkv(*_j(q, k, v, bias), jmask, (hs, ws), nh, interpret=True)
    got = wattn.fused_window_attention_qkv(*_t(q, k, v, bias), tmask, (hs, ws), nh)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_window_attention_qkv"] == 0


def test_zero_padded_keys_take_part_in_the_softmax():
    """q, k, v padded with zeros after their projection: a padded key is not masked, it
    scores its bias and draws weight from the real keys, as in the JAX kernel."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 8, 4)).astype(np.float32))
               for _ in range(3))
    k[:, :, 6:], v[:, :, 6:] = 0.0, 0.0   # the last two columns are padding
    bias = torch.zeros(1, 32, 32)
    base = wattn.fused_window_attention_qkv_plain(q, k, v, bias, None, (4, 8), 1)
    bias[:, :, [6, 7, 14, 15, 22, 23, 30, 31]] = 20.0   # the padded keys
    got = wattn.fused_window_attention_qkv_plain(q, k, v, bias, None, (4, 8), 1)
    assert got.abs().max() < 1e-6 and base.abs().max() > 0.01


@pytest.mark.parametrize("case", ["ragged", "small_windows"])
def test_small_dat_takes_the_attention_its_shape_asks_for(case, monkeypatch):
    """A ragged image in 64-token windows projects q, k, v, pads them and goes through the
    pre-projected wrapper (two branches of two spatial blocks, one shifted), and so do
    windows of 8 tokens, under the in-kernel projection's size, whatever the shape. Both
    equal the JAX DAT, which attends in plain XLA at such windows."""
    from freqfusion_tpu_torch.models import dat as tdat
    from test_torch_dat import small_pair
    jm, params, tm = small_pair(True, fused=case == "ragged")
    h, w = (20, 24) if case == "ragged" else (8, 8)
    lr = np.random.default_rng(11).uniform(size=(2, h, w, 3)).astype(np.float32)
    want_sr, want_deep = jax.jit(jm.apply)({"params": params}, jnp.asarray(lr))
    calls = []
    for name in ("fused_window_attention_qkv", "fused_window_attention_xqkv"):
        monkeypatch.setattr(tdat, name, lambda *a, _n=name, _f=getattr(tdat, name): (
            calls.append((_n, tuple(a[0].shape[1:3]), a[4] is not None)), _f(*a))[1])
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    if case == "ragged":   # q, k, v padded to whole 16-px windows: 32 x 32
        assert sorted(calls) == [("fused_window_attention_qkv", (32, 32), m)
                                 for m in (False, False, True, True)]
    else:   # four spatial blocks of two branches, half of them shifted
        assert sorted(calls) == [("fused_window_attention_qkv", (8, 8), m)
                                 for m in (False,) * 4 + (True,) * 4]
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), atol=5e-5, rtol=1e-4)


def test_mask_types_are_checked_to_be_exhaustive():
    mask = np.array(TW.shift_attn_mask(16, 16, 2, 8, 1, 4))
    types = wattn.mask_types(mask, 8, 2, "cpu")
    assert types.shape == (4, 16, 16)
    np.testing.assert_array_equal(types[3].numpy(), mask[-1])
    bad = mask.copy()
    bad[1, 0, 1] = -100.0 if bad[1, 0, 1] == 0 else 0.0
    with pytest.raises(ValueError, match="window type"):
        wattn.mask_types(bad, 8, 2, "cpu")
    with pytest.raises(ValueError, match="expected shape"):
        wattn.mask_types(mask, 4, 2, "cpu")


@pytest.mark.parametrize("h,w,hs,ws", [(16, 16, 2, 8), (8, 32, 8, 2), (12, 4, 4, 4)])
def test_shift_mask_types_are_those_of_any_image(h, w, hs, ws):
    """The 4 window types taken from a 2 x 2-window mask equal those found in the whole
    image's mask (one row or one column of windows included), and the attention takes
    either form."""
    sh, sw = hs // 2, ws // 2
    full = TW.shift_attn_mask(h, w, hs, ws, sh, sw)
    types = torch.from_numpy(np.array(TW.shift_mask_types(hs, ws, sh, sw)))
    assert types.shape == (4, hs * ws, hs * ws)
    # every window of the image's mask is the type its place gives it (with one row or
    # column of windows some types occur nowhere, so the two [4,N,N] need not be equal)
    per_window = wattn._type_index(h // hs, w // ws, "cpu")
    np.testing.assert_array_equal(types[per_window].numpy(), full)
    np.testing.assert_array_equal(
        wattn.mask_types(full, h // hs, w // ws, "cpu")[per_window].numpy(), full)
    assert wattn.mask_types(types, h // hs, w // ws, "cpu") is types
    rng = np.random.default_rng(h + w)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, w, 8)).astype(np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((2, hs * ws, hs * ws)).astype(np.float32))
    np.testing.assert_array_equal(
        wattn.fused_window_attention_qkv_plain(q, k, v, bias, types, (hs, ws), 2).numpy(),
        wattn.fused_window_attention_qkv_plain(q, k, v, bias, full, (hs, ws), 2).numpy())
    with pytest.raises(TypeError, match="numpy"):
        wattn.mask_types(torch.zeros(2, hs * ws, hs * ws), h // hs, w // ws, "cpu")


def _aim_inputs(seed, b=2, h=9, w=14, c=32, mid=None):
    rng = np.random.default_rng(seed)
    mid = mid or c // 16

    def r(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)
    return dict(
        att=r(b, h, w, c, std=0.5), v=r(b, h, w, c, std=0.5), chmap=r(b, 1, 1, c),
        wdw=r(3, 3, 1, c, std=1 / 3), bdw=r(c, std=0.1), bn_s=r(c, std=0.2, mean=1.0),
        bn_b=r(c, std=0.1), si_w1=r(1, 1, c, mid, std=c ** -0.5), si_b1=r(mid, std=0.1),
        si_s=r(mid, std=0.2, mean=1.0), si_b=r(mid, std=0.1),
        si_w2=r(1, 1, mid, 1, std=mid ** -0.5), si_b2=r(1, std=0.1),
        proj_w=r(c, c, std=c ** -0.5), proj_b=r(c, std=0.1))


def _xla_conv_branch(v, wdw, bdw, bn_s, bn_b):
    c = v.shape[-1]
    x = jax.lax.conv_general_dilated(v, wdw, (1, 1), [(1, 1), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                     feature_group_count=c) + bdw
    return jax.nn.gelu(x * bn_s + bn_b, approximate=False)


@pytest.mark.parametrize("shape", [(2, 9, 14, 32), (1, 16, 8, 20)])
def test_aim_conv_branch_plain_matches_pallas_and_xla(shape):
    b, h, w, c = shape
    d = _aim_inputs(3, b, h, w, c)
    args = (d["v"], d["wdw"], d["bdw"], d["bn_s"], d["bn_b"])
    cx, sums = aim.aim_conv_branch(*_t(*args))
    jcx, jsums = jaim.aim_conv_branch(*_j(*args), interpret=True)
    assert cx.shape == shape and sums.shape == (b, 1, 1, c)
    np.testing.assert_allclose(cx.numpy(), np.asarray(jcx), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(cx.numpy(), np.asarray(_xla_conv_branch(*_j(*args))), **TOL)
    assert aim.launches == {"aim_conv_branch": 0, "aim_gates_proj": 0}


# (swap, C, S-Map width): DAT-like narrow, then above the 192 channels a row is staged at
# once and above the 12 S-Map sums a lane keeps (the card's kernel takes both in passes)
@pytest.mark.parametrize("swap,c,mid", [
    pytest.param(False, 32, 2, id="False"), pytest.param(True, 32, 2, id="True"),
    pytest.param(False, 256, 16, id="c256-mid16-False"),
    pytest.param(True, 256, 16, id="c256-mid16-True"),
    pytest.param(False, 256, 32, id="c256-mid32-False"),
    pytest.param(True, 256, 32, id="c256-mid32-True")])
def test_aim_gates_proj_plain_matches_pallas_and_xla(swap, c, mid):
    d = _aim_inputs(5 + swap, c=c, mid=mid)
    c = d["att"].shape[-1]
    conv_x = np.asarray(_xla_conv_branch(*_j(d["v"], d["wdw"], d["bdw"], d["bn_s"], d["bn_b"])))
    args = (d["att"], conv_x, d["chmap"], d["si_w1"], d["si_b1"], d["si_s"], d["si_b"],
            d["si_w2"], d["si_b2"], d["proj_w"], d["proj_b"])
    got = aim.aim_gates_proj(*_t(*args), swap=swap)
    assert got.shape == d["att"].shape
    want = jaim.aim_gates_proj(*_j(*args), swap=swap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # the XLA branch of models/dat.py: spatial blocks (swap=False) take the S-Map from the
    # attention branch and gate conv_x with it; channel blocks the other way round
    att, cx, chmap = _j(d["att"], conv_x, d["chmap"])
    src = cx if swap else att
    s = jnp.einsum("bhwc,cd->bhwd", src, d["si_w1"].reshape(c, -1)) + d["si_b1"]
    s = jax.nn.gelu(s * d["si_s"] + d["si_b"], approximate=False)
    s = jnp.einsum("bhwc,cd->bhwd", s, d["si_w2"].reshape(-1, 1)) + d["si_b2"]
    if swap:
        y = att * jax.nn.sigmoid(s) + cx * jax.nn.sigmoid(chmap)
    else:
        y = att * jax.nn.sigmoid(chmap) + cx * jax.nn.sigmoid(s)
    np.testing.assert_allclose(got.numpy(), np.asarray(y @ d["proj_w"] + d["proj_b"]), **TOL)


@pytest.mark.parametrize("shape,hidden", [((2, 16, 24, 20), 40), ((1, 7, 9, 12), 48)])
def test_sgfn_tail_plain_matches_pallas_and_xla(shape, hidden):
    b, h, w, c = shape
    half = hidden // 2
    rng = np.random.default_rng(c)

    def r(*s, std=1.0, mean=0.0):
        return (mean + std * rng.standard_normal(s)).astype(np.float32)
    args = (r(*shape, std=0.3), r(*shape, std=0.3), r(c, std=0.1, mean=1.0), r(c, std=0.1),
            r(c, hidden, std=c ** -0.5), r(hidden, std=0.05), r(half, std=0.1, mean=1.0),
            r(half, std=0.1), r(3, 3, 1, half, std=1 / 3), r(half, std=0.1),
            r(half, c, std=half ** -0.5), r(c, std=0.05))
    got = sgfn.fused_sgfn_tail(*_t(*args))
    want = j_sgfn_tail(*_j(*args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sgfn.launches == {"fused_sgfn_tail": 0}

    # the XLA chain of models/dat.py (DATB tail + SGFN)
    a, s, lnw, lnb, w1, b1, sgw, sgb, wdw, bdw, w2, b2 = _j(*args)
    y = a + s
    x1, x2 = jnp.split(jax.nn.gelu(apply_ln(y, lnw, lnb) @ w1 + b1, approximate=False), 2, -1)
    x2 = jax.lax.conv_general_dilated(
        apply_ln(x2, sgw, sgb), wdw, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=half) + bdw
    np.testing.assert_allclose(got.numpy(), np.asarray(y + (x1 * x2) @ w2 + b2), **TOL)
