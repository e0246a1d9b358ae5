"""Port parity: the plain versions of HAT's five kernels (CAB chain, fused HAB block,
overlapping cross-attention, residual + LayerNorm + MLP, standalone window attention)
against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs. Tolerance atol 5e-5 rtol 1e-4 (f32; the
Pallas bodies use an erf approximation good to 1.5e-7 and other summation orders); the
channel sums add a whole image, atol 2e-3 as in the JAX package's own test."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.ops import windows as JW
from freqfusion_tpu.ops.pallas.cab import cab_chain as j_cab_chain
from freqfusion_tpu.ops.pallas.wattn import fused_hab_block as j_hab_block
from freqfusion_tpu.ops.pallas.wattn import fused_overlap_attention as j_overlap_attention
from freqfusion_tpu.ops.pallas.wattn import fused_residual_ln_mlp as j_residual_ln_mlp
from freqfusion_tpu.ops.pallas.wattn import fused_window_attention as j_window_attention
from freqfusion_tpu_torch.ops import windows as TW
from freqfusion_tpu_torch.ops.kernels import cab, wattn

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _r(rng, *shape, std=1.0, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("b,h,w,c,mid,shift", [
    (2, 24, 32, 12, 4, 0), (1, 6, 16, 8, 4, 0), (2, 16, 24, 24, 8, 0),
    (1, 24, 32, 12, 4, 4), (1, 18, 24, 8, 4, 3)])
def test_cab_chain_plain_matches_pallas(b, h, w, c, mid, shift):
    rng = np.random.default_rng(c + shift)
    args = (_r(rng, b, h, w, c, std=0.5), _r(rng, c, std=0.1, mean=1.0), _r(rng, c, std=0.05),
            _r(rng, 3, 3, c, mid, std=0.3 / c ** 0.5), _r(rng, mid, std=0.1),
            _r(rng, 3, 3, mid, c, std=0.3 / mid ** 0.5), _r(rng, c, std=0.1))
    u, sums = cab.cab_chain(*_t(*args), out_shift=shift)
    want_u, want_s = j_cab_chain(*_j(*args), interpret=True, out_shift=shift)
    assert u.shape == (b, h, w, c) and sums.shape == (b, 1, 1, c)
    np.testing.assert_allclose(u.numpy(), np.asarray(want_u), **TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_s), atol=2e-3, rtol=1e-4)
    # the roll is of the stored image only: the sums are those of the un-rolled u
    u0, sums0 = cab.cab_chain_plain(*_t(*args))
    np.testing.assert_array_equal(torch.roll(u0, (-shift, -shift), (1, 2)).numpy(), u.numpy())
    np.testing.assert_array_equal(sums0.numpy(), sums.numpy())
    # the wrapper on a CPU tensor is the plain version, and counts no launch
    assert cab.launches == {"cab_chain": 0}


def _hab_args(rng, b, h, w, c, nh, window, hidden):
    n = window * window
    return dict(
        x=_r(rng, b, h, w, c, std=0.3), conv_x=_r(rng, b, h, w, c, std=2.0),
        ln1_w=_r(rng, c, std=0.1, mean=1.0), ln1_b=_r(rng, c, std=0.1),
        ln2_w=_r(rng, c, std=0.1, mean=1.0), ln2_b=_r(rng, c, std=0.1),
        wqkv=_r(rng, c, 3 * c, std=c ** -0.5), bqkv=_r(rng, 3 * c, std=0.02),
        wproj=_r(rng, c, c, std=c ** -0.5), bproj=_r(rng, c, std=0.02),
        w1=_r(rng, c, hidden, std=c ** -0.5), b1=_r(rng, hidden, std=0.02),
        w2=_r(rng, hidden, c, std=hidden ** -0.5), b2=_r(rng, c, std=0.02),
        bias=_r(rng, nh, n, n, std=0.1))


@pytest.mark.parametrize("case", ["unshifted", "shifted", "in_shift", "cab_scale",
                                  "in_shift_cab_scale"])
def test_fused_hab_block_plain_matches_pallas(case):
    b, h, w, c, nh, window = 2, 16, 24, 24, 4, 8
    rng = np.random.default_rng(len(case))
    d = _hab_args(rng, b, h, w, c, nh, window, 2 * c)
    shift = 0 if case in ("unshifted", "cab_scale") else window // 2
    in_shift = shift if case.startswith("in_shift") else 0
    scale = _r(rng, b, 1, 1, c, std=0.2, mean=0.5) if "cab_scale" in case else None
    jmask = JW.shift_attn_mask(h, w, window, window, shift, shift) if shift else None
    tmask = None
    if shift:   # the 4 window types as the model keeps them, or the whole numpy mask
        tmask = (torch.from_numpy(np.array(TW.shift_mask_types(window, window, shift, shift)))
                 if in_shift else TW.shift_attn_mask(h, w, window, window, shift, shift))
    x = d["x"]
    if shift and not in_shift:   # the caller rolls x
        x = np.roll(x, (-shift, -shift), axis=(1, 2))
    order = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wqkv", "bqkv", "wproj", "bproj", "w1", "b1",
             "w2", "b2", "bias")
    weights = [d[k] for k in order]
    want = j_hab_block(*_j(x, d["conv_x"], *weights), jmask, (window, window), nh, 0.01,
                       cab_scale=None if scale is None else jnp.asarray(scale),
                       interpret=True, in_shift=in_shift)
    got = wattn.fused_hab_block(*_t(x, d["conv_x"], *weights), tmask, (window, window), nh,
                                0.01, cab_scale=None if scale is None else torch.from_numpy(scale),
                                in_shift=in_shift)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_hab_block"] == 0


def test_fused_hab_block_in_shift_asserts_what_the_jax_kernel_asserts():
    d = _hab_args(np.random.default_rng(0), 1, 16, 16, 24, 4, 8, 48)
    order = ("x", "conv_x", "ln1_w", "ln1_b", "ln2_w", "ln2_b", "wqkv", "bqkv", "wproj",
             "bproj", "w1", "b1", "w2", "b2", "bias")
    args = _t(*[d[k] for k in order])
    types = torch.from_numpy(np.array(TW.shift_mask_types(8, 8, 4, 4)))
    with pytest.raises(ValueError, match="needs a shift mask"):
        wattn.fused_hab_block(*args, None, (8, 8), 4, 0.01, in_shift=4)
    with pytest.raises(ValueError, match="twice the shift"):
        wattn.fused_hab_block(*args, types, (8, 8), 4, 0.01, in_shift=2)


@pytest.mark.parametrize("b,h,w,c,nh,ws", [(1, 16, 24, 12, 2, 8), (2, 16, 16, 24, 4, 8),
                                           (1, 8, 12, 8, 2, 4)])
def test_fused_overlap_attention_plain_matches_pallas(b, h, w, c, nh, ws):
    ov = ws // 2
    ows = ws + ov
    rng = np.random.default_rng(h + w)
    args = (_r(rng, b, h, w, c, std=0.5), _r(rng, b, h, w, c, std=0.5),
            _r(rng, b, h, w, c, std=0.5), _r(rng, c, c, std=c ** -0.5), _r(rng, c, std=0.02),
            _r(rng, nh, ws * ws, ows * ows, std=0.3))
    got = wattn.fused_overlap_attention(*_t(*args), ws, ov, nh)
    want = j_overlap_attention(*_j(*args), ws, ov, nh, interpret=True)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_overlap_attention"] == 0


def test_overlap_attention_padded_keys_take_part_in_the_softmax():
    """A key outside the image has k = v = 0: it scores its bias alone and is not masked,
    so a large bias on the padded keys of a corner window draws weight from the real ones."""
    b, h, w, c, nh, ws, ov = 1, 8, 8, 8, 2, 4, 2
    rng = np.random.default_rng(9)
    q, k, v = (_r(rng, b, h, w, c, std=0.5) for _ in range(3))
    wproj, bproj = np.eye(c, dtype=np.float32), np.zeros(c, np.float32)
    bias = np.zeros((nh, ws * ws, (ws + ov) ** 2), np.float32)
    base = wattn.fused_overlap_attention_plain(*_t(q, k, v, wproj, bproj, bias), ws, ov, nh)
    bias[:, :, 0] = 20.0   # the top-left key of every window: padded in window (0, 0) only
    got = wattn.fused_overlap_attention_plain(*_t(q, k, v, wproj, bproj, bias), ws, ov, nh)
    assert got[0, :ws, :ws].abs().max() < 1e-6 * base[0, :ws, :ws].abs().max() + 1e-6
    assert got[0, ws:, ws:].abs().max() > 0.01


@pytest.mark.parametrize("shape,hidden", [((2, 12, 20, 36), 72), ((2, 37, 45, 12), 24),
                                          ((1, 8, 8, 24), 48)])
def test_fused_residual_ln_mlp_plain_matches_pallas(shape, hidden):
    c = shape[-1]
    rng = np.random.default_rng(c)
    args = (_r(rng, *shape, std=0.3), _r(rng, *shape, std=0.3), _r(rng, c, std=0.1, mean=1.0),
            _r(rng, c, std=0.1), _r(rng, c, hidden, std=c ** -0.5), _r(rng, hidden, std=0.02),
            _r(rng, hidden, c, std=hidden ** -0.5), _r(rng, c, std=0.02))
    got = wattn.fused_residual_ln_mlp(*_t(*args))
    want = j_residual_ln_mlp(*_j(*args), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_residual_ln_mlp"] == 0


@pytest.mark.parametrize("b,h,w,c,nh,window,with_mask", [
    (2, 16, 24, 36, 6, 8, False),    # no mask
    (1, 32, 16, 24, 4, 8, True),     # the shift mask, as the whole image's numpy mask
    (1, 32, 8, 16, 2, 8, False),     # 4 rows of windows: the Pallas kernel stacks them (gh)
    (2, 27, 18, 24, 4, 9, True),     # odd H, 81 tokens, the mask as its 4 window types
])
def test_window_attention_plain_matches_pallas(b, h, w, c, nh, window, with_mask):
    n = window * window
    rng = np.random.default_rng(h + w + c)
    args = (_r(rng, b, h, w, c, std=0.3), _r(rng, c, 3 * c, std=0.05), _r(rng, 3 * c, std=0.02),
            _r(rng, c, c, std=0.05), _r(rng, c, std=0.02), _r(rng, nh, n, n, std=0.1))
    jmask = tmask = None
    if with_mask:
        s = window // 2
        jmask = JW.shift_attn_mask(h, w, window, window, s, s)
        tmask = (torch.from_numpy(np.array(TW.shift_mask_types(window, window, s, s)))
                 if window == 9 else TW.shift_attn_mask(h, w, window, window, s, s))
    want = j_window_attention(*_j(*args), jmask, (window, window), nh, interpret=True)
    got = wattn.fused_window_attention(*_t(*args), tmask, (window, window), nh)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert wattn.launches["fused_window_attention"] == 0


def test_padded_weights_keep_the_products():
    """The zero-padding the kernels' wrappers apply (K and N to 8s for the tensor-core
    products, heads to 32-wide slots) leaves every product as it was."""
    rng = np.random.default_rng(4)
    c, hid, mid, nh = 180, 360, 60, 6
    w1, b1, w2 = _t(_r(rng, c, hid), _r(rng, hid), _r(rng, hid, c))
    kp, npad, k2p, w1p, w2p = wattn._mlp_padded_weights(c, w1, w2)
    assert (kp, npad, k2p) == (184, 184, 360)
    assert w1p.shape == (kp, k2p) and w2p.shape == (k2p, npad)
    x = torch.from_numpy(_r(rng, 5, c))
    xp = torch.nn.functional.pad(x, (0, kp - c))
    np.testing.assert_allclose((xp @ w1p)[:, :hid].numpy(), (x @ w1).numpy(), atol=1e-5)
    assert not (xp @ w1p)[:, hid:].any()
    hp = torch.nn.functional.pad(torch.from_numpy(_r(rng, 5, hid)), (0, k2p - hid))
    np.testing.assert_allclose((hp @ w2p)[:, :c].numpy(), (hp[:, :hid] @ w2).numpy(), atol=1e-5)
    cw1, cb1, cw2, cb2 = _t(_r(rng, 3, 3, c, mid), _r(rng, mid), _r(rng, 3, 3, mid, c),
                            _r(rng, c))
    cinp, np1, mp, np2, w1c, b1c, w2c, b2c = cab._padded_weights(cw1, cb1, cw2, cb2)
    assert (cinp, np1, mp, np2) == (184, 64, 64, 184)
    assert w1c.shape == (9, 184, 64) and w2c.shape == (9, 64, 184)
    np.testing.assert_array_equal(w1c[:, :c, :mid].numpy(), cw1.reshape(9, c, mid).numpy())
    np.testing.assert_array_equal(w2c[:, :mid, :c].numpy(), cw2.reshape(9, mid, c).numpy())
    assert not w1c[:, c:].any() and not w1c[:, :, mid:].any() and not b1c[mid:].any()
    assert not w2c[:, mid:].any() and not w2c[:, :, c:].any() and not b2c[c:].any()
    wqkv, bqkv = _t(_r(rng, c, 3 * c), _r(rng, 3 * c))
    hd = c // nh
    for slots in (4, 3):   # B4's q | k | v | zeros, B8's q | k | v
        wh, bh = wattn._padded_head_weights(wqkv, bqkv, nh, hd, kp, slots=slots)
        assert wh.shape == (nh, kp, 32 * slots) and bh.shape == (nh, 32 * slots)
        for head in (0, 5):
            for sec in range(3):
                cols = slice(sec * c + head * hd, sec * c + (head + 1) * hd)
                np.testing.assert_array_equal(wh[head, :c, 32 * sec:32 * sec + hd].numpy(),
                                              wqkv[:, cols].numpy())
                np.testing.assert_array_equal(bh[head, 32 * sec:32 * sec + hd].numpy(),
                                              bqkv[cols].numpy())
