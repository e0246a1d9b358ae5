"""Port parity: freqfusion_tpu_torch's HAT against the JAX HAT (CPU, f32, XLA path) through
``hat_params_from_flax`` from the three JAX parameter layouts, the state-dict keys against
the JAX package's key function, uint8 serving through InferencePipeline, and the gates that
decide which kernels a CUDA tensor would run."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from freqfusion_tpu.models.hat import HAT as JHAT
from freqfusion_tpu.utils.convert import Stacked, fill_params, filter_unused, hat_key_fn
from freqfusion_tpu_torch.infer.io import InferencePipeline
from freqfusion_tpu_torch.models import hat as that
from freqfusion_tpu_torch.models.hat import HAT
from freqfusion_tpu_torch.utils.convert import hat_key, hat_params_from_flax

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=1e-4)

# two groups; window 4 runs the unfused torch chain, as the JAX XLA path does
SMALL = dict(upscale=4, embed_dim=24, num_heads=(4, 4), window=4, compress=3, squeeze=6,
             conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16)
# name -> (depths, FREQFUSION_SCAN for the JAX HAT, stack axes of a block's leaves)
LAYOUTS = {"unrolled": ((3, 3), False, 0), "group_scanned": ((3, 3), True, 1),
           "pair_scanned": ((4, 4), True, 2)}
# window 8: the port's HABs go through the cab_chain and fused_hab_block wrappers
WIN8 = dict(SMALL, window=8, embed_dim=24)


class _scan:
    """Sets FREQFUSION_SCAN for the JAX HAT inside the block, and restores it after."""

    def __init__(self, on: bool):
        self.value = "1" if on else "0"

    def __enter__(self):
        self.old = os.environ.get("FREQFUSION_SCAN")
        os.environ["FREQFUSION_SCAN"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["FREQFUSION_SCAN"]
        else:
            os.environ["FREQFUSION_SCAN"] = self.old


@functools.lru_cache(maxsize=None)
def small_pair(layout: str, win8: bool = False, seed: int = 0, **override):
    """A small JAX HAT in one of the three parameter layouts with every parameter random
    (bias tables, LN affines and biases included, so nothing is an identity), and the
    port's HAT holding the same weights. The parameters are drawn with numpy over the
    shapes of `init` (tracing only). `override` replaces entries of the small config."""
    depths, scan, naxes = LAYOUTS[layout]
    cfg = dict(WIN8 if win8 else SMALL, depths=depths, **override)
    jm = JHAT(**cfg)
    side = 2 * cfg["window"]
    with _scan(scan):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        shape = leaf.shape
        stack = (path[0] == "layers") + ("pairs" in path)
        own = shape[stack:]
        if path[-1].endswith("kernel"):
            a = rng.standard_normal(shape) * float(np.prod(own[:-1])) ** -0.5
        elif path[-1] == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif path[-1] == "relative_position_bias_table":
            a = 0.5 * rng.standard_normal(shape)
        else:   # biases
            a = 0.1 * rng.standard_normal(shape)
        flat[path] = a.astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    tm = HAT(**cfg).eval()
    tm.load_state_dict(hat_params_from_flax(params), strict=True)
    return jm, params, tm, scan


def _jax_forward(jm, params, scan, lr):
    with _scan(scan):
        return jax.jit(jm.apply)({"params": params}, jnp.asarray(lr))


@pytest.mark.parametrize("hw", [(8, 8), (12, 8)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_small_hat_matches_jax(layout, hw):
    jm, params, tm, scan = small_pair(layout)
    depths, _, naxes = LAYOUTS[layout]
    blk = params["layers"] if scan else params["layers_0"]
    leaf = (blk["pairs"]["blk0"] if naxes == 2 else blk["blocks_0"])["norm1"]["scale"]
    assert leaf.ndim == 1 + naxes
    h, w = hw
    lr = np.random.default_rng(1).uniform(size=(2, h, w, 3)).astype(np.float32)
    want_sr, want_deep = _jax_forward(jm, params, scan, lr)
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    assert sr.shape == (2, 4 * h, 4 * w, 3) and deep.shape == (2, h, w, 24)
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


@pytest.mark.parametrize("layout", ["group_scanned", "pair_scanned"])
def test_small_hat_through_the_fused_wrappers_matches_jax(layout, monkeypatch):
    """Window 8 and even sides: every HAB of the port goes through cab_chain (rolled at the
    store in shifted blocks) and fused_hab_block (in_shift in shifted blocks), as serving
    does, where the JAX XLA path rolls, attends and un-rolls."""
    jm, params, tm, scan = small_pair(layout, win8=True)
    calls = []
    real_chain, real_block = that.cab_chain, that.fused_hab_block
    monkeypatch.setattr(that, "cab_chain", lambda *a, **k: calls.append(
        ("cab", k["out_shift"])) or real_chain(*a, **k))
    monkeypatch.setattr(that, "fused_hab_block", lambda *a, **k: calls.append(
        ("hab", k["in_shift"], k["cab_scale"] is not None)) or real_block(*a, **k))
    lr = np.random.default_rng(2).uniform(size=(1, 16, 24, 3)).astype(np.float32)
    want_sr, want_deep = _jax_forward(jm, params, scan, lr)
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    depth = LAYOUTS[layout][0][0]
    per_group = [c for j in range(depth) for c in (("cab", 4 * (j % 2)),
                                                   ("hab", 4 * (j % 2), True))]
    assert calls == per_group * 2
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


@pytest.mark.parametrize("window,ratio,hw", [(9, 0.5, (27, 27)), (15, 0.4, (30, 45))])
def test_small_hat_with_an_odd_window_matches_jax(window, ratio, hw, monkeypatch):
    """An odd window makes H and W odd: every HAB fails the fused gate and runs in torch
    around the standalone window attention (its wrapper, shifted blocks with the mask
    types), the OCAB outside its gate in torch. Window 15 with overlap_ratio 0.4 (a 6-px
    overlap) is the topology that the chip check runs at HAT-L's width."""
    jm, params, tm, scan = small_pair("group_scanned", window=window, overlap_ratio=ratio)
    calls = []
    real = that.fused_window_attention
    monkeypatch.setattr(that, "fused_window_attention", lambda *a: calls.append(
        (a[6] is not None, a[7])) or real(*a))
    h, w = hw
    lr = np.random.default_rng(window).uniform(size=(2, h, w, 3)).astype(np.float32)
    want_sr, want_deep = _jax_forward(jm, params, scan, lr)
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    assert calls == [(j % 2 == 1, (window, window)) for j in range(3)] * 2
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


def test_plain_path_equals_wrapper_path_on_cpu():
    """`kernels = False` (what the chip check compares with on the card) runs the same
    plain versions the wrappers take on CPU tensors."""
    _, _, tm, _ = small_pair("group_scanned", win8=True)
    lr = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 16, 16, 3)).astype(np.float32))
    with torch.inference_mode():
        sr, deep = tm(lr)
        flagged = [m for m in tm.modules() if hasattr(m, "kernels")]
        for m in flagged:
            m.kernels = False
        sr_plain, deep_plain = tm(lr)
        for m in flagged:
            m.kernels = True
    # every HAB, every OCAB and every SeamConv carry the switch
    assert len(flagged) == 6 + 2 + 3
    np.testing.assert_array_equal(sr_plain.numpy(), sr.numpy())
    np.testing.assert_array_equal(deep_plain.numpy(), deep.numpy())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_converter_round_trip(layout):
    """port state_dict -> JAX fill_params(hat_key_fn) -> hat_params_from_flax gives the
    same arrays back, with no key missing and none unused."""
    _, params, tm, _ = small_pair(layout)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    filled, report = fill_params(params, sd, hat_key_fn, strict=True)
    assert not report["missing"]
    assert not filter_unused(report["unused"])
    back = hat_params_from_flax(filled)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("scan", [True, False], ids=["pair_scanned", "unrolled"])
def test_full_width_key_set_matches_hat_key_fn(scan):
    """HAT-L of the port has exactly the keys and sizes that the JAX package's converter
    expects of a reference checkpoint, from either JAX layout; the port's own copy of the
    key mapping agrees with the JAX package's."""
    with _scan(scan):
        shapes = jax.eval_shape(JHAT().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
    expected = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        key = hat_key_fn(path)
        if isinstance(key, Stacked):
            assert key.naxes == 2 or "pairs" not in path
            for k in key.keys(leaf.shape):
                expected[k] = leaf.shape[key.naxes:]
        else:
            expected[key] = leaf.shape
            assert hat_key(path) == key
    with torch.device("meta"):
        sd = HAT().state_dict()
    assert set(sd) == set(expected)
    for k, v in sd.items():
        assert int(np.prod(v.shape)) == int(np.prod(expected[k])), k
    assert "layers.11.residual_group.blocks.5.conv_block.cab.3.attention.3.weight" in sd
    assert "layers.0.residual_group.overlap_attn.relative_position_bias_table" in sd
    assert sd["layers.3.residual_group.blocks.1.attn.relative_position_bias_table"].shape == (961, 6)
    assert "patch_embed.norm.weight" in sd and "upsample.2.bias" in sd and "layers.7.conv.weight" in sd
    assert sum(v.numel() for v in sd.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


def test_u8_serving_matches_jax():
    jm, params, tm, scan = small_pair("pair_scanned")
    pipe = InferencePipeline(tm, "cpu")
    rng = np.random.default_rng(5)
    lrs = [rng.uniform(size=s).astype(np.float32) for s in ((70, 80, 3), (66, 90, 3))]
    pending, outs = None, []
    for lr in lrs:   # dispatch image i+1 before materialising image i
        handle = pipe.dispatch_batch_u8([lr])
        if pending is not None:
            outs.append(pipe.materialize_u8(pending)[0])
        pending = handle
    outs.append(pipe.materialize_u8(pending)[0])
    for lr, got in zip(lrs, outs):
        h, w, _ = lr.shape
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
        lrp = np.pad(lr, [(0, 96 - h), (0, 96 - w), (0, 0)], mode="reflect")
        sr, _ = _jax_forward(jm, params, scan, lrp[None])
        want = np.round(np.clip(np.asarray(sr)[0, :4 * h, :4 * w], 0, 1) * 255)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("window,h,w,fused", [(16, 352, 512, True), (8, 16, 24, True),
                                              (4, 8, 8, False), (7, 21, 14, False),
                                              (9, 27, 18, False)])
def test_hab_gate_picks_the_fused_block_or_the_standalone_attention(window, h, w, fused, monkeypatch):
    """The fused HAB path needs a window of 8 px or more and even H, W. Any other shape
    runs the block in torch around the standalone window attention's wrapper, which takes
    any window (nothing raises for a shape any more); either way `kernels = False` takes
    the plain version."""
    assert that.hab_is_fused(window, h, w, 4) == fused   # the block below: heads of 4
    hs, ws = 2 * window, window   # a small image of the same gate: parity follows the window
    assert that.hab_is_fused(window, hs, ws, 4) == fused
    calls = []
    for name in ("fused_hab_block", "fused_window_attention", "fused_window_attention_plain"):
        monkeypatch.setattr(that, name, lambda *a, _n=name, _f=getattr(that, name), **k: (
            calls.append(_n), _f(*a, **k))[1])
    blk = that.HAB(8, 2, window, window // 2, 2, 2, 0.01, 2.0).eval()
    x = torch.from_numpy(np.random.default_rng(window).standard_normal(
        (1, hs, ws, 8)).astype(np.float32))
    with torch.inference_mode():
        out = blk(x)
        assert calls == ["fused_hab_block" if fused else "fused_window_attention"]
        blk.kernels = False
        plain = blk(x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    np.testing.assert_array_equal(out.numpy(), plain.numpy())   # CPU: the plain versions


def test_ocab_gate_and_bucket_shapes():
    assert that.ocab_is_fused(16, 8) and that.ocab_is_fused(32, 16)
    assert not that.ocab_is_fused(8, 4) and not that.ocab_is_fused(16, 4)
    tm = HAT(embed_dim=24, depths=(1,), num_heads=(4,), window=4, squeeze=6, num_feat=8)
    with pytest.raises(ValueError, match="multiple of the 4-px window"):
        tm(torch.zeros(1, 8, 10, 3))
