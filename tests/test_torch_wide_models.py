"""Port parity of the models at windows and heads that B4 and B8's kernel refuses: a small DAT
with split (6, 24) (144-token windows), whose spatial blocks project q, k, v in torch and take
B13's wrapper, and a small HAT with window 12 and heads of 48, whose HABs take B7 + B14 + B10's
wrappers, each against the JAX module with the same weights (``utils/convert.py``). On the
CPU every wrapper runs its plain version. Then NAFNets of widths 36 and 44, whose NAFBlocks
run B1 and B2 at C that is not a multiple of 8. Tolerance atol 5e-5 + rtol 1e-4."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from freqfusion_tpu.models.dat import DAT as JDAT
from freqfusion_tpu_torch.models import dat as tdat
from freqfusion_tpu_torch.models import hat as that
from freqfusion_tpu_torch.utils.convert import dat_params_from_flax
from test_torch_dat import SMALL, _scan
from test_torch_hat import _jax_forward
from test_torch_hat import small_pair as hat_pair

torch.set_num_threads(2)
TOL = dict(atol=5e-5, rtol=1e-4)


def _dat_pair(cfg, seed=0):
    """A JAX DAT and the port's DAT of config `cfg` holding the same random weights, drawn
    as ``test_torch_dat.small_pair`` draws them (unrolled layout)."""
    jm = JDAT(**cfg)
    with _scan(False):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 24, 24, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        shape = leaf.shape
        if path[-1] == "running_var":
            a = rng.uniform(0.6, 1.4, shape)
        elif path[-1] == "kernel":
            a = rng.standard_normal(shape) * float(np.prod(shape[:-1])) ** -0.5
        elif path[-1] in ("scale", "weight", "temperature"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        flat[path] = a.astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    tm = tdat.DAT(**cfg).eval()
    tm.load_state_dict(dat_params_from_flax(params), strict=True)
    return jm, params, tm


def test_dat_with_144_token_windows_takes_b13_and_matches_jax(monkeypatch):
    """Split (6, 24): 144-token windows, which B4 refuses; every spatial branch projects in
    torch and takes B13's wrapper, shifted blocks with the mask."""
    jm, params, tm = _dat_pair(dict(SMALL, split_size=(6, 24)))
    calls = []
    for name in ("fused_window_attention_qkv", "fused_window_attention_xqkv"):
        monkeypatch.setattr(tdat, name, lambda *a, _n=name, _f=getattr(tdat, name): (
            calls.append((_n, a[5], a[4] is not None)), _f(*a))[1])
    lr = np.random.default_rng(5).uniform(size=(1, 24, 24, 3)).astype(np.float32)
    with _scan(False):
        want_sr, want_deep = jax.jit(jm.apply)({"params": params}, jnp.asarray(lr))
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    # two groups of two spatial blocks (one shifted) of two branches
    assert sorted(calls) == sorted(("fused_window_attention_qkv", win, m)
                                   for win in ((6, 24), (24, 6)) for m in (False, True)
                                   for _ in range(2))
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


def test_hat_with_window_12_and_heads_of_48_takes_b7_b14_b10_and_matches_jax(monkeypatch):
    jm, params, tm, scan = hat_pair("unrolled", window=12, embed_dim=96, num_heads=(2, 2))
    calls = []
    for name in ("cab_chain", "fused_hab_block", "fused_window_attention",
                 "fused_residual_ln_mlp"):
        monkeypatch.setattr(that, name, lambda *a, _n=name, _f=getattr(that, name), **k: (
            calls.append(_n), _f(*a, **k))[1])
    lr = np.random.default_rng(6).uniform(size=(1, 24, 24, 3)).astype(np.float32)
    want_sr, want_deep = _jax_forward(jm, params, scan, lr)
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    # per group 3 HABs of B7, B14 and B10; the OCAB (window 12) is outside B9's gate and
    # runs the plain versions, as the JAX package leaves it to XLA
    assert calls == ["cab_chain", "fused_window_attention", "fused_residual_ln_mlp"] * 6
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


@pytest.mark.parametrize("width", [36, 44])
def test_nafnet_of_width_36_and_44_matches_jax(width):
    """NAFNetSR at widths that are not multiples of 8 (levels of 36, 72, 144 and 44, 88,
    176), against the JAX NAFNetSR with the same weights."""
    from freqfusion_tpu.models.nafnet import NAFNetSR as JNAFNetSR
    from freqfusion_tpu_torch.models.nafnet import NAFNetSR
    from freqfusion_tpu_torch.utils.convert import nafnet_params_from_flax
    cfg = dict(upscale=4, width=width, middle_blk_num=1, enc_blk_nums=(1, 1),
               dec_blk_nums=(1, 1))
    jm = JNAFNetSR(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    rng = np.random.default_rng(width)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    tm = NAFNetSR(**cfg).eval()
    tm.nafnet.load_state_dict(nafnet_params_from_flax(params), strict=True)
    lr = rng.uniform(size=(1, 16, 20, 3)).astype(np.float32)
    want, _ = jm.apply({"params": params}, jnp.asarray(lr))
    with torch.inference_mode():
        got, _ = tm(torch.from_numpy(lr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
