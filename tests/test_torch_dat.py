"""Port parity: freqfusion_tpu_torch's DAT against the JAX DAT (CPU, f32) through
``dat_params_from_flax`` from both JAX parameter layouts, the state-dict keys against the
JAX package's key function, and uint8 serving through InferencePipeline."""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util

from freqfusion_tpu.models.dat import DAT as JDAT
from freqfusion_tpu.utils.convert import Stacked, dat_key_fn, fill_params, filter_unused
from freqfusion_tpu_torch.infer.io import InferencePipeline
from freqfusion_tpu_torch.models.dat import DAT
from freqfusion_tpu_torch.utils.convert import dat_key, dat_params_from_flax

torch.set_num_threads(2)

# two groups (both shift parities), four blocks (spatial/channel alternation, shifted blocks)
SMALL = dict(upscale=4, embed_dim=64, depths=(4, 4), num_heads=(4, 4), split_size=(2, 4),
             expansion=2.0)
# 64-token windows in both orientations, so whole-window images take the branch that hands
# x and the branch's qkv columns to the window-attention wrapper: what serving runs. Group 0
# has an unshifted spatial block and group 1 a shifted one.
FUSED = dict(SMALL, depths=(2, 2), split_size=(4, 16))
TOL = dict(atol=5e-5, rtol=1e-4)


class _scan:
    """Sets FREQFUSION_SCAN for the JAX DAT inside the block, and restores it after."""

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
def small_pair(scan: bool, seed: int = 0, fused: bool = False):
    """A small JAX DAT in the scan-stacked or the unrolled layout with every parameter
    random (BN running statistics, temperature and the position MLP included, so nothing
    is an identity), and the port's DAT holding the same weights. The parameters are
    drawn with numpy over the shapes of `init` (tracing only: running `init` takes longer
    than the rest of the file)."""
    cfg = FUSED if fused else SMALL
    jm = JDAT(**cfg)
    with _scan(scan):
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes["params"]).items():
        shape = leaf.shape
        own = shape[1:] if path[0] == "layers" else shape   # without the scan axis
        if path[-1] == "running_var":
            a = rng.uniform(0.6, 1.4, shape)
        elif path[-1] == "kernel":
            a = rng.standard_normal(shape) * float(np.prod(own[:-1])) ** -0.5
        elif path[-1] in ("scale", "weight", "temperature"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:   # biases, running means
            a = 0.1 * rng.standard_normal(shape)
        flat[path] = a.astype(np.float32)
    params = traverse_util.unflatten_dict(flat)
    tm = DAT(**cfg).eval()
    tm.load_state_dict(dat_params_from_flax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])   # aligned, and one that needs padding
@pytest.mark.parametrize("scan", [True, False], ids=["scan_stacked", "unrolled"])
def test_small_dat_matches_jax(scan, hw):
    jm, params, tm = small_pair(scan)
    assert ("layers" in params) == scan and ("layers_0" in params) != scan
    h, w = hw
    lr = np.random.default_rng(1).uniform(size=(1, h, w, 3)).astype(np.float32)
    with _scan(scan):
        want_sr, want_deep = jax.jit(jm.apply)({"params": params}, jnp.asarray(lr))
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    assert sr.shape == (1, 4 * h, 4 * w, 3) and deep.shape == (1, h, w, 64)
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


@pytest.mark.parametrize("hw", [(16, 32), (32, 16)])
def test_small_dat_in_kernel_qkv_branch_matches_jax(hw, monkeypatch):
    """Whole 64-token windows: the port rolls x, slices each branch's q, k, v columns and
    projects inside the window-attention wrapper (the served path), where the small config
    above projects first."""
    from freqfusion_tpu_torch.models import dat as tdat
    jm, params, tm = small_pair(True, fused=True)
    h, w = hw
    lr = np.random.default_rng(7).uniform(size=(2, h, w, 3)).astype(np.float32)
    want_sr, want_deep = jax.jit(jm.apply)({"params": params}, jnp.asarray(lr))
    calls = []
    real = tdat.fused_window_attention_xqkv
    monkeypatch.setattr(tdat, "fused_window_attention_xqkv",
                        lambda x, *a: calls.append(a[3] is not None) or real(x, *a))
    with torch.inference_mode():
        sr, deep = tm(torch.from_numpy(lr))
    # two spatial blocks of two branches each, one block shifted (with its mask types)
    assert sorted(calls) == [False, False, True, True]
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), **TOL)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), **TOL)


def test_plain_path_equals_wrapper_path_on_cpu():
    """`kernels = False` (what the chip check compares with on the card) runs the same
    plain versions the wrappers take on CPU tensors."""
    _, _, tm = small_pair(True)
    lr = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 8, 16, 3)).astype(np.float32))
    with torch.inference_mode():
        sr, deep = tm(lr)
        flagged = [m for m in tm.modules() if hasattr(m, "kernels")]
        for m in flagged:
            m.kernels = False
        sr_plain, deep_plain = tm(lr)
    # every DATB, both attention kinds and every SeamConv carry the switch
    assert len(flagged) == 8 + 8 + 3
    np.testing.assert_array_equal(sr_plain.numpy(), sr.numpy())
    np.testing.assert_array_equal(deep_plain.numpy(), deep.numpy())


@pytest.mark.parametrize("scan", [True, False], ids=["scan_stacked", "unrolled"])
def test_converter_round_trip(scan):
    """port state_dict -> JAX fill_params(dat_key_fn) -> dat_params_from_flax gives the
    same arrays back, with no key missing and none unused."""
    _, params, tm = small_pair(scan)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    filled, report = fill_params(params, sd, dat_key_fn, strict=True)
    assert not report["missing"]
    assert not filter_unused(report["unused"])
    back = dat_params_from_flax(filled)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("scan", [True, False], ids=["scan_stacked", "unrolled"])
def test_full_width_key_set_matches_dat_key_fn(scan):
    """The shipped DAT config of the port has exactly the keys and sizes that the JAX
    package's converter expects of a reference checkpoint, from either JAX layout; the
    port's own copy of the key mapping agrees with the JAX package's."""
    with _scan(scan):
        shapes = jax.eval_shape(JDAT().init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
    expected = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        key = dat_key_fn(path)
        if isinstance(key, Stacked):
            for gi, k in enumerate(key.keys(leaf.shape)):
                expected[k] = leaf.shape[1:]
                g = int(path[1][1:])
                assert dat_key((f"layers_{2 * gi + g}",) + path[2:]) == k
        else:
            expected[key] = leaf.shape
            assert dat_key(path) == key
    with torch.device("meta"):
        sd = DAT().state_dict()
    own = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert set(own) == set(expected)
    assert len(own) == len(sd) - 3 * 36   # three BatchNorms per block keep a counter
    for k, v in own.items():
        assert int(np.prod(v.shape)) == int(np.prod(expected[k])), k
    assert "layers.5.blocks.4.attn.attns.1.pos.pos3.2.weight" in own
    assert "layers.0.blocks.1.attn.temperature" in own and "upsample.2.bias" in own


def test_u8_serving_matches_jax():
    jm, params, tm = small_pair(True)
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
    apply = jax.jit(jm.apply)
    for lr, got in zip(lrs, outs):
        h, w, _ = lr.shape
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
        lrp = np.pad(lr, [(0, 96 - h), (0, 96 - w), (0, 0)], mode="reflect")
        sr, _ = apply({"params": params}, jnp.asarray(lrp[None]))
        want = np.round(np.clip(np.asarray(sr)[0, :4 * h, :4 * w], 0, 1) * 255)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_pipeline_defaults_to_the_card_and_raises_without_one():
    _, _, tm = small_pair(True)
    if torch.cuda.is_available():
        assert InferencePipeline(tm).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            InferencePipeline(tm)
    assert InferencePipeline(tm, "cpu").device.type == "cpu"
