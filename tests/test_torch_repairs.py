"""Serving and wrapper contracts of freqfusion_tpu_torch on the CPU: the precision that
serving pins around every forward, the bucket plan without a cap, the refusal of a call that
autograd would record, the tolerant checkpoint load and the port's parameter layouts against
the JAX loader's rules, and the zero-padded weight layouts of the tensor-core kernels."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from freqfusion_tpu.models.experts import FreqFusionSR as JFreqFusionSR
from freqfusion_tpu.models.fusion import FusionConfig as JFusionConfig
from freqfusion_tpu.utils import convert as jconvert
from freqfusion_tpu_torch.infer import io as tio
from freqfusion_tpu_torch.infer.io import InferencePipeline
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig
from freqfusion_tpu_torch.ops.kernels import (aim, bandmha, cab, conv3x3, lka, nafblock, sgfn,
                                              wattn)
from freqfusion_tpu_torch.utils.convert import layout_rule
from freqfusion_tpu_torch.utils.imageio import save_image

from test_torch_ensemble import EXPERTS

torch.set_num_threads(2)


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


class _Recorder(torch.nn.Module):
    """x4 nearest upscale that records both TF32 flags at every forward."""
    upscale = 4

    def __init__(self):
        super().__init__()
        self.seen = []

    def forward(self, x):
        self.seen.append(_flags())
        return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=4).permute(0, 2, 3, 1)


@pytest.fixture
def caller_flags():
    """The caller's flags set to what neither precision sets, and restored afterwards."""
    old = _flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield True, False
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("precision,tf32", [("highest", False), ("high", True)])
@pytest.mark.parametrize("path", ["whole", "tiled"])
def test_pipeline_pins_precision_around_every_forward(caller_flags, precision, tf32, path):
    model = _Recorder()
    pipe = InferencePipeline(model, "cpu", tile=32, overlap=8, precision=precision)
    lr = np.random.default_rng(0).uniform(size=(40, 70, 3)).astype(np.float32)
    if path == "whole":
        out = pipe.materialize_u8(pipe.dispatch_batch_u8([lr]))[0]
    else:
        out = pipe.run_tiled_u8(lr)
    assert out.shape == (160, 280, 3)
    assert model.seen and set(model.seen) == {(tf32, tf32)}
    assert _flags() == caller_flags


def test_unknown_precision_raises():
    with pytest.raises(ValueError, match="precision"):
        InferencePipeline(_Recorder(), "cpu", precision="medium")


def test_main_and_cli_pin_precision(tmp_path, monkeypatch, caller_flags):
    """`main` keeps both TF32 flags off inside every forward by default and restores the
    caller's; the CLI's --precision high allows TF32."""
    from freqfusion_tpu_torch.cli import test as cli
    seen = []
    forward = FreqFusionSR.forward

    def recording(self, *a, **k):
        seen.append(_flags())
        return forward(self, *a, **k)

    monkeypatch.setattr(FreqFusionSR, "forward", recording)
    src = tmp_path / "lr"
    rng = np.random.default_rng(1)
    save_image(rng.integers(0, 256, (36, 40, 3), dtype=np.uint8), str(src / "a.png"))
    save_image(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8), str(src / "b.png"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights; b.png takes the tiled path
        assert tio.main(str(tmp_path), str(src), str(tmp_path / "sr"), "cpu",
                        expert_kwargs=EXPERTS, tile=32, overlap=8) == 2
        assert seen and set(seen) == {(False, False)}
        assert _flags() == caller_flags
        seen.clear()
        monkeypatch.setenv("FREQFUSION_MODEL_DIR", str(tmp_path))
        cli.main(["--input", str(src), "--save_dir", str(tmp_path / "res"), "--device", "cpu",
                  "--precision", "high"], expert_kwargs=EXPERTS, tile=32, overlap=8)
    assert seen and set(seen) == {(True, True)}
    assert _flags() == caller_flags


def test_no_bucket_cap_by_default():
    """Eight distinct buckets all plan whole: eager PyTorch compiles nothing per shape. The
    JAX twin's cap (6) comes back only where the attribute sets it."""
    shapes = [(64 + 32 * i, 96 + 32 * i) for i in range(8)]
    port = object.__new__(InferencePipeline)
    assert port.WHOLE_IMAGE_MAX_SHAPES is None
    plans = [port._whole_image_plan(h, w) for h, w in shapes]
    assert plans == shapes and len(set(plans)) == 8
    capped = object.__new__(InferencePipeline)
    capped.WHOLE_IMAGE_MAX_SHAPES = 6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        plans = [capped._whole_image_plan(h, w) for h, w in shapes]
    assert plans[:6] == shapes[:6] and len({p for p in plans if p}) == 6


def _r(rng, *shape, std=1.0, mean=0.0):
    return torch.from_numpy((mean + std * rng.standard_normal(shape)).astype(np.float32))


def _wrapper_calls():
    """(name, fn, args, kwargs) for every wrapper at a small CPU shape; args[0] is the
    tensor made to require grad."""
    rng = np.random.default_rng(0)

    def r(*shape, std=1.0, mean=0.0):
        return _r(rng, *shape, std=std, mean=mean)

    c, b, h, w = 8, 1, 8, 8
    x = r(b, h, w, c)
    mask = torch.from_numpy(np.zeros((4, 16, 16), np.float32))
    hab = [x, r(b, h, w, c), r(c, mean=1.0), r(c), r(c, mean=1.0), r(c), r(c, 3 * c), r(3 * c),
           r(c, c), r(c), r(c, 2 * c), r(2 * c), r(2 * c, c), r(c), r(2, 16, 16)]
    return [
        ("B1", nafblock.naf_block_stage_a, [x, r(c, mean=1.0), r(c), r(c, 2 * c), r(2 * c),
                                            r(9, 2 * c), r(2 * c)], {}),
        ("B2", nafblock.naf_block_stage_b, [x, r(b, h, w, c), r(b, c), r(c, c), r(c), r(c),
                                            r(c, mean=1.0), r(c), r(c, 2 * c), r(2 * c),
                                            r(c, c), r(c), r(c)], {}),
        ("B3", conv3x3.conv3x3_dense, [x, r(3, 3, c, 12), r(12)], {}),
        ("B4", wattn.fused_window_attention_xqkv, [x, r(c, 3 * c), r(3 * c), r(2, 16, 16), None,
                                                  (4, 4), 2], {}),
        ("B5a", aim.aim_conv_branch, [x, r(3, 3, 1, c), r(c), r(c, mean=1.0), r(c)], {}),
        ("B5b", aim.aim_gates_proj, [x, r(b, h, w, c), r(b, 1, 1, c), r(1, 1, c, 4), r(4),
                                     r(4, mean=1.0), r(4), r(1, 1, 4, 1), r(1), r(c, c), r(c)],
         {}),
        ("B6", sgfn.fused_sgfn_tail, [x, r(b, h, w, c), r(c, mean=1.0), r(c), r(c, 16), r(16),
                                      r(8, mean=1.0), r(8), r(3, 3, 1, 8), r(8), r(8, c), r(c)],
         {}),
        ("B7", cab.cab_chain, [x, r(c, mean=1.0), r(c), r(3, 3, c, 4), r(4), r(3, 3, 4, c),
                               r(c)], {"out_shift": 2}),
        ("B8", wattn.fused_hab_block, hab + [mask, (4, 4), 2, 0.01],
         {"cab_scale": r(b, 1, 1, c), "in_shift": 2}),
        ("B9", wattn.fused_overlap_attention, [x, r(b, h, w, c), r(b, h, w, c), r(c, c), r(c),
                                               r(2, 16, 36), 4, 2, 2], {}),
        ("B10", wattn.fused_residual_ln_mlp, [x, r(b, h, w, c), r(c, mean=1.0), r(c),
                                              r(c, 2 * c), r(2 * c), r(2 * c, c), r(c)], {}),
        ("B11", bandmha.fused_band_mha, [r(b, h, w, 3, 16), r(16, 48), r(48), r(16, 16), r(16),
                                         r(16, mean=1.0), r(16), 2], {}),
        ("B12", lka.lka_gate, [x, r(5, 5, c), r(21, c), r(21, c), r(c, c), r(c, mean=1.0),
                               r(c)], {}),
        ("B13", wattn.fused_window_attention_qkv, [x, r(b, h, w, c), r(b, h, w, c),
                                                   r(2, 16, 16), None, (4, 4), 2], {}),
        ("B14", wattn.fused_window_attention, [x, r(c, 3 * c), r(3 * c), r(c, c), r(c),
                                               r(2, 16, 16), None, (4, 4), 2], {}),
    ]


@pytest.mark.parametrize("case", range(15), ids=[c[0] for c in _wrapper_calls()])
def test_wrappers_refuse_a_call_that_autograd_would_record(case):
    """Every kernel wrapper raises on a tensor that requires grad while grad is enabled (the
    kernels have no backward: a gradient must not vanish silently), on the CPU as on the
    card, and runs under torch.no_grad()."""
    name, fn, args, kwargs = _wrapper_calls()[case]
    args = list(args)
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args, **kwargs)
    with torch.no_grad():
        out = fn(*args, **kwargs)
    for t in out if isinstance(out, tuple) else (out,):
        assert bool(torch.isfinite(t).all()), name


def test_checkpoint_load_reshapes_and_counts_what_does_not_fit():
    """A tensor of the parameter's element count in another shape is reshaped, as the JAX
    loader does; one of another size keeps the module's weight and is counted in the same
    warning as a missing key; nothing raises."""
    m = torch.nn.Sequential(torch.nn.Conv2d(4, 6, 1), torch.nn.LayerNorm(6))
    w0 = m[1].weight.detach().clone()
    sd = {"0.weight": torch.arange(24.0).reshape(6, 4),       # OI for an OI11 parameter
          "0.bias": torch.ones(1, 6, 1, 1),                  # [1,C,1,1] for [C]
          "1.weight": torch.zeros(7),                        # another size
          "extra": torch.zeros(3)}                           # a key the module lacks
    with pytest.warns(UserWarning, match=r"2 params not in checkpoint \(1 of another size"):
        tio._load_into(m, sd, "toy")
    assert torch.equal(m[0].weight, torch.arange(24.0).reshape(6, 4, 1, 1))
    assert torch.equal(m[0].bias, torch.ones(6))
    assert torch.equal(m[1].weight, w0)


@pytest.fixture(scope="module")
def layouts():
    """The JAX package's FreqFusionSR parameter shapes (traced, not run) and the port's
    parameter shapes, at the tiny expert topologies of the ensemble tests."""
    jm = JFreqFusionSR(JFusionConfig(), **EXPERTS)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    port = {k: tuple(v.shape) for k, v in
            FreqFusionSR(FusionConfig(), **EXPERTS).state_dict().items()}
    return shapes, port


@pytest.mark.parametrize("part", ["hat", "dat", "nafnet", "fusion"])
def test_port_parameter_layouts_follow_the_jax_loader(layouts, part):
    """For every leaf that the JAX loader fills from a reference .pth, the port's parameter
    of that key has a shape that one of the loader's named rules (OIHW->HWIO, OI11->IO,
    OI->IO or equal) carries onto the leaf, or one its reshape only adds unit axes to:
    never a blind reshape that moves elements. So a checkpoint that loads into the port
    means the same in the JAX package."""
    shapes, port = layouts
    trees = {"hat": ([shapes["params"]["experts"]["hat"]], jconvert.hat_key_fn,
                     "experts.hat."),
             "dat": ([shapes["params"]["experts"]["dat"]], jconvert.dat_key_fn,
                     "experts.dat."),
             "nafnet": ([shapes["params"]["experts"]["nafnet"]], jconvert.nafnet_key_fn,
                        "experts.nafnet.nafnet."),
             "fusion": ([shapes["params"]["fusion"], shapes["batch_stats"]["fusion"]],
                        jconvert.fusion_key_fn, "fusion.")}
    leaves, key_fn, prefix = trees[part]
    checked, bad = 0, []
    for tree in leaves:
        for path, leaf in traverse_util.flatten_dict(tree).items():
            spec = key_fn(path)
            if isinstance(spec, jconvert.Stacked):
                keys, shape = spec.keys(leaf.shape), leaf.shape[spec.naxes:]
            else:
                keys, shape = [spec], leaf.shape
            for k in keys:
                assert prefix + k in port, (path, k)
                rule = layout_rule(port[prefix + k], shape, path[-1])
                checked += 1
                if rule not in ("OIHW->HWIO", "OI11->IO", "OI->IO", "equal", "unit axes"):
                    bad.append((k, port[prefix + k], tuple(shape), rule))
    assert not bad, bad
    assert checked > 20


@pytest.mark.parametrize("torch_shape,flax_shape,leaf,rule", [
    ((6, 4, 3, 3), (3, 3, 4, 6), "kernel", "OIHW->HWIO"),
    ((6, 4, 1, 1), (4, 6), "kernel", "OI11->IO"),
    ((6, 4), (4, 6), "kernel", "OI->IO"),
    ((6,), (6,), "bias", "equal"),
    ((1, 6, 1, 1), (6,), "beta", "unit axes"),
    ((6, 4, 3, 3), (36, 6), "kernel", "reshape"),
    ((7,), (6,), "bias", "mismatch")])
def test_layout_rule_names_the_jax_loaders_rules(torch_shape, flax_shape, leaf, rule):
    """The port's copy of the rules agrees with the JAX loader: the named rules give the
    leaf's layout, and where only a reshape fits the loader reshapes."""
    assert layout_rule(torch_shape, flax_shape, leaf) == rule
    if rule != "mismatch":
        a = np.arange(np.prod(torch_shape), dtype=np.float32).reshape(torch_shape)
        got = jconvert._adapt(a, flax_shape, leaf)
        assert got.shape == tuple(flax_shape)
        if rule == "OIHW->HWIO":
            np.testing.assert_array_equal(got, a.transpose(2, 3, 1, 0))
        elif rule in ("OI11->IO", "OI->IO"):
            np.testing.assert_array_equal(got, a.reshape(6, 4).T)
        elif rule == "unit axes":
            np.testing.assert_array_equal(got.ravel(), a.ravel())


@pytest.mark.parametrize("cin,cout", [(180, 180), (60, 180), (180, 60), (32, 48), (3, 64)])
def test_conv_weights_pad_to_multiples_of_8(cin, cout):
    """B3's and B7's implicit GEMM takes channels in and out in multiples of 8: the padded
    weights unpack to the HWIO weights, and every padded entry is zero."""
    rng = np.random.default_rng(cin + cout)
    w, b = _r(rng, 3, 3, cin, cout), _r(rng, cout)
    cinp, npad, wp, bp = conv3x3.padded_conv_weights(w, b)
    assert (cinp, npad) == (-(-cin // 8) * 8, -(-cout // 8) * 8)
    assert wp.shape == (9, cinp, npad) and bp.shape == (npad,)
    assert torch.equal(wp[:, :cin, :cout].reshape(3, 3, cin, cout), w)
    assert torch.equal(bp[:cout], b)
    assert not wp[:, cin:].any() and not wp[:, :, cout:].any() and not bp[cout:].any()


@pytest.mark.parametrize("c,heads", [(180, 6), (24, 4), (64, 2)])
def test_hab_head_slab_is_q_k_v_without_a_zero_slot(c, heads):
    """B8's attention takes each head's q | k | v in three 32-column slots (96 columns; B4
    keeps a fourth, zero slot): the slabs unpack to wqkv and bqkv, the rest is zero."""
    rng = np.random.default_rng(c)
    hd, kp = c // heads, -(-c // 8) * 8
    wqkv, bqkv = _r(rng, c, 3 * c), _r(rng, 3 * c)
    wh, bh = wattn._padded_head_weights(wqkv, bqkv, heads, hd, kp, slots=3)
    assert wh.shape == (heads, kp, 96) and bh.shape == (heads, 96)
    got = wh[:, :c].reshape(heads, c, 3, 32)[..., :hd].permute(1, 2, 0, 3).reshape(c, 3 * c)
    assert torch.equal(got, wqkv)
    assert torch.equal(bh.reshape(heads, 3, 32)[..., :hd].permute(1, 0, 2).reshape(-1), bqkv)
    assert not wh[:, c:].any()
    assert not wh.reshape(heads, kp, 3, 32)[..., hd:].any()
    assert not bh.reshape(heads, 3, 32)[..., hd:].any()


@pytest.mark.parametrize("c,hid", [(180, 360), (180, 720), (64, 128), (20, 40), (12, 24)])
def test_row_product_weights_pad_to_multiples_of_8(c, hid):
    """The row products (B8's tail, B9, B10, B14) take K and N in multiples of 8: the MLP's
    and the projections' padded weights unpack to the originals, padded entries zero."""
    rng = np.random.default_rng(hid)
    w1, w2, wp = _r(rng, c, hid), _r(rng, hid, c), _r(rng, c, 3 * c)
    kp, npad, k2p, w1p, w2p = wattn._mlp_padded_weights(c, w1, w2)
    assert (kp, npad, k2p) == (-(-c // 8) * 8, -(-c // 8) * 8, -(-hid // 8) * 8)
    assert torch.equal(w1p[:c, :hid], w1) and torch.equal(w2p[:hid, :c], w2)
    assert not w1p[c:].any() and not w1p[:, hid:].any()
    assert not w2p[hid:].any() and not w2p[:, c:].any()
    np3 = -(-3 * c // 8) * 8
    pp = wattn._padded_proj(wp, kp, np3)
    assert pp.shape == (kp, np3) and torch.equal(pp[:c, :3 * c], wp)
    assert not pp[c:].any() and not pp[:, 3 * c:].any()
