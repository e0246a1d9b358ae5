"""Port parity for the whole model: a tiny ``FreqFusionSR`` of freqfusion_tpu_torch against
the JAX ``FreqFusionSR`` from ``freqfusion_params_from_flax`` (final output within 2e-4,
uint8 serving within 1 LSB), and the directory contract ``main`` / ``model_func`` on the
CPU: checkpoints found and loaded, a missing one warned about, an unreadable ``.ckpt`` refused,
a frame below the whole-image plan served in tiles, and the default device refused where
there is no card.
"""

import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import traverse_util
from PIL import Image

from freqfusion_tpu.models.experts import FreqFusionSR as JFreqFusionSR
from freqfusion_tpu.models.fusion import FusionConfig as JFusionConfig
from freqfusion_tpu_torch.infer import io as tio
from freqfusion_tpu_torch.infer.io import InferencePipeline, main, model_func
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig
from freqfusion_tpu_torch.utils.convert import freqfusion_params_from_flax
from freqfusion_tpu_torch.utils.imageio import save_image

torch.set_num_threads(2)

# the tiny expert topologies of tests/test_torch_{hat,dat,nafnet}.py: HAT at window 8 and DAT
# at 64-token windows go through the kernels' wrappers, as serving does
EXPERTS = dict(
    hat_kwargs=dict(embed_dim=24, depths=(2, 2), num_heads=(4, 4), window=8, compress=3,
                    squeeze=6, conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16),
    dat_kwargs=dict(embed_dim=64, depths=(2, 2), num_heads=(4, 4), split_size=(4, 16),
                    expansion=2.0),
    nafnet_kwargs=dict(width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)))


def random_variables(jm, seed):
    """Every leaf of the JAX model's variables drawn with numpy over the shapes of `init`
    (tracing only), nothing an identity: kernels N(0, 1/fan_in), biases, running means and
    NAF's beta / gamma N(0, 0.1), running variances U(0.6, 1.4), HAT's bias tables N(0,
    0.5), the FFT mask logits N(0, 1), scalars near their initial values, every other
    scale or weight N(1, 0.1)."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in shapes.items():
        flat = {}
        for path, leaf in traverse_util.flatten_dict(tree).items():
            shape, name = leaf.shape, path[-1]
            stack = (path[2] == "layers") + ("pairs" in path) if path[0] == "experts" else 0
            if name.endswith("kernel") or name == "in_proj_weight":
                a = rng.standard_normal(shape) * float(np.prod(shape[stack:-1])) ** -0.5
            elif name in ("var", "running_var"):
                a = rng.uniform(0.6, 1.4, shape)
            elif name in ("bias", "mean", "running_mean", "in_proj_bias", "beta", "gamma") \
                    or name.endswith("_bias"):
                a = 0.1 * rng.standard_normal(shape)
            elif name == "relative_position_bias_table":
                a = 0.5 * rng.standard_normal(shape)
            elif name == "freq_mask_logits":
                a = rng.standard_normal(shape)
            elif len(shape) == 0:
                a = (5.0 if name == "temperature" else 0.2) + 0.05 * rng.standard_normal()
            else:
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            flat[path] = np.asarray(a, dtype=np.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def pair():
    jm = JFreqFusionSR(JFusionConfig(), **EXPERTS)
    variables = random_variables(jm, 0)
    tm = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
    # the JAX model initialised without features holds no collaborative branch (serving
    # never runs it): those are the only keys the converted state dict may lack
    result = tm.load_state_dict(freqfusion_params_from_flax(variables), strict=False)
    assert not result.unexpected_keys
    assert all(k.startswith("fusion.collaborative.") for k in result.missing_keys)
    return jm, variables, tm, jax.jit(jm.apply)


def test_tiny_freqfusion_matches_jax(pair):
    jm, variables, tm, japply = pair
    lr = np.random.default_rng(1).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(japply(variables, jnp.asarray(lr)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(lr))
    assert got.shape == (1, 128, 128, 3)
    assert ((want > 0) & (want < 1)).mean() > 0.5   # not saturated by the clamps
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_experts_are_frozen_outside_inference_mode(pair):
    """With grad enabled the experts' outputs are detached: only the head gets gradients.
    The head's kernels have no backward, so the plain versions are asked for."""
    tm = pair[2]
    heads = [m for m in tm.fusion.modules() if hasattr(m, "kernels")]
    lr = np.random.default_rng(4).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        tm(torch.from_numpy(lr))
    try:
        for m in heads:
            m.kernels = False
        tm(torch.from_numpy(lr)).sum().backward()
    finally:
        for m in heads:
            m.kernels = True
    assert all(p.grad is None for p in tm.experts.parameters())
    assert tm.fusion.residual_scale.grad is not None
    assert tm.fusion.cross_band_attn.band_attention.in_proj_weight.grad is not None
    tm.zero_grad(set_to_none=True)


def test_tiny_freqfusion_u8_serving_matches_jax(pair):
    jm, variables, tm, japply = pair
    lr = np.random.default_rng(2).uniform(size=(50, 60, 3)).astype(np.float32)
    pipe = InferencePipeline(tm, "cpu")
    got = pipe.materialize_u8(pipe.dispatch_batch_u8([lr]))[0]
    assert got.shape == (200, 240, 3) and got.dtype == np.uint8
    lrp = np.pad(lr, [(0, 14), (0, 4), (0, 0)], mode="reflect")   # the 64x64 bucket
    sr = np.asarray(japply(variables, jnp.asarray(lrp[None])))[0, :200, :240]
    want = np.round(np.clip(sr, 0, 1) * 255)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _reference_model(seed):
    """A tiny FreqFusionSR with seeded weights unlike any default initialisation."""
    torch.manual_seed(seed)
    ref = FreqFusionSR(FusionConfig(), **EXPERTS).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, buf in ref.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.8 + 0.6)
            elif name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 - 0.2)
    return ref


def test_main_serves_a_directory_from_pth_checkpoints(tmp_path):
    ref = _reference_model(123)
    model_dir, src, out = tmp_path / "model", tmp_path / "lr", tmp_path / "sr"
    for sub in ("pretrained/hat", "pretrained/dat/nested", "pretrained/nafnet"):
        (model_dir / sub).mkdir(parents=True)
    # the reference's wrappings: params_ema / params / the bare dict with NAFNetSR's
    # `nafnet.` prefix / a training checkpoint's model_state_dict with `module.` prefixes
    torch.save({"params_ema": ref.experts.hat.state_dict()}, model_dir / "pretrained/hat/hat.pth")
    torch.save({"params": ref.experts.dat.state_dict()},
               model_dir / "pretrained/dat/nested/dat.pth")
    naf_sd = ref.experts.nafnet.state_dict()
    assert all(k.startswith("nafnet.") for k in naf_sd)
    torch.save(naf_sd, model_dir / "pretrained/nafnet/naf.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in ref.fusion.state_dict().items()},
                "epoch": 3}, model_dir / "best_fusion.pth")
    rng = np.random.default_rng(3)
    # buckets 96x96, 64x128 and 64x128 again: the last two can share a dispatch
    sizes = {"a.png": (70, 80), "b.png": (64, 100), "c.png": (60, 120)}
    for name, (h, w) in sizes.items():
        save_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), str(src / name))

    with warnings.catch_warnings():
        warnings.simplefilter("error")   # every checkpoint is there: nothing may warn
        n = model_func(str(model_dir), str(src), str(out), "cpu", expert_kwargs=EXPERTS)
    assert n == 3 and model_func is main
    want_pipe = InferencePipeline(ref, "cpu")
    for name, (h, w) in sizes.items():
        got = np.asarray(Image.open(out / name))
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
        lr = np.asarray(Image.open(src / name), dtype=np.float32) / 255.0
        want = want_pipe.materialize_u8(want_pipe.dispatch_batch_u8([lr]))[0]
        np.testing.assert_array_equal(got, want)   # the same weights: the same image

    # consecutive images of one bucket grouped two a dispatch: the same images within 1 LSB
    # (a batch of two takes other library products, whose sums run in another order)
    assert main(str(model_dir), str(src), str(tmp_path / "sr_grouped"), "cpu",
                expert_kwargs=EXPERTS, group_max=2) == 3
    for name in sizes:
        grouped = np.asarray(Image.open(tmp_path / "sr_grouped" / name)).astype(np.int32)
        assert np.abs(grouped - np.asarray(Image.open(out / name))).max() <= 1

    # a missing checkpoint warns and keeps the seeded random weights
    os.remove(model_dir / "pretrained/dat/nested/dat.pth")
    with pytest.warns(UserWarning, match="dat checkpoint not found"):
        assert main(str(model_dir), str(src), str(tmp_path / "sr2"), "cpu",
                    expert_kwargs=EXPERTS) == 3
    assert not np.array_equal(np.asarray(Image.open(tmp_path / "sr2" / "a.png")),
                              np.asarray(Image.open(out / "a.png")))

    # a native checkpoint in neither of the two formats is refused, not skipped (the
    # formats themselves: tests/test_torch_training.py)
    (model_dir / "checkpoints").mkdir()
    (model_dir / "checkpoints" / "latest.ckpt").write_bytes(b"\x00")
    with pytest.raises(ValueError, match="neither a torch.save archive nor a flax msgpack"):
        main(str(model_dir), str(src), str(tmp_path / "sr3"), "cpu", expert_kwargs=EXPERTS)


def test_main_tiles_a_tiny_frame_and_refuses_a_bad_tiling_or_a_missing_card(tmp_path):
    """What `main` still refuses: a tiling that cannot cover an image (no frame is refused
    for its size any more: a 40x30 frame, smaller than its reflect padding, is served in
    tiles), and the default device where there is no card."""
    src = tmp_path / "lr"
    save_image(np.random.default_rng(0).integers(0, 256, (30, 40, 3), dtype=np.uint8),
               str(src / "small.png"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for bad in (dict(tile=32, overlap=32), dict(tile=0), dict(tile_batch=0)):
            with pytest.raises(ValueError, match="tiling"):
                main(str(tmp_path), str(src), str(tmp_path / "sr"), "cpu",
                     expert_kwargs=EXPERTS, **bad)
        assert main(str(tmp_path), str(src), str(tmp_path / "sr"), "cpu",
                    expert_kwargs=EXPERTS, tile=32, overlap=8) == 1
    assert np.asarray(Image.open(tmp_path / "sr" / "small.png")).shape == (120, 160, 3)
    if not torch.cuda.is_available():   # the default device is the card: no fallback
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(str(tmp_path), str(src), str(tmp_path / "sr"), expert_kwargs=EXPERTS)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            InferencePipeline(torch.nn.Identity())
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tio.build_pipeline(str(tmp_path), expert_kwargs=EXPERTS)
