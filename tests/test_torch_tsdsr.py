"""Port parity for ``models/tsdsr.py``: ``DiT`` and ``TSDSRDiT`` (hidden 64, depth 2, 4
heads, every parameter random, the final layer and the adaLN modulations included, t =
[500, 10]) against the JAX twin within 2e-4, weights carried across by
``tsdsr_params_from_flax``; ``infer_dit_config`` on one state dict; the student and the
3-step teacher with a tiny codec against the JAX ``TSDSRInference``; the identity without
weights; going live from FREQFUSION_TSDSR_WEIGHTS and FREQFUSION_SDVAE_WEIGHTS; staying
the identity with a warning on a bad file; and both packages raising at a 255x169 latent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import tsdsr as jts
from freqfusion_tpu.models import vae as jvae
from freqfusion_tpu_torch.models import tsdsr as tts
from freqfusion_tpu_torch.models import vae as tvae
from test_vae import CFG

torch.set_num_threads(2)
T = torch.from_numpy
TOL = dict(atol=2e-4, rtol=2e-4)
DIT = dict(hidden=64, depth=2, heads=4)
STEPS = np.array([500.0, 10.0], np.float32)


def random_params(module, seed, *args):
    """Seeded parameters of the JAX module's shapes: kernels N(0, 1/fan_in), LayerNorm
    scales N(1, 0.1), every other vector N(0, 0.1); nothing zero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if path[-1] == "scale" else 0.0) + 0.1 * rng.standard_normal(s.shape)

    return unflatten_dict({p: draw(p, s).astype(np.float32)
                           for p, s in flatten_dict(shapes).items()})


def latent(seed, shape=(2, 8, 12, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def port_dit(params):
    model = tts.TSDSRDiT(**DIT).eval()
    model.load_state_dict(tts.tsdsr_params_from_flax(params, model), strict=True)
    return model


def test_dit_matches_jax():
    x = latent(0)
    jmodel = jts.DiT(**DIT)
    params = random_params(jmodel, 1, jnp.asarray(x), jnp.asarray(STEPS))
    want = jax.jit(lambda p, v, t: jmodel.apply({"params": p}, v, t))(params, x, STEPS)
    sd = tts.tsdsr_params_from_flax({"dit": params}, tts.TSDSRDiT(**DIT))
    model = tts.DiT(**DIT).eval()
    model.load_state_dict({k[len("dit."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model(T(x), T(STEPS))
    assert np.abs(np.asarray(want)).max() > 0.1   # the final layer is not zero
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("timestep", [None, STEPS])
def test_tsdsr_dit_matches_jax(timestep):
    x = latent(2)
    jmodel = jts.TSDSRDiT(**DIT)
    params = random_params(jmodel, 3, jnp.asarray(x))
    extra = () if timestep is None else (timestep,)
    want = jax.jit(lambda p, v, *t: jmodel.apply({"params": p}, v, *t))(params, x, *extra)
    with torch.no_grad():
        got = port_dit(params)(T(x), *map(T, extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_infer_dit_config_matches_jax():
    sd = tts.TSDSRDiT(hidden=128, depth=3, heads=2, mlp_ratio=2.0, time_embed_dim=64).state_dict()
    want = jts.infer_dit_config({k: v.numpy() for k, v in sd.items()})
    assert tts.infer_dit_config(sd) == want
    assert want == dict(hidden=128, in_channels=4, patch=2, depth=3, heads=2, mlp_ratio=2.0,
                        time_embed_dim=64)


def codecs(tmp_path, seed):
    """(port codec on the CPU, JAX codec) of one random tiny VAE, and its .pth."""
    jmodel = jvae.AutoencoderKL(**CFG)
    params = random_params(jmodel, seed, jnp.zeros((1, 16, 16, 3)))
    model = tvae.AutoencoderKL(**CFG)
    sd = tvae.vae_params_from_flax(params, model)
    path = str(tmp_path / "vae.pth")
    torch.save(sd, path)
    return (tvae.SDVAECodec(params=sd, model=model, device="cpu"),
            jvae.SDVAECodec(params={"params": params}, model=jmodel), path)


@pytest.mark.parametrize("mode,steps", [("student", 20), ("teacher", 3)])
def test_inference_matches_jax(tmp_path, monkeypatch, mode, steps):
    monkeypatch.delenv("FREQFUSION_TSDSR_WEIGHTS", raising=False)
    codec, jcodec, _ = codecs(tmp_path, 4)
    jdit = jts.TSDSRDiT(**DIT)
    params = random_params(jdit, 5, jnp.zeros((1, 8, 8, 4)))
    img = np.random.default_rng(6).uniform(size=(1, 16, 32, 3)).astype(np.float32)
    want = jts.TSDSRInference(dit=jdit, params={"params": params}, codec=jcodec, mode=mode,
                              num_steps=steps).refine(jnp.asarray(img))
    inf = tts.TSDSRInference(dit=port_dit(params), codec=codec, mode=mode, num_steps=steps,
                             device="cpu")
    assert inf.available
    got = inf.refine(T(img))
    assert np.abs(got.numpy() - img).max() > 1e-3   # refined, not passed through
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_identity_without_weights(monkeypatch):
    monkeypatch.delenv("FREQFUSION_TSDSR_WEIGHTS", raising=False)
    monkeypatch.delenv("FREQFUSION_SDVAE_WEIGHTS", raising=False)
    img = T(np.random.default_rng(7).uniform(size=(1, 16, 16, 3)).astype(np.float32))
    inf = tts.TSDSRInference(device="cpu")
    assert not inf.available and inf.refine(img) is img
    assert tts.CompleteSRPipeline(device="cpu")(img) is img
    # a DiT without a codec stays the identity too
    assert not tts.TSDSRInference(dit=tts.TSDSRDiT(**DIT), device="cpu").available
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tts.CompleteSRPipeline()


def test_live_from_environment(tmp_path, monkeypatch):
    codec, _, vae_path = codecs(tmp_path, 8)
    params = random_params(jts.TSDSRDiT(**DIT), 9, jnp.zeros((1, 8, 8, 4)))
    dit = port_dit(params)
    dit_path = str(tmp_path / "dit.pth")
    torch.save({k[4:]: v for k, v in dit.state_dict().items()}, dit_path)   # a bare DiT dump
    monkeypatch.setenv("FREQFUSION_TSDSR_WEIGHTS", dit_path)
    monkeypatch.setenv("FREQFUSION_SDVAE_WEIGHTS", vae_path)
    # the codec reads its weights from the variable, into the tiny CFG architecture in place
    # of SD 2.1's
    monkeypatch.setattr(tts, "SDVAECodec", lambda device: tvae.SDVAECodec(
        model=tvae.AutoencoderKL(**CFG), device=device))
    img = T(np.random.default_rng(10).uniform(size=(1, 16, 16, 3)).astype(np.float32))
    pipe = tts.CompleteSRPipeline(device="cpu")
    assert pipe.tsdsr.available
    assert pipe.tsdsr.dit.dit.blocks[0].heads == 1   # infer_dit_config: head width 64
    want = tts.TSDSRInference(dit=tts.load_tsdsr_params(dit_path), codec=codec, device="cpu")
    np.testing.assert_allclose(pipe(img).numpy(), want.refine(img).numpy(), atol=1e-6)
    np.testing.assert_array_equal(pipe(img, use_tsdsr=False).numpy(), img.numpy())


def test_bad_files_warn_and_stay_identity(tmp_path, monkeypatch):
    bad = tmp_path / "bad.pth"
    bad.write_bytes(b"not a checkpoint")
    monkeypatch.setenv("FREQFUSION_TSDSR_WEIGHTS", str(bad))
    monkeypatch.delenv("FREQFUSION_SDVAE_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="DiT loading failed"):
        inf = tts.TSDSRInference(device="cpu")
    assert not inf.available
    # a good DiT with a bad VAE file
    monkeypatch.delenv("FREQFUSION_TSDSR_WEIGHTS")
    monkeypatch.setenv("FREQFUSION_SDVAE_WEIGHTS", str(bad))
    with pytest.warns(UserWarning, match="VAE loading failed"):
        inf = tts.TSDSRInference(dit=tts.TSDSRDiT(**DIT), device="cpu")
    assert not inf.available


def test_odd_latent_raises_in_both_packages():
    """A 2040x1356 output encodes to a 255x169 latent: the stride-2 patchify returns
    254x168, and the refinement cannot add it back."""
    jmodel = jts.TSDSRDiT(hidden=32, depth=1, heads=2)
    z = jnp.zeros((1, 169, 255, 4))
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(lambda: jmodel.apply(jmodel.init(jax.random.PRNGKey(0), z), z))
    with pytest.raises(ValueError, match="169x255"):
        tts.TSDSRDiT(hidden=32, depth=1, heads=2)(torch.zeros(1, 169, 255, 4))
