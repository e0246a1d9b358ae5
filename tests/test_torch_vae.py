"""Port parity for ``models/vae.py``: encode and decode at ``tests/test_vae.py``'s tiny
``CFG`` against the JAX AutoencoderKL (atol 1e-5, rtol 1e-4) with seeded random weights
carried across by ``vae_params_from_flax``; one diffusers-layout ``.pth`` read by both
packages' loaders giving equal outputs; the codec against the JAX codec; and the codec
raising without weights, and on a ``.safetensors`` file without the safetensors package.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import vae as jvae
from freqfusion_tpu_torch.models import vae as tvae
from test_vae import CFG

torch.set_num_threads(2)
T = torch.from_numpy
TOL = dict(atol=1e-5, rtol=1e-4)


def random_params(seed):
    """Seeded JAX AutoencoderKL params at CFG: kernels N(0, 1/fan_in), GroupNorm scales
    N(1, 0.1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jvae.AutoencoderKL(**CFG).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if path[-1] == "scale" else 0.0) + 0.1 * rng.standard_normal(s.shape)

    return unflatten_dict({p: draw(p, s).astype(np.float32)
                           for p, s in flatten_dict(shapes).items()})


def port_model(params):
    model = tvae.AutoencoderKL(**CFG).eval()
    model.load_state_dict(tvae.vae_params_from_flax(params, model), strict=True)
    return model


def test_vae_matches_jax():
    params = random_params(0)
    jmodel = jvae.AutoencoderKL(**CFG)
    model = port_model(params)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(2, 16, 24, 3)).astype(np.float32)
    want_mean, want_logvar = jax.jit(lambda p, v: jmodel.apply({"params": p}, v,
                                                               method="encode"))(params, x)
    with torch.no_grad():
        mean, logvar = model.encode(T(x))
    assert mean.shape == (2, 8, 12, 4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), **TOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want_logvar), **TOL)
    z = (0.5 * rng.standard_normal((2, 8, 12, 4))).astype(np.float32)
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, method="decode"))(params, z)
    with torch.no_grad():
        got = model.decode(T(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_one_pth_for_both_loaders(tmp_path):
    path = str(tmp_path / "vae.pth")
    torch.save(port_model(random_params(2)).state_dict(), path)
    jmodel = jvae.AutoencoderKL(**CFG)
    jparams = jvae.load_vae_params(jmodel, path)
    model = tvae.load_vae_params(tvae.AutoencoderKL(**CFG), path).eval()
    x = np.random.default_rng(3).uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = model(T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_codec_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "vae.pth")
    torch.save(port_model(random_params(4)).state_dict(), path)
    monkeypatch.setenv("FREQFUSION_SDVAE_WEIGHTS", path)
    jcodec = jvae.SDVAECodec(model=jvae.AutoencoderKL(**CFG))
    codec = tvae.SDVAECodec(model=tvae.AutoencoderKL(**CFG), device="cpu")
    img = np.random.default_rng(5).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    lat = codec.encode(T(img))
    np.testing.assert_allclose(lat.numpy(), np.asarray(jcodec.encode(jnp.asarray(img))), **TOL)
    rec = codec.decode(lat)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jcodec.decode(jnp.asarray(lat.numpy()))),
                               **TOL)
    assert float(rec.min()) >= 0.0 and float(rec.max()) <= 1.0
    sampled = codec.encode(T(img), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(sampled).all() and not torch.allclose(sampled, lat)


def test_codec_raises_without_weights(monkeypatch):
    monkeypatch.delenv("FREQFUSION_SDVAE_WEIGHTS", raising=False)
    with pytest.raises(tvae.MissingWeights):
        tvae.SDVAECodec(model=tvae.AutoencoderKL(**CFG), device="cpu")
    with pytest.raises(RuntimeError):   # the JAX twin raises the same class
        jvae.SDVAECodec(model=jvae.AutoencoderKL(**CFG))


def test_safetensors_without_the_package(tmp_path, monkeypatch):
    path = str(tmp_path / "vae.safetensors")
    open(path, "wb").close()
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(RuntimeError, match="safetensors package"):
        tvae.read_state_dict(path)
