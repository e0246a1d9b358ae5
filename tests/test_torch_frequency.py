"""Port parity for the frequency stack: ``ops/dct.py`` and ``models/frequency.py`` of
freqfusion_tpu_torch against the JAX package on the same numpy inputs.

Tolerances: 2e-5 on the DCT ops and modules (one f32 product in another order); the FFT
split runs ``torch.fft`` against the JAX package's matmul DFT and is held to 2e-4 on band
images of O(1) (found: <= 7e-7 at these sizes, even and odd W).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import frequency as jfreq
from freqfusion_tpu.ops import dct as jdct
from freqfusion_tpu.utils.convert import freq_key_fn
from freqfusion_tpu_torch.models import frequency as tfreq
from freqfusion_tpu_torch.ops import dct as tdct
from freqfusion_tpu_torch.utils.convert import freq_key, fusion_params_from_flax

torch.set_num_threads(2)
T = torch.from_numpy


def image(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def randomized(params, seed):
    """Every leaf of a JAX tree moved off its initial value (ones, zeros, constants)."""
    rng = np.random.default_rng(seed)
    flat = {p: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))).astype(np.float32)
            for p, a in flatten_dict(params).items()}
    return unflatten_dict(flat)


def pair(jcls, tcls, x, seed, *args):
    """(JAX module, its randomised params, the port's module holding the same)."""
    jm = jcls(*args)
    params = randomized(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"], seed)
    tm = tcls(*args).eval()
    tm.load_state_dict(fusion_params_from_flax(params), strict=True)
    return jm, params, tm


def test_dct_tables_match_jax():
    for n in (4, 8):
        np.testing.assert_array_equal(tdct.zigzag_indices(n), jdct.zigzag_indices(n))
        np.testing.assert_array_equal(tdct.dct_matrix(n), jdct.dct_matrix(n))
        for a, b in zip(tdct.band_masks_thirds(n), jdct.band_masks_thirds(n)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tdct.band_masks_ratio(n, 0.25, 0.25), jdct.band_masks_ratio(n, 0.25, 0.25)):
            np.testing.assert_array_equal(a, b)
        for key in ("thirds", "ratio"):
            np.testing.assert_array_equal(tdct.band_operator(n, key), jdct.band_operator(n, key))


@pytest.mark.parametrize("hw", [(16, 24), (19, 29)])
def test_block_ops_match_jax(hw):
    x = image((2, *hw, 3), 1)
    xp, size = tdct.reflect_pad_to_block(T(x))
    jxp, jsize = jdct.reflect_pad_to_block(jnp.asarray(x))
    assert size == jsize
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    blocks = tdct.blockify(xp)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jdct.blockify(jxp)))
    np.testing.assert_array_equal(tdct.unblockify(blocks).numpy(), xp.numpy())
    for key in ("thirds", "ratio"):
        op = tdct.band_operator(8, key)
        got = tdct.block_dct_bands(T(x), op)
        want = jdct.block_dct_bands(jnp.asarray(x), op)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
        np.testing.assert_allclose(sum(got).numpy(), x, atol=2e-5)   # the bands add up to x
    b8 = blocks.reshape(*blocks.shape[:-1], 8, 8)
    coeffs = tdct.dct2d(b8)
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jdct.dct2d(jnp.asarray(b8.numpy()))),
                               atol=2e-5)
    np.testing.assert_allclose(tdct.idct2d(coeffs).numpy(), b8.numpy(), atol=2e-5)


@pytest.mark.parametrize("hw", [(24, 40), (21, 27)])
def test_dct_thirds_and_dwt_match_jax(hw):
    x = image((2, *hw, 3), 2)
    for jcls, tcls in ((jfreq.DCTThirds, tfreq.DCTThirds), (jfreq.DWTDb4, tfreq.DWTDb4)):
        jm, params, tm = pair(jcls, tcls, x, 3)
        want = jm.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = tm(T(x))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == x.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("hw", [(24, 40), (24, 41), (21, 27), (32, 32)])
def test_fft_split_matches_the_matmul_dft(hw):
    x = image((2, *hw, 3), 4)
    jm, params, tm = pair(jfreq.FFTSplit, tfreq.FFTSplit, x, 5, 16)
    assert tm.freq_mask_logits.shape == (1, 1, 16, 16)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(T(x))
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0.05
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


def test_adaptive_band_fusion_matches_jax():
    rng = np.random.default_rng(6)
    bands = [rng.standard_normal((2, 16, 20, 3)).astype(np.float32) * 0.3 for _ in range(9)]
    jm = jfreq.AdaptiveBandFusion()
    jbands = [jnp.asarray(b) for b in bands]
    params = randomized(jm.init(jax.random.PRNGKey(0), jbands)["params"], 7)
    tm = tfreq.AdaptiveBandFusion().eval()
    tm.load_state_dict(fusion_params_from_flax(params), strict=True)
    want = jm.apply({"params": params}, jbands)
    with torch.no_grad():
        got = tm([T(b) for b in bands])
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("hw", [(24, 40), (21, 27)])
def test_multi_domain_decompose_matches_jax(hw):
    x = image((1, *hw, 3), 8)
    jm, params, tm = pair(jfreq.MultiDomainFrequency, tfreq.MultiDomainFrequency, x, 9)
    # the port's keys are the reference's, as both packages' key functions give them
    want_keys = {freq_key_fn(p) for p in flatten_dict(params)}
    assert {freq_key(p) for p in flatten_dict(params)} == want_keys
    assert set(tm.state_dict()) == want_keys
    want = jm.apply({"params": params}, jnp.asarray(x), method=jm.decompose)
    (jfused, _) = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.decompose(T(x))
        fused, raw = tm(T(x))
    assert len(got) == 9 and raw is None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
    for g, w in zip(fused, jfused):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


def test_frequency_decomposition_matches_jax():
    x = image((2, 19, 29, 3), 10)
    jm, tm = jfreq.FrequencyDecomposition(), tfreq.FrequencyDecomposition()
    for g, w in zip(tm(T(x)), jm.apply({}, jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    low, high = np.float32([0.2, 0.33]), np.float32([0.7, 0.8])
    want = jm.apply({}, jnp.asarray(x), jnp.asarray(low), jnp.asarray(high), method=jm.adaptive)
    got = tm.adaptive(T(x), T(low), T(high))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    np.testing.assert_allclose(tm.reconstruct(*tm(T(x))).numpy(), x, atol=2e-5)
