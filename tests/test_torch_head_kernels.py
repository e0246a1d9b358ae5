"""Port parity for the fusion head's two kernels: the plain versions of B11 (band MHA) and
B12 (LKA gate) against the JAX package's Pallas kernels in interpret mode and against its
XLA references, and the wrappers' CPU and no-grad behaviour.

Tolerances: B11 atol 5e-5 + rtol 1e-4 (the Pallas kernel takes one softmax max per pixel
row, the plain version one per head and query: rounding only); B12 atol 1e-5 + rtol 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.models.layers import TorchMHA as JTorchMHA
from freqfusion_tpu.models.layers import apply_ln
from freqfusion_tpu.ops.pallas.bandmha import fused_band_mha as j_band_mha
from freqfusion_tpu.ops.pallas.lka import lka_gate as j_lka_gate
from freqfusion_tpu.ops.pallas.lka import lka_gate_reference as j_lka_reference
from freqfusion_tpu_torch.ops.kernels.bandmha import fused_band_mha, fused_band_mha_plain
from freqfusion_tpu_torch.ops.kernels.lka import lka_gate, lka_gate_plain

torch.set_num_threads(2)
T = torch.from_numpy


def _mha_inputs(b, h, w, t, d, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, std=1.0, mean=0.0):
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    return (r(b, h, w, t, d, std=0.4), r(d, 3 * d, std=d ** -0.5), r(3 * d, std=0.1),
            r(d, d, std=d ** -0.5), r(d, std=0.1), r(d, std=0.1, mean=1.0), r(d, std=0.1))


# (b, h, w, t, d, heads): the two cases of tests/test_pallas_bandmha.py
MHA_CASES = [(2, 8, 16, 9, 64, 4), (1, 4, 8, 3, 32, 2)]


@pytest.mark.parametrize("case", MHA_CASES)
def test_band_mha_plain_matches_pallas_interpret(case):
    *shape, heads = case
    args = _mha_inputs(*shape, seed=1)
    want = j_band_mha(*map(jnp.asarray, args), heads, interpret=True)
    got = fused_band_mha_plain(*map(T, args), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("case", MHA_CASES)
def test_band_mha_plain_matches_torchmha_ln_residual(case):
    *shape, heads = case
    x, wqkv, bqkv, wproj, bproj, lnw, lnb = _mha_inputs(*shape, seed=2)
    params = {"in_proj_weight": wqkv, "in_proj_bias": bqkv,
              "out_proj": {"kernel": wproj, "bias": bproj}}
    xj = jnp.asarray(x)
    want = JTorchMHA(shape[-1], heads).apply(
        {"params": params}, apply_ln(xj, jnp.asarray(lnw), jnp.asarray(lnb))) + xj
    got = fused_band_mha_plain(*map(T, (x, wqkv, bqkv, wproj, bproj, lnw, lnb)), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)


def _lka_inputs(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h, w, c)).astype(f),
            (rng.standard_normal((5, 5, c)) * 0.1).astype(f),
            (rng.standard_normal((21, c)) * 0.1).astype(f),
            (rng.standard_normal((21, c)) * 0.1).astype(f),
            (rng.standard_normal((c, c)) * 0.1).astype(f),
            rng.uniform(0.5, 1.5, c).astype(f), (rng.standard_normal(c) * 0.1).astype(f))


# (b, h, w, c): the two cases of tests/test_pallas_lka.py, C = 128, the odd 9-band batch
# at C = 64, and an image lower than the 12-px halo
LKA_CASES = [(2, 24, 32, 64), (1, 21, 16, 32), (1, 16, 24, 128), (9, 12, 16, 64),
             (1, 10, 40, 64)]


@pytest.mark.parametrize("shape", LKA_CASES)
def test_lka_plain_matches_xla_reference(shape):
    args = _lka_inputs(*shape, seed=3)
    want = j_lka_reference(*map(jnp.asarray, args))
    got = lka_gate_plain(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", LKA_CASES)
def test_lka_plain_matches_pallas_interpret(shape):
    args = _lka_inputs(*shape, seed=4)
    want = j_lka_gate(*map(jnp.asarray, args), block_h=8, interpret=True)
    got = lka_gate_plain(*map(T, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_lka_zero_outside_the_image_between_stages():
    """Each stage pads its own input: a chain on a zero-padded x continued outward gives
    another answer near the border, and the plain version must not be that one."""
    x, w5, wh, wv, wp, scale, shift = map(T, _lka_inputs(1, 30, 34, 8, seed=5))
    got = lka_gate_plain(x, w5, wh, wv, wp, scale, shift)
    c, pad = x.shape[-1], 12
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (pad,) * 4)
    conv = torch.nn.functional.conv2d
    a = conv(xp, w5.permute(2, 0, 1).reshape(c, 1, 5, 5), groups=c)
    a = conv(a, wh.t().reshape(c, 1, 1, 21), groups=c)
    a = conv(a, wv.t().reshape(c, 1, 21, 1), groups=c).permute(0, 2, 3, 1)
    wrong = x * torch.sigmoid((a @ wp) * scale + shift)
    assert wrong.shape == got.shape
    assert (got - wrong).abs().max() > 1e-3            # the border differs
    torch.testing.assert_close(got[:, 12:-12, 12:-12], wrong[:, 12:-12, 12:-12],
                               atol=1e-5, rtol=1e-5)   # the interior does not


def test_wrappers_run_the_plain_version_on_cpu():
    *shape, heads = MHA_CASES[0]
    margs = tuple(map(T, _mha_inputs(*shape, seed=6)))
    torch.testing.assert_close(fused_band_mha(*margs, heads),
                               fused_band_mha_plain(*margs, heads), atol=0, rtol=0)
    largs = tuple(map(T, _lka_inputs(2, 13, 17, 16, seed=7)))
    torch.testing.assert_close(lka_gate(*largs), lka_gate_plain(*largs), atol=0, rtol=0)


@pytest.mark.parametrize("which", ["input", "weight"])
def test_wrappers_raise_when_a_tensor_requires_grad(which):
    *shape, heads = MHA_CASES[1]
    margs = list(map(T, _mha_inputs(*shape, seed=8)))
    largs = list(map(T, _lka_inputs(1, 8, 8, 8, seed=9)))
    i = 0 if which == "input" else 1
    margs[i].requires_grad_(True)
    largs[i].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_band_mha(*margs, heads)
    with pytest.raises(RuntimeError, match="no backward"):
        lka_gate(*largs)
    with torch.no_grad():   # nothing is recorded: the call goes through
        assert fused_band_mha(*margs, heads).shape == margs[0].shape
        assert lka_gate(*largs).shape == largs[0].shape
