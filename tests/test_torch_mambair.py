"""Port parity for ``models/mambair.py``: the chunked selective scan against the JAX
associative scan and the float64 sequential oracle of ``tests/test_mambair.py`` (1e-5), at
sequence lengths that are not multiples of the chunk; a small MambaIR against its JAX twin
(atol 5e-5 + rtol 1e-4, the experts' bound) with seeded random weights carried across by
``utils/convert.py:mambair_params_from_flax``; and the key function against the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import mambair as jm
from freqfusion_tpu.utils.convert import mambair_key_fn
from freqfusion_tpu_torch.models import mambair as tm
from freqfusion_tpu_torch.utils.convert import mambair_key, mambair_params_from_flax
from test_mambair import _scan_oracle

torch.set_num_threads(2)
T = torch.from_numpy


def scan_inputs(seed, lead, l, dim, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal(lead + (l, dim)).astype(f),
            rng.uniform(0.001, 0.2, lead + (l, dim)).astype(f),
            -rng.uniform(0.5, 2.0, (dim, n)).astype(f),
            rng.standard_normal(lead + (l, n)).astype(f),
            rng.standard_normal(lead + (l, n)).astype(f),
            rng.standard_normal(dim).astype(f))


@pytest.mark.parametrize("l,chunk", [(17, 4), (17, 64), (203, 8), (1, 4)])
def test_selective_scan_matches_jax_and_oracle(l, chunk):
    args = scan_inputs(l, (2,), l, 6, 4)
    got = tm.selective_scan(*map(T, args), chunk=chunk).numpy()
    want_jax = np.asarray(jm.selective_scan(*map(jnp.asarray, args)))
    want = _scan_oracle(*args)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_jax, atol=1e-5, rtol=1e-5)


def test_selective_scan_leading_axes_are_independent():
    """SS2D's four directions as one leading axis, each with its own a and d, equal four
    separate scans."""
    x, delta, _, b, c, _ = scan_inputs(3, (4, 1), 37, 5, 3)
    rng = np.random.default_rng(4)
    a = -rng.uniform(0.5, 16.0, (4, 1, 5, 3)).astype(np.float32)
    d = rng.standard_normal((4, 1, 5)).astype(np.float32)
    got = tm.selective_scan(*map(T, (x, delta, a, b, c, d)), chunk=8).numpy()
    for k in range(4):
        want = _scan_oracle(x[k], delta[k], a[k, 0], b[k], c[k], d[k, 0])
        np.testing.assert_allclose(got[k], want, atol=1e-5, rtol=1e-5)


def random_params(module, seed, *args):
    """Seeded parameters of the shapes ``module.init`` gives: kernels and the stacked SS2D
    matrices N(0, 1/fan_in), scales N(1, 0.1), every other vector N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if path[-1] in ("scale", "skip_scale", "skip_scale2") else 0.0) \
            + 0.1 * rng.standard_normal(s.shape)

    return unflatten_dict({p: draw(p, s).astype(np.float32)
                           for p, s in flatten_dict(shapes).items()})


def test_mambair_matches_jax():
    kw = dict(embed_dim=24, depths=(2, 2), d_state=4)
    lr = np.random.default_rng(5).uniform(size=(1, 12, 16, 3)).astype(np.float32)
    jmodel = jm.MambaIR(**kw)
    params = random_params(jmodel, 6, jnp.asarray(lr))
    want_sr, want_deep = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(
        params, jnp.asarray(lr))
    model = tm.MambaIR(**kw).eval()
    model.load_state_dict(mambair_params_from_flax(params, model), strict=True)
    with torch.no_grad():
        sr, deep = model(T(lr))
    assert sr.shape == (1, 48, 64, 3) and deep.shape == (1, 12, 16, 24)
    np.testing.assert_allclose(sr.numpy(), np.asarray(want_sr), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(deep.numpy(), np.asarray(want_deep), atol=5e-5, rtol=1e-4)


def test_mambair_key_matches_jax():
    shapes = jax.eval_shape(jm.MambaIR(embed_dim=16, depths=(2, 2), d_state=4).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    paths = list(flatten_dict(shapes))
    assert [mambair_key(p) for p in paths] == [mambair_key_fn(p) for p in paths]
    own = set(tm.MambaIR(embed_dim=16, depths=(2, 2), d_state=4).state_dict())
    assert own == {mambair_key(p) for p in paths}
