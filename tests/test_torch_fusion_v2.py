"""Port parity for ``models/fusion_v2.py``: each V2 block and ``FusionHeadV2`` (LR
[2,16,24,3], experts at x4, with and without expert features, eval mode) against the JAX
twin within 2e-4, the head's bound. Weights: seeded random variables of the JAX modules'
shapes, carried across by ``utils/convert.py:fusion_v2_params_from_flax``; the key
function against the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import fusion_v2 as jv2
from freqfusion_tpu.utils.convert import v2_key_fn
from freqfusion_tpu_torch.models import fusion_v2 as tv2
from freqfusion_tpu_torch.utils.convert import fusion_v2_params_from_flax, v2_key

torch.set_num_threads(2)
T = torch.from_numpy
NAMES = ("hat", "dat", "nafnet")
CHANNELS = {"hat": 180, "dat": 180, "nafnet": 64}
TOL = dict(atol=2e-4, rtol=2e-4)
# the head's own scalars and vectors, drawn around their initial values
INIT = {"temperature": 10.0, "res_weight_128": 0.5, "res_weight_256": 0.3,
        "residual_scale": 0.1, "band_gates": 1.0, "scale": 1.0}


def random_params(module, seed, *args, **kw):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, **kw), jax.random.PRNGKey(0),
                            *args)["params"]

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return INIT.get(path[-1], 0.0) + 0.1 * rng.standard_normal(s.shape)

    return unflatten_dict({p: draw(p, s).astype(np.float32)
                           for p, s in flatten_dict(shapes).items()})


def inputs(seed, b=2, h=16, w=24):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    outs = {n: np.clip(np.repeat(np.repeat(lr, 4, 1), 4, 2)
                       + 0.1 * rng.standard_normal((b, 4 * h, 4 * w, 3)), 0, 1).astype(np.float32)
            for n in NAMES}
    feats = {n: (0.5 * rng.standard_normal((b, h, w, c))).astype(np.float32)
             for n, c in CHANNELS.items()}
    return lr, outs, feats


def run_pair(jmodule, tmodule, seed, args, init_args=None, **kw):
    """(port output, JAX output) of the two modules on the same args (nested numpy), the
    JAX params drawn for `init_args` (args by default) and carried across."""
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)   # noqa: E731
    to_t = lambda t: jax.tree_util.tree_map(T, t)             # noqa: E731
    params = random_params(jmodule, seed, *to_j(init_args or args), **kw)
    want = jax.jit(lambda p, *a: jmodule.apply({"params": p}, *a, **kw))(params, *to_j(args))
    tmodule.load_state_dict(fusion_v2_params_from_flax(params, tmodule), strict=True)
    with torch.no_grad():
        got = tmodule.eval()(*to_t(args))
    return got, want


def close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_adaptive_decomposition_matches_jax():
    lr, _, _ = inputs(1)
    got, want = run_pair(jv2.AdaptiveFrequencyDecompositionV2(),
                         tv2.AdaptiveFrequencyDecompositionV2(), 2, (lr,))
    close(got, want)
    np.testing.assert_allclose((got[0] + got[1] + got[2]).numpy(), lr, atol=1e-3)


def test_cross_band_attention_matches_jax():
    rng = np.random.default_rng(3)
    bands = [rng.uniform(size=(2, 16, 24, 3)).astype(np.float32) for _ in range(3)]
    close(*run_pair(jv2.CrossBandAttentionV2(), tv2.CrossBandAttentionV2(), 4, (bands,)))


def test_collaborative_matches_jax():
    _, outs, feats = inputs(5)
    close(*run_pair(jv2.CollaborativeFeatureLearningV2(), tv2.CollaborativeFeatureLearningV2(),
                    6, (feats, [outs[n] for n in NAMES])))


def test_multi_resolution_matches_jax():
    lr, outs, _ = inputs(7)
    close(*run_pair(jv2.MultiResolutionFusionV2(), tv2.MultiResolutionFusionV2(), 8,
                    (lr, [outs[n] for n in NAMES])))


def test_dynamic_selector_matches_jax():
    lr, _, _ = inputs(9)
    close(*run_pair(jv2.DynamicExpertSelectorV2(), tv2.DynamicExpertSelectorV2(), 10, (lr,)))


@pytest.mark.parametrize("with_features", [True, False])
def test_fusion_head_v2_matches_jax(with_features):
    lr, outs, feats = inputs(11)
    args = (lr, outs, feats) if with_features else (lr, outs)
    # one parameter tree for both calls: the JAX head holds no collaborative block when it
    # is initialised without features, the port's always does
    got, want = run_pair(jv2.FusionHeadV2(), tv2.FusionHeadV2(), 12, args,
                         init_args=(lr, outs, feats))
    assert got.shape == (2, 64, 96, 3)
    close(got, want)


def test_fusion_head_v2_without_multi_resolution_matches_jax():
    lr, outs, feats = inputs(13)
    kw = dict(enable_multi_resolution=False, enable_cross_band_attn=False)
    close(*run_pair(jv2.FusionHeadV2(**kw), tv2.FusionHeadV2(**kw), 14, (lr, outs),
                    init_args=(lr, outs, feats)))


def test_v2_key_matches_jax():
    lr, outs, feats = inputs(15, b=1, h=8, w=8)
    shapes = jax.eval_shape(jv2.FusionHeadV2(enable_multi_resolution=False).init,
                            jax.random.PRNGKey(0), lr, outs, feats)["params"]
    shapes.update(jax.eval_shape(jv2.FusionHeadV2().init, jax.random.PRNGKey(0), lr, outs,
                                 feats)["params"])
    paths = list(flatten_dict(shapes))
    assert [v2_key(p) for p in paths] == [v2_key_fn(p) for p in paths]
    own = set(tv2.FusionHeadV2().state_dict()) | set(
        tv2.FusionHeadV2(enable_multi_resolution=False).state_dict())
    assert own == {v2_key(p) for p in paths}
