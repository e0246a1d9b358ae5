"""Port parity for ``models/fusion_variants.py`` (each class within atol 5e-5 + rtol 1e-4 of
its JAX twin) and for the fusion head at ``FusionConfig(enable_hierarchical=False)``, whose
phase 5 is ``MultiResolutionFusion`` (within 2e-4, the head's bound in PARITY.md).

Weights: seeded random variables of the JAX modules' shapes (no parameter or BatchNorm
statistic at an initial value), carried across by
``utils/convert.py:fusion_params_from_flax``. The JAX modules run through ``jax.jit``; the
head's JAX twin with its plain reference in place of the Pallas kernels
(``use_pallas=False``), as the JAX package's own tests run it on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import fusion as jfusion
from freqfusion_tpu.models import fusion_variants as jfv
from freqfusion_tpu.utils.convert import fusion_key_fn
from freqfusion_tpu_torch.models import fusion as tfusion
from freqfusion_tpu_torch.models import fusion_variants as tfv
from freqfusion_tpu_torch.utils.convert import fusion_key, fusion_params_from_flax

torch.set_num_threads(2)
T = torch.from_numpy
NAMES = ("hat", "dat", "nafnet")


def random_variables(module, seed, *args, **kw):
    """Seeded variables of the shapes ``module.init`` gives (no init forward is traced):
    kernels N(0, 1/fan_in), scales N(1, 0.1), running variances U(0.6, 1.4), every other
    vector or scalar N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k, *a: module.init(k, *a, **kw), jax.random.PRNGKey(0),
                            *args)

    def draw(path, s):
        if path[-1] == "var":
            return rng.uniform(0.6, 1.4, s.shape)
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if path[-1] == "scale" else 0.0) + 0.1 * rng.standard_normal(s.shape)

    return {col: unflatten_dict({p: draw(p, s).astype(np.float32)
                                 for p, s in flatten_dict(tree).items()})
            for col, tree in shapes.items()}


def inputs(h, w, seed, hr=None):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    hh, ww = hr or (4 * h, 4 * w)
    up = np.asarray(jax.image.resize(lr, (1, hh, ww, 3), "nearest"))
    outs = [np.clip(up + 0.1 * rng.standard_normal(up.shape), 0, 1).astype(np.float32)
            for _ in NAMES]
    return lr, outs


def load(tm, variables, prefix):
    """The JAX variables into the port's module, strictly; `prefix` is the module's name in
    the head, which the key function reads."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = fusion_params_from_flax({prefix: params}, {prefix: stats} if stats else {})
    sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    tm.load_state_dict(sd, strict=True)
    return tm.eval()


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)


def run_pair(jm, tm, prefix, seed, lr, expert_arg, **kw):
    variables = random_variables(jm, seed, jnp.asarray(lr), expert_arg(jnp.asarray), **kw)
    load(tm, variables, prefix)
    want = jax.jit(lambda v, x, e: jm.apply(v, x, e, **kw))(
        variables, jnp.asarray(lr), expert_arg(jnp.asarray))
    with torch.no_grad():
        got = tm(T(lr), expert_arg(T), **kw)
    return got, want


@pytest.mark.parametrize("use_residual,use_multiscale", [(True, True), (False, False)])
def test_frequency_aware_fusion_matches_jax(use_residual, use_multiscale):
    lr, outs = inputs(12, 16, 1)
    got, want = run_pair(jfv.FrequencyAwareFusion(use_residual=use_residual,
                                                  use_multiscale=use_multiscale),
                         tfv.FrequencyAwareFusion(use_residual=use_residual,
                                                  use_multiscale=use_multiscale),
                         "fusion", 2, lr, lambda f: [f(o) for o in outs])
    assert got.shape == (1, 48, 64, 3)
    assert ((want > 0) & (want < 1)).mean() > 0.5   # not saturated by the clamp
    close(got, want)


def test_multi_resolution_fusion_matches_jax():
    lr, outs = inputs(20, 24, 3)
    got, want = run_pair(jfv.MultiResolutionFusion(), tfv.MultiResolutionFusion(),
                         "multi_res_fusion", 4, lr, lambda f: [f(o) for o in outs])
    assert got.shape == (1, 80, 96, 3)
    close(got, want)
    # a target size other than the experts' resizes the result
    got, want = run_pair(jfv.MultiResolutionFusion(), tfv.MultiResolutionFusion(),
                         "multi_res_fusion", 4, lr, lambda f: [f(o) for o in outs],
                         target_size=64)
    assert got.shape == (1, 64, 64, 3)
    close(got, want)


@pytest.mark.parametrize("multi_res", [False, True])
def test_wrappers_match_jax(multi_res):
    lr, outs = inputs(16, 16, 5)
    # the wrappers take the dict's values in its order; jax.jit hands a dict over with its
    # keys sorted, so the dict is built in that order
    names = sorted(NAMES)
    if multi_res:
        jm, tm = (jfv.EnhancedMultiFusionSR(use_multi_resolution=True),
                  tfv.EnhancedMultiFusionSR(use_multi_resolution=True))
    else:
        jm, tm = jfv.MultiFusionSR(), tfv.MultiFusionSR()
    arg = dict(zip(names, outs))
    variables = random_variables(jm, 6, jnp.asarray(lr),
                                 {n: jnp.asarray(o) for n, o in arg.items()})
    sd = fusion_params_from_flax(variables["params"], variables.get("batch_stats", {}))
    tm.load_state_dict(sd, strict=True)
    want = jax.jit(jm.apply)(variables, jnp.asarray(lr),
                             {n: jnp.asarray(o) for n, o in arg.items()})
    with torch.no_grad():
        got = tm.eval()(T(lr), {n: T(o) for n, o in arg.items()})
    close(got, want)


def test_fusion_head_multi_resolution_matches_jax():
    """C16: the head at FusionConfig(enable_hierarchical=False) builds the flat
    multi-resolution fusion where the JAX head does, and matches it within 2e-4."""
    lr, outs = inputs(24, 40, 13)
    rng = np.random.default_rng(15)
    feats = {n: jnp.asarray(rng.standard_normal((1, 24, 40, c)).astype(np.float32))
             for n, c in zip(NAMES, (180, 180, 64))}
    cfg = dict(enable_hierarchical=False)
    jm = jfusion.FusionHead(jfusion.FusionConfig(use_pallas=False, **cfg))
    outs_d = dict(zip(NAMES, outs))
    # initialised with expert features, so that the collaborative branch has parameters
    variables = random_variables(jm, 14, jnp.asarray(lr),
                                 {n: jnp.asarray(o) for n, o in outs_d.items()}, feats)
    tm = tfusion.FusionHead(tfusion.FusionConfig(**cfg))
    assert isinstance(tm.multi_res_fusion, tfv.MultiResolutionFusion)
    paths = [p for col in variables.values() for p in flatten_dict(col)]
    keys = {fusion_key_fn(p) for p in paths}
    assert {fusion_key(p) for p in paths} == keys
    assert {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")} == keys
    tm.load_state_dict(fusion_params_from_flax(variables["params"], variables["batch_stats"]),
                       strict=True)
    want = jax.jit(jm.apply)(variables, jnp.asarray(lr),
                             {n: jnp.asarray(o) for n, o in outs_d.items()})
    with torch.no_grad():
        got = tm.eval()(T(lr), {n: T(o) for n, o in outs_d.items()})
    assert got.shape == (1, 96, 160, 3)
    assert ((np.asarray(want) > 0) & (np.asarray(want) < 1)).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
