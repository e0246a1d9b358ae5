"""Port parity for the fusion head: each module of freqfusion_tpu_torch's head against its
JAX twin from ``fusion_params_from_flax``, then the whole ``FusionHead``.

Every JAX parameter is moved off its initial value (LN / BN affines, residual scales and
biases are not ones and zeros) and BatchNorm's running statistics are randomised.
Tolerances: 5e-5 on a module, 2e-4 on the head (PARITY.md's bound for the head).
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.models import edge as jedge
from freqfusion_tpu.models import fusion as jfusion
from freqfusion_tpu.models import fusion_blocks as jblocks
from freqfusion_tpu.models import hierarchical as jhier
from freqfusion_tpu.models import lka as jlka
from freqfusion_tpu.utils.convert import fusion_key_fn
from freqfusion_tpu_torch.models import edge as tedge
from freqfusion_tpu_torch.models import fusion as tfusion
from freqfusion_tpu_torch.models import fusion_blocks as tblocks
from freqfusion_tpu_torch.models import hierarchical as thier
from freqfusion_tpu_torch.models import lka as tlka
from freqfusion_tpu_torch.utils.convert import fusion_key, fusion_params_from_flax

torch.set_num_threads(2)
T = torch.from_numpy
NAMES = ("hat", "dat", "nafnet")


def randomized(variables, seed):
    """A JAX variables dict with every leaf random: params + N(0, 0.1) (scalars + N(0,
    0.05)), running means + N(0, 0.1), running variances x U(0.6, 1.4)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        if path[-1] == "var":
            return (a * rng.uniform(0.6, 1.4, a.shape)).astype(np.float32)
        std = 0.05 if a.ndim == 0 else 0.1
        return (a + std * rng.standard_normal(a.shape)).astype(np.float32)

    return {col: unflatten_dict({p: move(p, a) for p, a in flatten_dict(tree).items()})
            for col, tree in variables.items()}


def load(tm, variables, prefix=None):
    """Loads the JAX variables into the port's module, strictly."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    if prefix:   # key functions that depend on the parent's name see it
        params, stats = {prefix: params}, ({prefix: stats} if stats else {})
    sd = fusion_params_from_flax(params, stats)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    tm.load_state_dict(sd, strict=True)
    return tm.eval()


def jarr(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tarr(tree):
    return jax.tree_util.tree_map(T, tree)


def head_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    up = np.kron(lr, np.ones((1, 4, 4, 1), np.float32))
    outs = {n: np.clip(up + 0.1 * rng.standard_normal(up.shape), 0, 1).astype(np.float32)
            for n in NAMES}
    feats = {n: rng.standard_normal((1, h, w, c)).astype(np.float32)
             for n, c in zip(NAMES, (180, 180, 64))}
    return lr, outs, feats


def test_cross_band_with_lka_matches_jax():
    rng = np.random.default_rng(0)
    bands = [(0.3 * rng.standard_normal((1, 24, 40, 3))).astype(np.float32) for _ in range(9)]
    jm = jlka.EnhancedCrossBandWithLKA()
    v = randomized(jm.init(jax.random.PRNGKey(0), jarr(bands)), 1)
    tm = load(tlka.EnhancedCrossBandWithLKA(), v)
    want = jm.apply(v, jarr(bands))
    with torch.no_grad():
        got = tm(tarr(bands))
        tm.kernels = tm.lka_block.lka.kernels = False   # the plain versions, forced
        plain = tm(tarr(bands))
    assert len(got) == 9
    for g, p, w in zip(got, plain, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)
        np.testing.assert_array_equal(g.numpy(), p.numpy())


def test_collaborative_with_lka_matches_jax():
    _, outs, feats = head_inputs(16, 24, 2)
    jm = jlka.EnhancedCollaborativeWithLKA()
    v = randomized(jm.init(jax.random.PRNGKey(0), jarr(feats), [jarr(outs[n]) for n in NAMES]), 3)
    tm = load(tlka.EnhancedCollaborativeWithLKA(), v)
    want = jm.apply(v, jarr(feats), [jarr(outs[n]) for n in NAMES])
    with torch.no_grad():
        got = tm(tarr(feats), [T(outs[n]) for n in NAMES])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)


def test_hierarchical_fusion_matches_jax():
    _, outs, _ = head_inputs(12, 16, 4)
    jm = jhier.HierarchicalFusion()
    v = randomized(jm.init(jax.random.PRNGKey(0), jarr(outs)), 5)
    tm = load(thier.HierarchicalFusion(), v)
    with torch.no_grad():
        got = tm(tarr(outs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(v, jarr(outs))), atol=5e-5)


def test_laplacian_edge_refinement_matches_jax():
    sr = np.random.default_rng(6).uniform(size=(1, 48, 64, 3)).astype(np.float32)
    jm = jedge.LaplacianEdgeRefinement()
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(sr)), 7)
    tm = load(tedge.LaplacianEdgeRefinement(), v, prefix="edge_refine")
    with torch.no_grad():
        got = tm(T(sr))
    want = np.asarray(jm.apply(v, jnp.asarray(sr)))
    assert np.abs(want - sr).max() > 1e-3   # the enhancement does something
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    np.testing.assert_allclose(
        tedge.gaussian_blur(T(sr)).numpy(), np.asarray(jedge.gaussian_blur(jnp.asarray(sr))),
        atol=2e-6)


def test_multiscale_and_dynamic_selector_match_jax():
    lr = np.random.default_rng(8).uniform(size=(2, 24, 40, 3)).astype(np.float32)
    jms = jblocks.MultiScaleFeatureExtractor()
    vms = randomized(jms.init(jax.random.PRNGKey(0), jnp.asarray(lr)), 9)
    tms = load(tblocks.MultiScaleFeatureExtractor(), vms, prefix="multiscale")
    routing = jms.apply(vms, jnp.asarray(lr))
    with torch.no_grad():
        got = tms(T(lr))
    np.testing.assert_allclose(got.numpy(), np.asarray(routing), atol=5e-5)

    jsel = jblocks.DynamicExpertSelector()
    vsel = randomized(jsel.init(jax.random.PRNGKey(1), jnp.asarray(lr), routing), 10)
    tsel = load(tblocks.DynamicExpertSelector(), vsel)
    gates, difficulty = map(np.asarray, jsel.apply(vsel, jnp.asarray(lr), routing))
    with torch.no_grad():
        tg, td = tsel(T(lr), T(np.array(routing)))
    np.testing.assert_allclose(td.numpy(), difficulty, atol=5e-5)
    # The selector has a step: a gate within 1% of its pixel's maximum is floored at 0.9. A
    # gate that sits on the step may be floored in one package and not in the other, so a
    # gate may differ only where one side holds the floor value itself, and in at most
    # 0.5% of the gates.
    got_gates = tg.numpy()
    differs = np.abs(got_gates - gates) > 1e-4
    floor = np.float32(0.9)
    assert ((got_gates[differs] == floor) | (gates[differs] == floor)).all()
    assert differs.mean() <= 0.005
    assert (gates.max(-1) >= floor).all() and (got_gates.max(-1) >= floor).all()


def test_refine_net_matches_jax():
    lr, outs, _ = head_inputs(12, 16, 11)
    fused = outs["hat"]
    jm = jfusion.RefineNet()
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(fused), jnp.asarray(lr)), 12)
    sd = fusion_params_from_flax({"refine_net": v["params"]})
    assert set(sd) == {"residual_scale"} | {f"refine_net.{2 * i}.{leaf}" for i in range(4)
                                            for leaf in ("weight", "bias")}
    net = tfusion.RefineNet()
    net.load_state_dict({k[len("refine_net."):]: t for k, t in sd.items()
                         if k.startswith("refine_net.")}, strict=True)
    holder = types.SimpleNamespace(refine_net=net.eval(), residual_scale=sd["residual_scale"])
    with torch.no_grad():
        got = tfusion.FusionHead.refine(holder, T(fused), T(lr))
    want = np.asarray(jm.apply(v, jnp.asarray(fused), jnp.asarray(lr)))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def jax_head(cfg_kwargs, lr, outs, feats, seed):
    jm = jfusion.FusionHead(jfusion.FusionConfig(**cfg_kwargs))
    v = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(lr), jarr(outs), jarr(feats)), seed)
    return jm, v


def test_fusion_head_shipped_config_matches_jax():
    lr, outs, feats = head_inputs(24, 40, 13)
    jm, v = jax_head({}, lr, outs, feats, 14)
    tm = tfusion.FusionHead(tfusion.FusionConfig())

    # the head's keys are the reference's, as both packages' key functions give them; the
    # JAX trees hold no counterpart of nn.BatchNorm2d's num_batches_tracked counters
    paths = [p for col in v.values() for p in flatten_dict(col)]
    want_keys = {fusion_key_fn(p) for p in paths}
    assert {fusion_key(p) for p in paths} == want_keys
    assert {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")} == want_keys

    load(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(lr), jarr(outs)))
    with torch.no_grad():
        got = tm(T(lr), tarr(outs))
    assert got.shape == (1, 96, 160, 3)
    assert ((want > 0) & (want < 1)).mean() > 0.5   # not saturated by the clamp
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)

    # with features, the collaborative branch runs too
    want_f = np.asarray(jm.apply(v, jnp.asarray(lr), jarr(outs), jarr(feats)))
    with torch.no_grad():
        got_f = tm(T(lr), tarr(outs), tarr(feats))
    assert np.abs(want_f - want).max() > 1e-4
    np.testing.assert_allclose(got_f.numpy(), want_f, atol=2e-4)

    # state_dict -> load_state_dict round-trips into a fresh head
    fresh = tfusion.FusionHead(tfusion.FusionConfig()).eval()
    fresh.load_state_dict(tm.state_dict(), strict=True)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(T(lr), tarr(outs)).numpy(), got.numpy())


FLAG_OFF = {
    "no_lka": dict(enable_lka=False),
    "dct_bands_adaptive": dict(enable_multi_domain_freq=False),
    "dct_bands_fixed": dict(enable_multi_domain_freq=False, enable_adaptive_bands=False,
                            enable_cross_band_attn=False, enable_edge_enhance=False),
    "flat_router": dict(enable_hierarchical=False, enable_multi_resolution=False,
                        enable_dynamic_selection=False),
}


@pytest.mark.parametrize("name", sorted(FLAG_OFF))
def test_fusion_head_flag_off_branches_match_jax(name):
    lr, outs, feats = head_inputs(16, 24, 15)
    jm, v = jax_head(FLAG_OFF[name], lr, outs, feats, 16)
    paths = [p for col in v.values() for p in flatten_dict(col)]
    assert {fusion_key(p) for p in paths} == {fusion_key_fn(p) for p in paths}
    tm = load(tfusion.FusionHead(tfusion.FusionConfig(**FLAG_OFF[name])), v)
    want = np.asarray(jm.apply(v, jnp.asarray(lr), jarr(outs), jarr(feats)))
    with torch.no_grad():
        got = tm(T(lr), tarr(outs), tarr(feats))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_multi_resolution_branch_is_named_as_not_ported():
    """The multi-resolution branch is ported now (test_torch_fusion_variants.py holds it
    against the JAX head): the head builds MultiResolutionFusion where the JAX head does,
    and refuses nothing."""
    from freqfusion_tpu_torch.models.fusion_variants import MultiResolutionFusion
    head = tfusion.FusionHead(tfusion.FusionConfig(enable_hierarchical=False))
    assert isinstance(head.multi_res_fusion, MultiResolutionFusion)
    flat = tfusion.FusionHead(tfusion.FusionConfig(enable_hierarchical=False,
                                                   enable_multi_resolution=False))
    assert not hasattr(flat, "multi_res_fusion") and hasattr(flat, "freq_router")
