"""Port parity for the perceptual losses: VGG19 (published widths, small images) and CLIP
(a small ViT) against their JAX twins, values and gradients with respect to the prediction
(``jax.grad`` on the JAX side) within 2e-4 relative; ``CombinedLoss`` live through
temporary random checkpoints named by the variables, and its ladder on malformed ones (a
warning, and the weight moved to FFT, as in the JAX package)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu import losses as JL
from freqfusion_tpu.losses import clip as jclip
from freqfusion_tpu.losses import vgg as jvgg
from freqfusion_tpu.utils import clipiqa as jclipiqa
from freqfusion_tpu_torch import losses as TL
from freqfusion_tpu_torch.losses import clip as tclip
from freqfusion_tpu_torch.losses import vgg as tvgg
from freqfusion_tpu_torch.utils import clipiqa as tclipiqa
from freqfusion_tpu_torch.utils import convert as cv

torch.set_num_threads(2)
T = torch.from_numpy
RTOL = 2e-4


def random_params(module, seed, *args):
    """Seeded parameters of the shapes ``module.init`` gives (no init forward is traced):
    kernels and tables N(0, 1/fan_in) over their leading axes, scales N(1, 0.1), every
    other vector or scalar N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]

    def draw(path, s):
        if len(s.shape) >= 2:
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if path[-1] == "scale" else 0.0) + 0.1 * rng.standard_normal(s.shape)

    return unflatten_dict({p: draw(p, s).astype(np.float32)
                           for p, s in flatten_dict(shapes).items()})


def pair(seed, b=2, h=32, w=40):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(target.shape), -0.05, 1.05)
    return pred.astype(np.float32), target


def torch_value_and_grad(fn, pred, target):
    p = T(pred.copy()).requires_grad_(True)
    v = fn(p, T(target))
    g = (torch.autograd.grad(v, p)[0] if v.requires_grad else torch.zeros_like(p))
    return float(v.detach()), g.numpy()


def assert_value_and_grad(tv, tg, jv, jg):
    assert abs(tv - jv) <= RTOL * abs(jv), (tv, jv)
    assert np.abs(tg - jg).max() <= RTOL * max(np.abs(jg).max(), 1e-30)


@pytest.fixture(scope="module")
def vgg19():
    """(JAX VGG19Features params to relu4_4, the port's state dict of them)."""
    jm = jvgg.VGG19Features(("relu2_2", "relu3_4", "relu4_4"))
    params = random_params(jm, 0, jnp.zeros((1, 32, 32, 3)))
    sd = cv.vgg19_params_from_flax(params, tvgg.VGG19Features())
    return params, sd


def vgg_grad64(sd, pred, target, criterion="l1"):
    """The port's VGG loss gradient in float64, on the same weights."""
    model = tvgg.VGG19Features().double()
    model.load_state_dict({k: v.double() for k, v in sd.items()})
    p = T(pred.astype(np.float64)).requires_grad_(True)
    tvgg.VGGPerceptualLoss(criterion=criterion, model=model)(
        p, T(target.astype(np.float64))).backward()
    return p.grad.numpy()


def test_vgg_loss_and_gradient_match_jax(vgg19):
    params, sd = vgg19
    tm = tvgg.VGG19Features()
    tm.load_state_dict(sd)
    assert set(sd) == {jvgg.vgg_key_fn(p) for p in flatten_dict(params)}
    pred, target = pair(1)
    for criterion in ("l1", "l2"):
        jl = jvgg.VGGPerceptualLoss(criterion=criterion, params={"params": params})
        tl = tvgg.VGGPerceptualLoss(criterion=criterion, model=tm)
        jv, jg = jax.jit(jax.value_and_grad(lambda p: jl(p, jnp.asarray(target))))(
            jnp.asarray(pred))
        jg = np.asarray(jg)
        # oneDNN's f32 conv backward on the CPU lies up to 4.5e-3 of max|g| from a float64
        # evaluation of this loss (torch's own conv backward: 3e-7)
        with torch.backends.mkldnn.flags(enabled=False):
            tv, tg = torch_value_and_grad(tl, pred, target)
        assert abs(tv - float(jv)) <= RTOL * abs(float(jv))
        # L1's gradient jumps where a feature difference crosses 0: on these weights JAX's
        # own f32 gradient lies up to 4.3e-4 of max|g| from the float64 one (the port's 2.5e-7),
        # so the bound is 2e-4 of max|g| plus JAX's own distance from float64
        own = np.abs(jg - vgg_grad64(sd, pred, target, criterion)).max()
        assert np.abs(tg - jg).max() <= RTOL * np.abs(jg).max() + own
        assert np.abs(tg).max() > 0
    # the target gets no gradient
    p, t = T(pred.copy()).requires_grad_(True), T(target.copy()).requires_grad_(True)
    tl(p, t).backward()
    assert t.grad is None and p.grad is not None


V_CFG = dict(patch=32, width=64, layers=2, heads=1, output_dim=32)
T_CFG = dict(width=32, heads=1, layers=2, context=16, output_dim=32)
MERGES = [("h", "i"), ("hi", "gh</w>"), ("q", "u"), ("qu", "a"), ("b", "l"), ("bl", "u"),
          ("s", "h"), ("sh", "a"), ("r", "p</w>"), ("p", "h"), ("ph", "o"), ("t", "o")]


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    """A small OpenAI-layout CLIP checkpoint with its text tower, its BPE vocabulary, and
    the JAX vision tower and params."""
    d = tmp_path_factory.mktemp("clip")
    bpe = str(d / "bpe.txt")
    with open(bpe, "w") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    vocab = jclipiqa.SimpleBPETokenizer(bpe).vocab_size
    jv = jclip.CLIPVisionTransformer(**V_CFG)
    jt = jclipiqa.CLIPTextTransformer(vocab_size=vocab, **T_CFG)
    vp = random_params(jv, 1, jnp.zeros((1, 224, 224, 3)))
    tp = random_params(jt, 2, jnp.zeros((1, 16), jnp.int32))
    sd = {**cv.clip_vision_params_from_flax(vp, tclip.CLIPVisionTransformer(**V_CFG)),
          **cv.clip_text_params_from_flax(
              tp, tclipiqa.CLIPTextTransformer(vocab_size=vocab, **T_CFG))}
    path = str(d / "clip.pth")
    torch.save(sd, path)
    return path, bpe, jv, vp, sd


def test_clip_loss_and_gradient_match_jax(clip_ckpt, tmp_path):
    path, bpe, jv, vp, sd = clip_ckpt
    rng = np.random.default_rng(3)
    pos, neg = (rng.standard_normal((5, 32)).astype(np.float32) for _ in range(2))
    tv_model = tclip.CLIPVisionTransformer(**V_CFG)
    cv.load_tower_state(tv_model, sd, prefix="visual.")
    jl = jclip.CLIPPerceptualLoss(params={"params": vp}, pos_features=pos, neg_features=neg,
                                  model=jv)
    tl = tclip.CLIPPerceptualLoss(model=tv_model, pos_features=pos, neg_features=neg)
    pred, target = pair(4, b=3, h=48, w=64)
    jv_, jg = jax.jit(jax.value_and_grad(lambda p: jl(p, jnp.asarray(target))))(
        jnp.asarray(pred))
    tv_, tg = torch_value_and_grad(tl, pred, target)
    assert float(jv_) > 0
    # no gradient through CLIP in either package (the reference encodes under no_grad)
    assert not np.asarray(jg).any()
    assert_value_and_grad(tv_, tg, float(jv_), np.asarray(jg))

    # a stock checkpoint: the prompts embedded through its text tower with the BPE
    jl2 = jclip.CLIPPerceptualLoss(weights_path=path, bpe_path=bpe)
    tl2 = tclip.CLIPPerceptualLoss(weights_path=path, bpe_path=bpe)
    close = lambda a, b: abs(a - b) <= RTOL * abs(b)
    assert close(float(tl2(T(pred))), float(jl2(jnp.asarray(pred))))
    # a vision-only checkpoint carrying precomputed prompt features loads
    vision_only = {k: v for k, v in sd.items() if k.startswith("visual.")}
    vision_only.update(positive_features=T(pos), negative_features=T(neg))
    vpath = str(tmp_path / "vision_only.pth")
    torch.save(vision_only, vpath)
    tl3 = tclip.CLIPPerceptualLoss(weights_path=vpath)
    assert close(float(tl3(T(pred))), float(jv_))
    assert close(float(tl3(T(pred))), float(jclip.CLIPPerceptualLoss(weights_path=vpath)(
        jnp.asarray(pred))))


def test_combined_loss_live_through_named_checkpoints(vgg19, clip_ckpt, tmp_path, monkeypatch):
    _, sd = vgg19
    vgg_path = str(tmp_path / "vgg19.pth")
    torch.save({"feature_extractor.vgg_layers." + k[len("features."):]: v
                for k, v in sd.items()}, vgg_path)
    clip_path, bpe, *_ = clip_ckpt
    monkeypatch.setenv("FREQFUSION_VGG19_WEIGHTS", vgg_path)
    monkeypatch.setenv("FREQFUSION_CLIP_WEIGHTS", clip_path)
    monkeypatch.setenv("FREQFUSION_CLIP_BPE", bpe)
    weights = {"l1": 1.0, "vgg": 0.1, "clip": 0.05, "fft": 0.0, "swt": 0.0, "charbonnier": 0.0,
               "l2": 0.0, "edge": 0.0, "ssim": 0.0}
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # nothing moves to FFT
        jc, tc = JL.CombinedLoss(weights), TL.CombinedLoss(weights)
    assert tc.weights == jc.weights and tc.weights["vgg"] == 0.1
    pred, target = pair(5)
    (jt, jcomp), jg = jax.jit(jax.value_and_grad(
        lambda p: jc(p, jnp.asarray(target)), has_aux=True))(jnp.asarray(pred))
    p = T(pred.copy()).requires_grad_(True)
    with torch.backends.mkldnn.flags(enabled=False):   # see the VGG test
        tt, tcomp = tc(p, T(target))
        tt.backward()
    assert sorted(tcomp) == sorted(jcomp) == ["clip", "l1", "total", "vgg"]
    for k in tcomp:
        assert abs(float(tcomp[k]) - float(jcomp[k])) <= RTOL * abs(float(jcomp[k])), k
    # the VGG term's share of JAX's own f32 error (see the VGG test)
    jvgg_g = jax.grad(lambda q: jc._vgg(q, jnp.asarray(target)))(jnp.asarray(pred))
    own = 0.1 * np.abs(np.asarray(jvgg_g) - vgg_grad64(sd, pred, target)).max()
    jg = np.asarray(jg)
    assert np.abs(p.grad.numpy() - jg).max() <= RTOL * np.abs(jg).max() + own


@pytest.mark.parametrize("fault", ["missing_key", "wrong_size"])
def test_malformed_checkpoint_warns_and_moves_weight_to_fft(vgg19, tmp_path, monkeypatch, fault):
    _, sd = vgg19
    bad = dict(sd)
    if fault == "missing_key":
        del bad["features.7.bias"]
    else:
        bad["features.7.weight"] = bad["features.7.weight"][:64]
    path = str(tmp_path / "vgg19.pth")
    torch.save(bad, path)
    monkeypatch.setenv("FREQFUSION_VGG19_WEIGHTS", path)
    monkeypatch.delenv("FREQFUSION_CLIP_WEIGHTS", raising=False)
    weights = {"l1": 1.0, "vgg": 0.1, "fft": 0.05}
    with pytest.warns(UserWarning) as tw:
        tc = TL.CombinedLoss(weights)
    with pytest.warns(UserWarning) as jw:
        jc = JL.CombinedLoss(weights)
    assert any("checkpoint rejected" in str(w.message) for w in tw)
    assert any("rejected" in str(w.message) for w in jw)
    assert tc.weights == jc.weights
    assert tc.weights["vgg"] == 0.0 and abs(tc.weights["fft"] - 0.15) < 1e-12
