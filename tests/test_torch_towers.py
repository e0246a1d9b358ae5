"""Port parity for the eval towers: LPIPS, DISTS, CLIP-IQA (with its tokenizer), MUSIQ and
MANIQA of freqfusion_tpu_torch against their JAX twins, and NIQE.

Each JAX module is initialised at small widths (LPIPS and DISTS at their published widths,
on small images), every parameter moved off its initial value, and carried across by
``utils/convert.py``'s ``*_params_from_flax``; the state dict is also saved as a .pth that
both packages' ``Native*`` towers load. Tolerances: features atol 5e-5 + rtol 1e-4, scores
1e-5 relative (MANIQA's 1e-4, see there); the tokenizer's ids, MANIQA's crops and NIQE are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from freqfusion_tpu.losses import clip as jclip
from freqfusion_tpu.utils import clipiqa as jclipiqa
from freqfusion_tpu.utils import dists as jdists
from freqfusion_tpu.utils import lpips as jlpips
from freqfusion_tpu.utils import maniqa as jmaniqa
from freqfusion_tpu.utils import musiq as jmusiq
from freqfusion_tpu.utils import niqe as jniqe
from freqfusion_tpu_torch.losses import clip as tclip
from freqfusion_tpu_torch.utils import clipiqa as tclipiqa
from freqfusion_tpu_torch.utils import convert as cv
from freqfusion_tpu_torch.utils import dists as tdists
from freqfusion_tpu_torch.utils import lpips as tlpips
from freqfusion_tpu_torch.utils import maniqa as tmaniqa
from freqfusion_tpu_torch.utils import musiq as tmusiq
from freqfusion_tpu_torch.utils import niqe as tniqe

torch.set_num_threads(2)
T = torch.from_numpy


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



def close(got, want, atol=5e-5, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def close_score(got, want, rtol=1e-5):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (got, want)


def images(seed, n, h, w):
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(n, h, w, 3))
    return (np.clip(base + 0.1 * rng.standard_normal(base.shape), 0, 1) * 255).astype(np.uint8)


def save(sd, path):
    torch.save(sd, str(path))
    return str(path)


# ---------------------------------------------------------------------------
# LPIPS and DISTS: published widths, small images
# ---------------------------------------------------------------------------

def test_lpips_matches_jax(tmp_path):
    a, b = images(0, 2, 72, 80)
    x0, x1 = (a[None].astype(np.float32) / 127.5 - 1.0), (b[None].astype(np.float32) / 127.5 - 1)
    jm = jlpips.AlexLPIPS()
    params = random_params(jm, 0, jnp.asarray(x0), jnp.asarray(x1))
    for k in range(5):   # the published heads are non-negative: no sum that cancels
        params[f"lin_{k}"] = np.abs(params[f"lin_{k}"])
    tm = tlpips.AlexLPIPS()
    sd = cv.lpips_params_from_flax(params, tm)
    assert set(sd) == set(tm.state_dict()) == {jlpips.lpips_key_fn(p)
                                               for p in flatten_dict(params)}
    tm.load_state_dict(sd)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x0), jnp.asarray(x1))
    with torch.no_grad():
        got = tm.eval()(T(x0), T(x1))
    close_score(got[0], want[0])
    # the checkpoint route: the .pth (trunk under net.) through the port's tower and loader
    path = save({"net." + k if k.startswith("features") else k: v for k, v in sd.items()},
                tmp_path / "lpips.pth")
    close_score(tlpips.NativeLPIPS(path, device="cpu")(a, b), want[0])


def test_dists_matches_jax(tmp_path):
    a, b = images(1, 2, 48, 40)
    x, y = a[None].astype(np.float32) / 255.0, b[None].astype(np.float32) / 255.0
    jm = jdists.VGG16L2Stages()
    params = random_params(jm, 1, jnp.asarray(x))
    rng = np.random.default_rng(2)
    alpha, beta = (rng.uniform(0.01, 0.2, sum(jdists.DISTS_STAGE_CHANNELS)).astype(np.float32)
                   for _ in range(2))
    tm = tdists.DISTS()
    sd = cv.dists_params_from_flax(params, alpha, beta, tm)
    tm.load_state_dict(sd)
    jfeats = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        tfeats = tdists.VGG16L2Stages.forward(tm.eval(), T(x))
    assert len(tfeats) == len(jfeats) == 6
    for jf, tf in zip(jfeats, tfeats):
        close(tf.permute(0, 2, 3, 1), jf)
    # the official layout: stageK.N trunk keys, alpha / beta as [1, sum C, 1, 1]
    official = {(f"stage{1 + sum(int(k.split('.')[1]) > e for e in tdists._STAGE_ENDS)}."
                 + k[len("features."):]) if k.startswith("features.") else k: v
                for k, v in sd.items()}
    path = save(official, tmp_path / "dists.pth")
    jt = jdists.NativeDISTS(params={"params": params}, alpha=alpha, beta=beta)
    close_score(tdists.NativeDISTS(path, device="cpu")(a, b), jt(a, b))


# ---------------------------------------------------------------------------
# CLIP-IQA: the tokenizer, both towers, the score
# ---------------------------------------------------------------------------

MERGES = [("o", "o"), ("oo", "d</w>"), ("g", "ood</w>"), ("b", "ad</w>"), ("p", "h"),
          ("ph", "o"), ("pho", "to"), ("t", "o"), ("photo", ".</w>"), ("t", "h"),
          ("th", "e</w>"), ("a", "n"), ("i", "n"), ("'", "s</w>"), ("c", "a"), ("é", "</w>")]
TEXTS = list(jclip.POSITIVE_PROMPTS) + list(jclip.NEGATIVE_PROMPTS) + [
    "Good photo.", "Bad photo.", "it's the cat's 2nd photo, isn't it?!", "we'll've 42 cats",
    "café naïve résumé ½ ²", "  &amp;lt;b&gt; HTML_escaped   ", "日本語 テキスト", "x" * 120]


def write_bpe(path):
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    return str(path)


def test_tokenizer_ids_equal_jax(tmp_path):
    bpe = write_bpe(tmp_path / "bpe.txt")
    jt, tt = jclipiqa.SimpleBPETokenizer(bpe), tclipiqa.SimpleBPETokenizer(bpe)
    assert tt.vocab_size == jt.vocab_size
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
    np.testing.assert_array_equal(tt.tokenize(TEXTS, 24), jt.tokenize(TEXTS, 24))


V_CFG = dict(patch=32, width=64, layers=2, heads=1, output_dim=32)
T_CFG = dict(width=32, heads=1, layers=2, context=16, output_dim=32)


def clip_checkpoint(tmp_path, seed):
    """A small OpenAI-layout CLIP state dict from seeded JAX towers: (path, vision params,
    text params, the port's towers loaded from it)."""
    bpe = write_bpe(tmp_path / "bpe.txt")
    vocab = jclipiqa.SimpleBPETokenizer(bpe).vocab_size
    jv = jclip.CLIPVisionTransformer(**V_CFG)
    jt = jclipiqa.CLIPTextTransformer(vocab_size=vocab, **T_CFG)
    vp = random_params(jv, seed, jnp.zeros((1, 224, 224, 3)))
    tp = random_params(jt, seed + 1, jnp.zeros((1, T_CFG["context"]), jnp.int32))
    tv = tclip.CLIPVisionTransformer(**V_CFG)
    tt = tclipiqa.CLIPTextTransformer(vocab_size=vocab, **T_CFG)
    sd = {**cv.clip_vision_params_from_flax(vp, tv), **cv.clip_text_params_from_flax(tp, tt),
          "logit_scale": torch.tensor(np.log(5.0), dtype=torch.float32)}
    tv.load_state_dict({k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")})
    tt.load_state_dict({k: v for k, v in sd.items() if not k.startswith(("visual.", "logit"))})
    return save(sd, tmp_path / "clip.pth"), bpe, (jv, vp), (jt, tp), (tv.eval(), tt.eval())


def test_clip_towers_and_clipiqa_match_jax(tmp_path):
    path, bpe, (jv, vp), (jt, tp), (tv, tt) = clip_checkpoint(tmp_path, 3)
    sd = cv.load_torch_checkpoint(path)
    assert {jclip.clip_key_fn(p) for p in flatten_dict(vp)} == {
        cv.clip_vision_key(p) for p in flatten_dict(vp)}
    assert {jclipiqa.clip_text_key_fn(p) for p in flatten_dict(tp)} == {
        cv.clip_text_key(p) for p in flatten_dict(tp)}
    x = np.random.default_rng(4).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ids = jclipiqa.SimpleBPETokenizer(bpe).tokenize(TEXTS[:4], T_CFG["context"])
    with torch.no_grad():
        close(tv(T(x)), jax.jit(jv.apply)({"params": vp}, jnp.asarray(x)))
        close(tt(T(ids).long()), jax.jit(jt.apply)({"params": tp}, jnp.asarray(ids)))
    # the architecture read back from the checkpoint's shapes
    iv, it = tclipiqa.infer_clip_config(sd)
    assert (iv.conv1.weight.shape, len(iv.transformer.resblocks)) == (
        tv.conv1.weight.shape, V_CFG["layers"])
    assert (it.context, len(it.transformer.resblocks)) == (T_CFG["context"], T_CFG["layers"])
    img = images(5, 1, 60, 90)[0]
    close_score(tclipiqa.NativeCLIPIQA(path, bpe, device="cpu")(img),
                jclipiqa.NativeCLIPIQA(path, bpe)(img))


# ---------------------------------------------------------------------------
# MUSIQ
# ---------------------------------------------------------------------------

MUSIQ_CFG = dict(hidden=64, layers=2, heads=1, mlp_dim=96, root_width=32, root_cout=64)


def test_musiq_matches_jax(tmp_path):
    img = images(6, 1, 70, 100)[0]
    p, sp, sc = jmusiq.compose_multiscale(img)
    tp, tsp, tsc = tmusiq.compose_multiscale(img)
    close(tp, p)   # the bicubic resizes of both packages: f32, another order of operations
    np.testing.assert_array_equal(tsp, sp)
    np.testing.assert_array_equal(tsc, sc)
    n = p.shape[0]
    mask = np.ones((1, n), bool)
    jm = jmusiq.MUSIQTransformer(**MUSIQ_CFG)
    params = random_params(jm, 6, jnp.asarray(p[None]), jnp.asarray(sp[None]),
                           jnp.asarray(sc[None]), jnp.asarray(mask))
    tm = tmusiq.MUSIQTransformer(**MUSIQ_CFG)
    sd = cv.musiq_params_from_flax(params, tm)
    assert set(sd) == set(tm.state_dict())
    assert {jmusiq.musiq_key_fn(q) for q in flatten_dict(params)} == set(sd)
    tm.load_state_dict(sd)
    args = (p[None], sp[None], sc[None])
    want = jax.jit(jm.apply)({"params": params}, *map(jnp.asarray, args), jnp.asarray(mask))
    with torch.no_grad():
        root = jmusiq.PatchResNetRoot(MUSIQ_CFG["root_width"], MUSIQ_CFG["root_cout"],
                                      MUSIQ_CFG["hidden"])
        close(tm.eval().embed_patches(T(p[None])),
              jax.jit(root.apply)({"params": params["patch_root"]}, jnp.asarray(p[None])))
        got = tm(T(p[None]), T(sp[None]).long(), T(sc[None]).long())
    close_score(got[0], want[0])
    # the .pth route through the port's tower: its own composition and loader (the JAX
    # tower pads the sequence to a 512-token bucket under a mask, which scores the same)
    path = save(sd, tmp_path / "musiq.pth")
    close_score(tmusiq.NativeMUSIQ(path, device="cpu")(img), want[0])


# ---------------------------------------------------------------------------
# MANIQA
# ---------------------------------------------------------------------------

MANIQA_CFG = dict(vit_width=64, vit_patch=8, vit_layers=4, feat_idx=(0, 1, 2, 3), dim1=32,
                  dim2=16, num_tab=2, window=2, swin_depth=2, swin_heads=2, mlp_dim=32)


def test_maniqa_crops_equal_jax():
    img = images(7, 1, 50, 70)[0].astype(np.float32) / 255.0
    np.testing.assert_array_equal(tmaniqa.random_crops(img, 32, 20),
                                  jmaniqa._random_crops(img, 32, 20))
    np.testing.assert_array_equal(tmaniqa.five_crops(img, 32), jmaniqa._crops_224(img, 32))
    small = img[:20, :30]   # upscaled first: the bicubic resizes of both packages
    close(tmaniqa.random_crops(small, 32, 3), jmaniqa._random_crops(small, 32, 3))


def test_tablock_keeps_the_published_reshape():
    x = np.random.default_rng(8).standard_normal((2, 6, 16)).astype(np.float32)
    jm = jmaniqa.TABlock(16)
    params = random_params(jm, 8, jnp.asarray(x))
    tm = tmaniqa.TABlock(16)
    tm.load_state_dict({f"{k}.{'weight' if leaf == 'kernel' else 'bias'}":
                        T(np.ascontiguousarray(a.T if leaf == "kernel" else a))
                        for (k, leaf), a in flatten_dict(params).items()})
    with torch.no_grad():
        got = tm(T(x))
    close(got, jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():   # a transpose back would be another function
        q, k, v = tm.c_q(T(x)), tm.c_k(T(x)), tm.c_v(T(x))
        other = T(x) + torch.softmax(q @ k.transpose(1, 2) * 16 ** -0.5, -1) @ v
    assert (got - other).abs().max() > 1e-3


def test_maniqa_matches_jax(tmp_path):
    img = images(9, 1, 45, 60)[0]
    x = tmaniqa.random_crops(img.astype(np.float32) / 255.0, 32, 3)   # the tower's crops
    jm = jmaniqa.MANIQA(**MANIQA_CFG)
    params = random_params(jm, 9, jnp.asarray(x))
    tm = tmaniqa.MANIQA(**MANIQA_CFG, image_size=32)
    sd = cv.maniqa_params_from_flax(params, tm)
    assert set(sd) == set(tm.state_dict())
    assert {jmaniqa.maniqa_key_fn(q) for q in flatten_dict(params)} == set(sd)
    tm.load_state_dict(sd)
    vit = jmaniqa.ViTBackbone(64, 8, 4, 1, (0, 1, 2, 3))
    with torch.no_grad():
        for tf, jf in zip(tm.eval().vit((T(x) - 0.5) / 0.5),
                          jax.jit(vit.apply)({"params": params["vit"]},
                                             (jnp.asarray(x) - 0.5) / 0.5)):
            close(tf, jf)
        got = tm(T(x))
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    # 1e-4 here: on such weights the JAX module's own f32 scores lie up to 3.5e-5 (relative)
    # from a float64 evaluation of the port, the port's f32 ones up to 1.4e-5
    for g, w in zip(got, want):
        close_score(g, w, rtol=1e-4)
    # the .pth route through the port's tower: its loader, its crops, the mean
    path = save(sd, tmp_path / "maniqa.pth")
    close_score(tmaniqa.NativeMANIQA(path, num_crops=3, device="cpu")(img), want.mean(),
                rtol=1e-4)


# ---------------------------------------------------------------------------
# NIQE: host numpy in both packages
# ---------------------------------------------------------------------------

def test_niqe_equals_jax():
    imgs = images(11, 3, 200, 200)
    pristine = tniqe.fit_pristine(imgs[:2])
    jp = jniqe.fit_pristine(imgs[:2])
    np.testing.assert_array_equal(pristine[0], jp[0])
    np.testing.assert_array_equal(pristine[1], jp[1])
    assert tniqe.niqe(imgs[2], pristine) == jniqe.niqe(imgs[2], jp)
    assert np.isnan(tniqe.niqe(imgs[2][:50, :50], pristine))


def test_towers_refuse_the_card_they_lack(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlpips.NativeLPIPS()
