"""The port's eval CLI (``freqfusion_tpu_torch.cli.eval``) against the repository's root
``eval.py`` on the JAX CPU: three small PNG pairs, NIQE fit from the targets, the five
towers live through small random checkpoints that both packages load. The CSV matches
column for column (PSNR, SSIM and NIQE to the printed digits, the tower columns within
1e-5 relative and the last printed digit, MANIQA's 1e-4 as in test_torch_towers.py), and
``total_score`` within 1e-5 relative.
The pooled rows stay aligned with a fake tower; without a card the default device raises.
"""

import csv
import importlib
import os
import sys

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
from freqfusion_tpu_torch.cli import eval as teval
from freqfusion_tpu_torch.losses import clip as tclip
from freqfusion_tpu_torch.utils import clipiqa as tclipiqa
from freqfusion_tpu_torch.utils import convert as cv
from freqfusion_tpu_torch.utils import dists as tdists
from freqfusion_tpu_torch.utils import lpips as tlpips
from freqfusion_tpu_torch.utils import maniqa as tmaniqa
from freqfusion_tpu_torch.utils import musiq as tmusiq
from freqfusion_tpu_torch.utils import perceptual_metrics as tpm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


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


def write_pairs(root, n=3, size=(100, 104)):
    from PIL import Image

    rng = np.random.default_rng(3)
    out_dir, tgt_dir = root / "run" / "out", root / "gt"
    out_dir.mkdir(parents=True), tgt_dir.mkdir()
    for i in range(n):
        tgt = rng.uniform(size=size + (3,))
        out = np.clip(tgt + rng.normal(0, 0.05, tgt.shape), 0, 1)
        Image.fromarray((tgt * 255).round().astype(np.uint8)).save(tgt_dir / f"im{i:02d}.png")
        Image.fromarray((out * 255).round().astype(np.uint8)).save(out_dir / f"im{i:02d}.png")
    return out_dir, tgt_dir


def write_towers(d):
    """Small random checkpoints of the five towers in their torch layouts, and the BPE
    vocabulary: {variable: path}."""
    x = jnp.zeros((1, 32, 32, 3))
    lp = random_params(jlpips.AlexLPIPS(), 1, x, x)
    lp = {k: np.abs(v) if k.startswith("lin_") else v for k, v in lp.items()}
    dp = random_params(jdists.VGG16L2Stages(), 2, x)
    alpha = beta = np.full(sum(jdists.DISTS_STAGE_CHANNELS), 0.05, np.float32)
    musiq_cfg = dict(hidden=64, layers=2, heads=1, mlp_dim=96, root_width=32, root_cout=64)
    z = jnp.zeros((1, 4), jnp.int32)
    mp = random_params(jmusiq.MUSIQTransformer(**musiq_cfg), 3, jnp.zeros((1, 4, 3072)), z,
                       z, jnp.ones((1, 4), bool))
    maniqa_cfg = dict(vit_width=64, vit_patch=8, vit_layers=4, feat_idx=(0, 1, 2, 3), dim1=32,
                      dim2=16, num_tab=2, window=2, swin_depth=2, swin_heads=2, mlp_dim=32)
    qp = random_params(jmaniqa.MANIQA(**maniqa_cfg), 4, x)
    bpe = str(d / "bpe.txt")
    with open(bpe, "w") as f:
        f.write("#version: test\no o\noo d</w>\ng ood</w>\nb a\nba d</w>\np h\nph o\n")
    vocab = jclipiqa.SimpleBPETokenizer(bpe).vocab_size
    v_cfg = dict(patch=32, width=64, layers=2, heads=1, output_dim=32)
    t_cfg = dict(width=32, heads=1, layers=2, context=16, output_dim=32)
    vp = random_params(jclip.CLIPVisionTransformer(**v_cfg), 5, jnp.zeros((1, 224, 224, 3)))
    tp = random_params(jclipiqa.CLIPTextTransformer(vocab_size=vocab, **t_cfg), 6,
                       jnp.zeros((1, 16), jnp.int32))
    sds = {
        "FREQFUSION_LPIPS_WEIGHTS": cv.lpips_params_from_flax(lp, tlpips.AlexLPIPS()),
        "FREQFUSION_DISTS_WEIGHTS": cv.dists_params_from_flax(dp, alpha, beta, tdists.DISTS()),
        "FREQFUSION_MUSIQ_WEIGHTS": cv.musiq_params_from_flax(
            mp, tmusiq.MUSIQTransformer(**musiq_cfg)),
        "FREQFUSION_MANIQA_WEIGHTS": cv.maniqa_params_from_flax(
            qp, tmaniqa.MANIQA(**maniqa_cfg, image_size=32)),
        "FREQFUSION_CLIPIQA_WEIGHTS": {
            **cv.clip_vision_params_from_flax(vp, tclip.CLIPVisionTransformer(**v_cfg)),
            **cv.clip_text_params_from_flax(
                tp, tclipiqa.CLIPTextTransformer(vocab_size=vocab, **t_cfg)),
            "logit_scale": torch.tensor(np.log(5.0), dtype=torch.float32)},
    }
    paths = {"FREQFUSION_CLIP_BPE": bpe}
    for env, sd in sds.items():
        paths[env] = str(d / f"{env.lower()}.pth")
        torch.save(sd, paths[env])
    return paths


def read(stem):
    with open(stem + ".csv") as f:
        rows = list(csv.reader(f))
    with open(stem + ".txt") as f:
        means = {k: float(v) for k, v in (line.strip().split(": ") for line in f)}
    return rows, means


def test_eval_cli_matches_root_eval(tmp_path, monkeypatch):
    out_dir, tgt_dir = write_pairs(tmp_path)
    for env, path in write_towers(tmp_path).items():
        monkeypatch.setenv(env, path)
    monkeypatch.setenv("FREQFUSION_MANIQA_CROPS", "3")
    (tmp_path / "jax").mkdir(), (tmp_path / "torch").mkdir()
    args = ["--output", str(out_dir), "--target", str(tgt_dir), "--workers", "1"]

    sys.path.insert(0, REPO)
    ev = importlib.import_module("eval")
    monkeypatch.setattr(ev, "_WORKER_TOWERS", None)
    monkeypatch.setattr(sys, "argv", ["eval.py"] + args + ["--csv-dir", str(tmp_path / "jax")])
    ev.main()
    res = teval.main(args + ["--csv-dir", str(tmp_path / "torch"), "--device", "cpu"])

    jrows, jmeans = read(str(tmp_path / "jax" / "run--out"))
    trows, tmeans = read(res["stem"])
    assert res["stem"] == str(tmp_path / "torch" / "run--out")
    assert trows[0] == jrows[0] == ["image", "psnr", "ssim", "niqe", "clipiqa", "dists", "lpips",
                                    "maniqa", "musiq"]
    assert len(trows) == len(jrows) == 5 and trows[-1][0] == "MEAN"
    for tr, jr in zip(trows[1:], jrows[1:]):
        assert tr[:4] == jr[:4]   # name, PSNR, SSIM, NIQE as printed
        for col, t, j in zip(trows[0][4:], tr[4:], jr[4:]):
            rtol = 1e-4 if col == "maniqa" else 1e-5
            assert abs(float(t) - float(j)) <= rtol * abs(float(j)) + 1e-5, (col, t, j)
    assert sorted(tmeans) == sorted(jmeans)
    assert all(np.isfinite(v) for v in tmeans.values())
    for k in ("psnr", "ssim", "niqe"):
        assert tmeans[k] == jmeans[k]
    assert abs(tmeans["total_score"] - jmeans["total_score"]) <= 1e-5 * jmeans["total_score"]


def test_pooled_rows_stay_aligned(tmp_path, monkeypatch):
    out_dir, tgt_dir = write_pairs(tmp_path, n=4, size=(40, 48))

    # a per-image "tower": any row misalignment changes its column
    def fake_towers(device):
        return {"lpips": lambda out, tgt: float(
            np.mean(np.abs(out.astype(np.float64) - tgt.astype(np.float64))))}

    monkeypatch.setattr(tpm, "load_native_towers", fake_towers)
    (tmp_path / "w.pth").write_bytes(b"x")
    monkeypatch.setenv("FREQFUSION_LPIPS_WEIGHTS", str(tmp_path / "w.pth"))
    res = teval.main(["--output", str(out_dir), "--target", str(tgt_dir), "--workers", "2",
                      "--no-niqe", "--csv-dir", str(tmp_path), "--device", "cpu"])
    rows, means = read(res["stem"])
    assert rows[0] == ["image", "psnr", "ssim", "niqe", "lpips"]
    from PIL import Image
    for name, p, s, nq, lp in rows[1:-1]:
        out = np.asarray(Image.open(out_dir / name).convert("RGB"))
        tgt = np.asarray(Image.open(tgt_dir / name).convert("RGB"))
        want = float(np.mean(np.abs(out.astype(np.float64) - tgt.astype(np.float64))))
        assert float(lp) == pytest.approx(want, abs=1e-4), name
        assert nq == "nan"
    assert [r[0] for r in rows[1:-1]] == sorted(os.listdir(out_dir))
    assert np.isnan(means["niqe"]) and np.isnan(means["musiq"])


def test_perceptual_evaluator_matches_jax(tmp_path, monkeypatch):
    from freqfusion_tpu.utils import perceptual_metrics as jpm
    from PIL import Image

    for envs in tpm.TOWER_ENV.values():
        for env in envs:
            monkeypatch.delenv(env, raising=False)
    out_dir, tgt_dir = write_pairs(tmp_path)
    imgs = [np.asarray(Image.open(d / "im00.png")) for d in (out_dir, tgt_dir)]
    te, je = tpm.PerceptualEvaluator(device="cpu"), jpm.PerceptualEvaluator()
    te.fit_pristine([imgs[1]] * 2)
    je.fit_pristine([imgs[1]] * 2)
    assert te.available_metrics == je.available_metrics == ["psnr", "ssim", "sharpness",
                                                            "niqe"]
    got, want = te.evaluate_pair(*imgs), je.evaluate_pair(*imgs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert te.perceptual_score(got) == je.perceptual_score(want)


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    out_dir, tgt_dir = write_pairs(tmp_path, n=1, size=(40, 48))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        teval.main(["--output", str(out_dir), "--target", str(tgt_dir)])
    assert not list(tmp_path.rglob("*.csv"))
