"""The port's twins of the JAX package's exported ops and of its scripts, on the CPU:
``ops.pixel_unshuffle`` (the inverse of the port's ``pixel_shuffle``), ``ops.same_pad`` and
``ops.downsample`` against the JAX functions (1e-6); ``cli/bucket_histogram.py`` against
``scripts/bucket_histogram.py`` on the same shapes (the same JSON, ``max_shapes`` apart: the
port sets no bucket cap unless ``FREQFUSION_WHOLE_IMAGE_SHAPES`` does);
``cli/extract_features.py --device cpu`` against ``scripts/extract_features.py`` on a tiny
ensemble (the same crops, outputs and features within the ensemble's 2e-4, each package's
``CachedFeatureDataset`` reading the port's files); and ``cli/graft_entry.py:entry`` on the
CPU."""

import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from freqfusion_tpu import ops as jops
from freqfusion_tpu.data.cached import CachedFeatureDataset as JCachedFeatureDataset
from freqfusion_tpu_torch import ops as tops
from freqfusion_tpu_torch.cli import bucket_histogram, extract_features, graft_entry
from freqfusion_tpu_torch.data.cached import CachedFeatureDataset
from freqfusion_tpu_torch.models.experts import ExpertEnsemble
from freqfusion_tpu_torch.utils.imageio import save_image

from test_torch_ensemble import EXPERTS
from test_torch_training import _synthetic_data, _yaml_safe

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape,r", [((2, 8, 12, 3), 2), ((1, 9, 6, 4), 3), ((3, 4, 8, 16), 4)])
def test_pixel_unshuffle_inverts_pixel_shuffle_and_matches_jax(shape, r):
    x = np.random.default_rng(r).standard_normal(shape).astype(np.float32)
    got = tops.pixel_unshuffle(torch.from_numpy(x), r)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.pixel_unshuffle(jnp.asarray(x), r)),
                               atol=1e-6)
    assert torch.equal(tops.pixel_shuffle(got, r), torch.from_numpy(x))
    assert torch.equal(tops.pixel_unshuffle(tops.pixel_shuffle(got, r), r), got)


@pytest.mark.parametrize("shape,k", [((2, 7, 9, 3), (3, 3)), ((1, 5, 6, 2), (5, 1)),
                                     ((4, 6, 3), (7, 3))])
def test_same_pad_matches_jax(shape, k):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tops.same_pad(torch.from_numpy(x), *k).numpy()
    want = np.asarray(jops.same_pad(jnp.asarray(x), *k))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("method,scale,shape", [("bilinear", 2, (2, 16, 24, 3)),
                                                ("bilinear", 4, (1, 32, 20, 3)),
                                                ("bicubic", 2, (1, 18, 14, 2)),
                                                ("bicubic", 3, (2, 27, 12, 3))])
def test_downsample_matches_jax(method, scale, shape):
    x = np.random.default_rng(scale).uniform(size=shape).astype(np.float32)
    got = tops.downsample(torch.from_numpy(x), scale, method).numpy()
    want = np.asarray(jops.downsample(jnp.asarray(x), scale, method))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


# DIV2K-class frames, one over the pixel budget, one smaller than its reflect padding
FEW = ["510x339", "450x300", "510x339", "400x270", "640x480", "40x30", "2040x1356", "339x510"]
# 9 buckets: past the JAX twin's cap of 6, where it pads one frame up to a bucket in use
# and tiles two
MANY = ["510x339", "450x300", "400x270", "339x510", "300x450", "270x400", "500x330",
        "440x290", "520x360", "200x150"]


def test_bucket_histogram_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("FREQFUSION_WHOLE_IMAGE_PX", raising=False)
    monkeypatch.delenv("FREQFUSION_WHOLE_IMAGE_SHAPES", raising=False)
    jscript = _script("bucket_histogram")
    # under the JAX twin's cap of 6 buckets: the same JSON but for max_shapes
    got = bucket_histogram.main(["--shapes", ",".join(FEW)])
    assert json.loads(capsys.readouterr().out) == got
    want = jscript.simulate(jscript.parse_shapes(FEW))
    assert got["max_shapes"] is None and want["max_shapes"] == 6
    assert {**got, "max_shapes": 6} == want
    assert got["tiled"] == 3 and got["whole_image"] == 5
    # past it, the port with the JAX twin's cap set: the same pad-ups and tiled frames
    monkeypatch.setenv("FREQFUSION_WHOLE_IMAGE_SHAPES", "6")
    listing = tmp_path / "shapes.txt"
    listing.write_text("\n".join(MANY) + "\n")
    got = bucket_histogram.main(["--shapes-file", str(listing)])
    assert got == jscript.simulate(jscript.parse_shapes(MANY))
    assert got["padded_up"] > 0 and got["tiled"] > 0
    monkeypatch.delenv("FREQFUSION_WHOLE_IMAGE_SHAPES")
    uncapped = bucket_histogram.main(["--shapes-file", str(listing)])
    assert uncapped["whole_image"] == len(MANY) and uncapped["max_shapes"] is None
    # a directory of images, read in name order
    for i, s in enumerate(FEW[:4]):
        w, h = map(int, s.split("x"))
        save_image(np.zeros((h, w, 3), np.uint8), str(tmp_path / "dir" / f"{i}.png"))
    got = bucket_histogram.main([str(tmp_path / "dir")])
    assert {**got, "max_shapes": 6} == jscript.simulate(jscript.shapes_from_dir(
        str(tmp_path / "dir")))
    assert got["images"] == 4 and got["histogram"] == {"512x352": 2, "480x320": 1,
                                                       "416x288": 1}


def test_extract_features_matches_the_jax_script(tmp_path, monkeypatch):
    """Both scripts on 2 LR/HR pairs (2 crops each, patch 16, batch 3: a padded last
    batch) with the same tiny experts' .pth files: the same crops, and every output and
    feature map within 2e-4."""
    _synthetic_data(tmp_path / "data", n=2)
    torch.manual_seed(5)
    ens = ExpertEnsemble(**EXPERTS)
    model_dir = tmp_path / "model"
    for name, module in (("hat", ens.hat), ("dat", ens.dat), ("nafnet", ens.nafnet)):
        (model_dir / "pretrained" / name).mkdir(parents=True)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"expert_kwargs": _yaml_safe(EXPERTS)}}))
    args = ["--data-root", str(tmp_path / "data"), "--split", "train", "--model-dir",
            str(model_dir), "--patch", "16", "--crops-per-image", "2", "--batch", "3",
            "--seed", "7"]
    monkeypatch.setenv("FREQFUSION_CONFIG", str(cfg))
    assert extract_features.main([*args, "--out", str(tmp_path / "port"), "--device",
                                  "cpu"]) == 4
    env = dict(os.environ, JAX_PLATFORMS="cpu", FREQFUSION_JAX_CACHE=str(tmp_path / "jc"))
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "extract_features.py"),
                    *args, "--out", str(tmp_path / "jax")], cwd=REPO, env=env, check=True,
                   timeout=600, capture_output=True)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 4
    for name in names:
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(got.files) == sorted(want.files)
        for k in got.files:
            tol = 0 if k in ("lr", "hr") else 2e-4
            np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=f"{name} {k}")
    # each package's dataset reads the port's files into the same training sample
    jsample = JCachedFeatureDataset(tmp_path / "port", augment=False)[0]
    tsample = CachedFeatureDataset(tmp_path / "port", augment=False)[0]
    assert sorted(jsample) == sorted(tsample)
    for k in tsample:
        np.testing.assert_array_equal(np.asarray(jsample[k]), np.asarray(tsample[k]))


def test_extract_features_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        extract_features.main(["--data-root", str(tmp_path), "--out", str(tmp_path / "o")])


def test_entry_runs_the_full_model_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    model, lr = args
    assert tuple(lr.shape) == (1, 64, 64, 3)
    assert sum(p.numel() for p in model.parameters()) > 150e6   # the shipped ensemble
    out = fn(*args)
    assert tuple(out.shape) == (1, 256, 256, 3) and bool(torch.isfinite(out).all())
    assert not torch.is_grad_enabled() or not out.requires_grad
