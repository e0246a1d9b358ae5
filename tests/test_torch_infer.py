"""Port parity: whole-image uint8 serving through freqfusion_tpu_torch's
InferencePipeline against the JAX NAFNetSR, the bucket plan against the JAX one, the tiled
path's refusals, the submission CLI on the CPU, and the guard that the port imports without
JAX."""

import os
import subprocess
import sys
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from freqfusion_tpu.infer.io import InferencePipeline as JInferencePipeline
from freqfusion_tpu_torch.infer.io import InferencePipeline
from freqfusion_tpu_torch.utils.imageio import list_images, load_image, save_image

from test_torch_nafnet import small_pair

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_u8_serving_matches_jax(tmp_path):
    jm, params, tm = small_pair(seed=2)
    rng = np.random.default_rng(9)
    src, out = tmp_path / "lr", tmp_path / "sr"
    for name, (h, w) in (("a.png", (70, 80)), ("b.png", (66, 90))):
        save_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), str(src / name))
    pipe = InferencePipeline(tm, "cpu")
    files = list_images(str(src))
    lrs = [load_image(f) for f in files]
    pending = None
    for f, lr in zip(files, lrs):   # dispatch image i+1 before materialising image i
        handle = pipe.dispatch_batch_u8([lr])
        if pending is not None:
            save_image(pipe.materialize_u8(pending[0])[0], pending[1])
        pending = (handle, str(out / os.path.basename(f)))
    save_image(pipe.materialize_u8(pending[0])[0], pending[1])

    for f, lr in zip(files, lrs):
        got = np.asarray(Image.open(out / os.path.basename(f)))
        h, w, _ = lr.shape
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
        lrp = np.pad(lr, [(0, 96 - h), (0, 96 - w), (0, 0)], mode="reflect")
        sr, _ = jm.apply({"params": params}, jnp.asarray(lrp[None]))
        want = np.round(np.clip(np.asarray(sr)[0, :4 * h, :4 * w], 0, 1) * 255)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    # run_image: the same forward, float output
    np.testing.assert_allclose(
        pipe.run_image(lrs[0]),
        np.asarray(jm.apply({"params": params}, jnp.asarray(np.pad(
            lrs[0], [(0, 26), (0, 16), (0, 0)], mode="reflect")[None]))[0])[0, :280, :320],
        atol=5e-5)


def test_bad_tiling_raises_and_any_size_is_served():
    """What the tiled path still raises for: a tiling that cannot cover an image. No image
    is refused for its size: one smaller than its reflect padding and one over the pixel
    budget both come back at x4 (parity with the JAX package: tests/test_torch_tiling.py)."""
    _, _, tm = small_pair()
    for bad in (dict(tile=64, overlap=64), dict(tile=64, overlap=-1), dict(tile=0),
                dict(tile_batch=0)):
        with pytest.raises(ValueError, match="tiling"):
            InferencePipeline(tm, "cpu", **bad)
    pipe = InferencePipeline(tm, "cpu", tile=64, overlap=16, tile_batch=2)
    pipe.WHOLE_IMAGE_MAX_PX = 96 * 96
    rng = np.random.default_rng(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        small = rng.uniform(size=(30, 40, 3)).astype(np.float32)
        assert pipe.dispatch_batch_u8([small]) is None
        assert pipe.run_image(small).shape == (120, 160, 3)
        large = rng.uniform(size=(100, 130, 3)).astype(np.float32)
        u8 = pipe.run_tiled_u8(large)
        assert u8.shape == (400, 520, 3) and u8.dtype == np.uint8
        np.testing.assert_allclose(pipe.run_image(large), u8 / 255.0, atol=0.5 / 255 + 1e-6)


def test_cli_writes_pngs_and_results(tmp_path, monkeypatch, capsys):
    """`python -m freqfusion_tpu_torch.cli.test` on the CPU with a tiny model through the
    keywords: PNGs under <save_dir>/29_FreqFusion_torch/<split>, the runtime line and
    results.json, which keeps what other runners wrote."""
    from freqfusion_tpu_torch.cli import test as cli
    from test_torch_ensemble import EXPERTS
    src, save = tmp_path / "lr", tmp_path / "results"
    rng = np.random.default_rng(1)
    sizes = {"a.png": (64, 70), "tiny.png": (20, 30)}   # one whole, one tiled
    for name, (h, w) in sizes.items():
        save_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), str(src / name))
    save.mkdir()
    (save / "results.json").write_text('{"29_FreqFusion_tpu": {"runtime_ms": 1.0}}')
    monkeypatch.setenv("FREQFUSION_MODEL_DIR", str(tmp_path / "no_checkpoints"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # no checkpoint: random weights, and the tiled path
        ms = cli.main(["--input", str(src), "--save_dir", str(save), "--split", "test",
                       "--device", "cpu"], expert_kwargs=EXPERTS, tile=32, overlap=8)
    for name, (h, w) in sizes.items():
        got = np.asarray(Image.open(save / "29_FreqFusion_torch" / "test" / name))
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
    import json
    results = json.loads((save / "results.json").read_text())
    assert results["29_FreqFusion_torch"] == {"runtime_ms": ms, "split": "test"}
    assert results["29_FreqFusion_tpu"] == {"runtime_ms": 1.0}
    assert "------> Runtime (including IO) of 2 images" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown model id"):
        cli.select_model(3)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["--input", str(src), "--save_dir", str(save)], expert_kwargs=EXPERTS)


def test_whole_image_plan_matches_jax():
    shapes = [(339, 510), (270, 400), (340, 510), (64, 64), (30, 40), (600, 600),
              (100, 100), (150, 150), (200, 200), (250, 250), (330, 500), (300, 450),
              (90, 90), (339, 510)]
    jpipe = object.__new__(JInferencePipeline)   # no JAX ensemble is built
    port = object.__new__(InferencePipeline)
    port.WHOLE_IMAGE_MAX_SHAPES = 6   # the JAX twin's compile-cache cap; the port has none
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = [JInferencePipeline._whole_image_plan(jpipe, h, w) for h, w in shapes]
        got = [port._whole_image_plan(h, w) for h, w in shapes]
    assert got == want
    assert (352, 512) in got and None in got   # a pad-up and a cap/limit case occur
    assert got[shapes.index((300, 450))] == (352, 512)   # padded up


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['freqfusion_tpu'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['torch.utils.tensorboard'] = None\n"
        "import importlib, pkgutil\n"
        "import freqfusion_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = ['ops.dct', 'ops.kernels.bandmha', 'ops.kernels.lka', 'models.layers',\n"
        "        'models.frequency', 'models.lka', 'models.fusion_blocks',\n"
        "        'models.hierarchical', 'models.edge', 'models.fusion', 'models.experts',\n"
        "        'models.nafnet', 'models.dat', 'models.hat', 'ops.kernels.wattn',\n"
        "        'ops.kernels.cab', 'infer.io', 'infer.tiling', 'cli.test', 'utils.convert',\n"
        "        'utils.imageio', 'losses', 'training.schedule', 'training.ema',\n"
        "        'training.steps', 'training.checkpoint', 'data.augment', 'data.dataset',\n"
        "        'data.cached', 'data.extract', 'utils.metrics', 'utils.logger',\n"
        "        'parallel.mesh', 'cli.train']\n"
        "assert all(pkg.__name__ + '.' + n in names for n in need), names\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'freqfusion_tpu.', 'optax',\n"
        "                                            'msgpack'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    # no import statement of the port or of chip_smoke.py names the JAX side, wherever in a
    # file it stands (a function body too)
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "freqfusion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("jax", "flax", "optax", "freqfusion_tpu"), (path, m)
