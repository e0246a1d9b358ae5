"""Port parity: whole-image uint8 serving through freqfusion_tpu_torch's
InferencePipeline against the JAX NAFNetSR, the bucket plan against the JAX one, and the
guard that the port imports without JAX."""

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


def test_tiled_path_raises():
    _, _, tm = small_pair()
    pipe = InferencePipeline(tm, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            pipe.dispatch_batch_u8([np.zeros((30, 40, 3), np.float32)])
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            pipe.run_image(np.zeros((700, 700, 3), np.float32))


def test_whole_image_plan_matches_jax():
    shapes = [(339, 510), (270, 400), (340, 510), (64, 64), (30, 40), (600, 600),
              (100, 100), (150, 150), (200, 200), (250, 250), (330, 500), (300, 450),
              (90, 90), (339, 510)]
    jpipe = object.__new__(JInferencePipeline)   # no JAX ensemble is built
    port = object.__new__(InferencePipeline)
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
        "import freqfusion_tpu_torch\n"
        "import freqfusion_tpu_torch.ops.common, freqfusion_tpu_torch.ops.resize\n"
        "import freqfusion_tpu_torch.ops.kernels.nafblock\n"
        "import freqfusion_tpu_torch.ops.kernels.conv3x3\n"
        "import freqfusion_tpu_torch.ops.windows\n"
        "import freqfusion_tpu_torch.ops.kernels.wattn, freqfusion_tpu_torch.ops.kernels.aim\n"
        "import freqfusion_tpu_torch.ops.kernels.sgfn, freqfusion_tpu_torch.ops.kernels.cab\n"
        "import freqfusion_tpu_torch.models.layers, freqfusion_tpu_torch.models.nafnet\n"
        "import freqfusion_tpu_torch.models.dat, freqfusion_tpu_torch.models.hat\n"
        "import freqfusion_tpu_torch.infer.io\n"
        "import freqfusion_tpu_torch.utils.convert, freqfusion_tpu_torch.utils.imageio\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
