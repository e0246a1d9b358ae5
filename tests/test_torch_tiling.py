"""Port parity for tiled serving: the tile plans and seam ramps of
``freqfusion_tpu_torch/infer/tiling.py`` equal the JAX package's over a sweep of sizes, the
port's device-side stitcher equals the JAX ``tiled_sr`` for the same forwards (1e-6), a
tiny ``FreqFusionSR`` goes through both packages' ``run_image`` on the tiled path (2e-4), and
``main`` serves a directory that holds a whole-image frame and a tiled one within 1 LSB of
the JAX ``main`` from the same ``.pth`` checkpoints."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from PIL import Image

from freqfusion_tpu.infer import io as jio
from freqfusion_tpu.infer import tiling as jt
from freqfusion_tpu.infer.io import InferencePipeline as JInferencePipeline
from freqfusion_tpu.infer.io import main as jmain
from freqfusion_tpu.ops.resize import upsample as jupsample
from freqfusion_tpu_torch.infer import tiling as tt
from freqfusion_tpu_torch.infer.io import InferencePipeline, main
from freqfusion_tpu_torch.utils.imageio import save_image

from test_torch_ensemble import EXPERTS, _reference_model
from test_torch_ensemble import pair  # noqa: F401  (the module-scoped fixture)

torch.set_num_threads(2)

SIZES = [(480, 640), (30, 40), (339, 510), (192, 192), (193, 192), (700, 700), (100, 1000),
         (352, 353), (1, 1), (176, 500)]
TILINGS = [(192, 32, 2), (176, 32, 2), (128, 32, 1), (64, 16, 3), (48, 8, 2), (32, 0, 4)]


@pytest.mark.parametrize("tile,overlap,batch", TILINGS)
def test_plans_match_jax(tile, overlap, batch):
    for h, w in SIZES:
        for size in (h, w):
            assert tt.tile_grid(size, tile, tile - overlap) == \
                jt.tile_grid(size, tile, tile - overlap)
        assert tt.num_tiles(h, w, tile, overlap, batch) == jt.num_tiles(h, w, tile, overlap, batch)
        hp, wp = max(h, tile), max(w, tile)   # tiled_sr plans the padded image
        got = tt.plan_grid(hp, wp, tile, overlap, batch)
        assert got == jt.plan_grid(hp, wp, tile, overlap, batch)
        ys, xs, ov_y, ov_x = got
        assert ys[0] == 0 and ys[-1] + tile == hp and xs[0] == 0 and xs[-1] + tile == wp
        assert len(ys) * len(xs) == tt.num_tiles(h, w, tile, overlap, batch)
        assert (len(ys) == 1 or ov_y >= overlap) and (len(xs) == 1 or ov_x >= overlap)
    for n in (1, 2, 5):
        assert tt._even_starts(500, tile, n) == jt._even_starts(500, tile, n)


@pytest.mark.parametrize("size,overlap", [(768, 128), (704, 140), (64, 0), (16, 15)])
@pytest.mark.parametrize("has_lo,has_hi", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_ramp_profile_matches_jax(size, overlap, has_lo, has_hi):
    got = tt._ramp_profile(size, overlap, has_lo, has_hi)
    np.testing.assert_array_equal(got, jt._ramp_profile(size, overlap, has_lo, has_hi))
    assert got.dtype == np.float32 and 0.0 < got.min() <= got.max() <= 1.0


def test_default_plan_of_a_2k_frame():
    """The 640x480 frame of the chip check: 12 tiles of 192 px in 6 chunks of 2; at 176 px
    (HAT's windows but not DAT's) 20 tiles in 10 chunks."""
    ys, xs, ov_y, ov_x = tt.plan_grid(480, 640, 192, 32, 2)
    assert (len(ys), len(xs)) == (3, 4) and (ov_y, ov_x) == (48, 42)
    ys, xs, _, _ = tt.plan_grid(480, 640, 176, 32, 2)
    assert (len(ys), len(xs)) == (4, 5)
    assert tt.num_tiles(30, 40, 192, 32, 2) == 1


@pytest.mark.parametrize("method", ["nearest", "bicubic"])
@pytest.mark.parametrize("shape,tile,overlap,batch", [
    ((100, 140), 64, 16, 2), ((40, 50), 64, 16, 1), ((70, 64), 64, 16, 2),
    ((20, 9), 48, 8, 3), ((97, 131), 32, 8, 4)])
def test_tiled_sr_matches_jax(method, shape, tile, overlap, batch):
    """The same pointwise (nearest) and small-field (bicubic) forward through both
    stitchers: tiles cut, padded by repeat and accumulated in the same order. A frame
    smaller than a tile is reflect-padded, folding more than once where it has to (9 px
    to 48)."""
    lr = np.random.default_rng(sum(shape)).uniform(size=(*shape, 3)).astype(np.float32)
    seen = []

    def jforward(tiles):
        return np.asarray(jupsample(jnp.asarray(tiles), 4, method))

    def forward(tiles):   # the same function on the port's tensors
        seen.append(tuple(tiles.shape))
        return torch.from_numpy(jforward(tiles.numpy()).copy())

    want = jt.tiled_sr(lr, jforward, tile=tile, overlap=overlap, batch=batch)
    got = tt.tiled_sr(lr, forward, tile=tile, overlap=overlap, batch=batch, device="cpu")
    assert got.shape == (4 * shape[0], 4 * shape[1], 3) and got.dtype == torch.float32
    n = tt.num_tiles(*shape, tile, overlap, batch)
    assert seen == [(batch, tile, tile, 3)] * -(-n // batch)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if method == "nearest":   # the ramps normalise to 1: tiling a pointwise forward is exact
        np.testing.assert_allclose(got.numpy(), np.repeat(np.repeat(lr, 4, 0), 4, 1), atol=1e-6)


def test_whole_image_sr_matches_jax():
    lr = np.random.default_rng(0).uniform(size=(37, 53, 3)).astype(np.float32)
    shapes = []

    def jforward(x):
        return np.asarray(jupsample(jnp.asarray(x), 4, "bicubic"))

    def forward(x):
        shapes.append(tuple(x.shape))
        return torch.from_numpy(jforward(x.numpy()).copy())

    got = tt.whole_image_sr(lr, forward, scale=4, multiple=16, device="cpu")
    want = jt.whole_image_sr(lr, jforward, scale=4, multiple=16)
    assert shapes == [(1, 48, 64, 3)] and got.shape == (148, 212, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # the caller's own bucket, as the serving pipeline passes it
    got = tt.whole_image_sr(lr, forward, device="cpu", bucket=(64, 96))
    assert shapes[-1] == (1, 64, 96, 3) and got.shape == (148, 212, 3)
    padded = np.pad(lr, [(0, 27), (0, 43), (0, 0)], mode="reflect")[None]
    np.testing.assert_array_equal(got.numpy(), jforward(padded)[0, :148, :212])


@pytest.mark.parametrize("entry", ["tiled_sr", "whole_image_sr"])
def test_tiling_entry_points_default_to_the_card(monkeypatch, entry):
    """Like the pipeline and `main`: the default device is the card, and without one the
    call raises before any forward instead of serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lr = np.zeros((8, 8, 3), np.float32)

    def forward(x):
        raise AssertionError("no forward may run")

    with pytest.raises(RuntimeError, match="no CUDA card"):
        getattr(tt, entry)(lr, forward)


def _jax_tiled_pipeline(jm, variables, tile, overlap, batch):
    """The JAX pipeline around an existing model and its variables, every image tiled:
    built without its constructor, which would initialise an ensemble of its own."""
    jp = object.__new__(JInferencePipeline)
    jp.model, jp.variables, jp.mesh = jm, variables, None
    jp.tile, jp.overlap, jp.tile_batch = tile, overlap, batch
    jp.WHOLE_IMAGE_MAX_PX = 0
    jp._fwd = jax.jit(lambda v, t: jm.apply(v, t).astype(jnp.float32))
    return jp


@pytest.mark.parametrize("tile,shape", [(32, (40, 50)), (48, (50, 30)), (40, (44, 60))])
def test_tiny_freqfusion_tiled_run_image_matches_jax(pair, monkeypatch, tile, shape):  # noqa: F811
    """Tiles 32 and 48 (whole windows of both transformers) and tile 40 (whole 8-px windows
    of the tiny HAT but not the tiny DAT's 16 px: q, k, v are zero-padded after their
    projection, an odd count of windows a side), overlap 8, chunks of 2 with the last one
    padded by repeat; a 30-px side is reflect-padded up to the tile."""
    jm, variables, tm, _ = pair
    monkeypatch.setattr(InferencePipeline, "WHOLE_IMAGE_MAX_PX", 0)
    lr = np.random.default_rng(tile).uniform(size=(*shape, 3)).astype(np.float32)
    want = _jax_tiled_pipeline(jm, variables, tile, 8, 2).run_image(lr)
    pipe = InferencePipeline(tm, "cpu", tile=tile, overlap=8, tile_batch=2)
    got = pipe.run_image(lr)
    assert got.shape == (4 * shape[0], 4 * shape[1], 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4)
    u8 = pipe.run_tiled_u8(lr)
    assert u8.dtype == np.uint8
    assert np.abs(u8.astype(np.int32) - np.round(np.clip(want, 0, 1) * 255)).max() <= 1
    assert pipe.dispatch_batch_u8([lr]) is None   # the batch protocol is whole-image only


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    return list(obj) if isinstance(obj, tuple) else obj


def test_main_serves_whole_and_tiled_frames_like_jax(tmp_path, monkeypatch):
    """One directory, one stream: a 70x80 frame that runs whole (bucket 96x96) and a
    40x30 frame that is smaller than its reflect padding and runs as one 32-px-tile plan,
    from the same .pth checkpoints through both packages' `main`."""
    ref = _reference_model(7)
    model_dir, src = tmp_path / "model", tmp_path / "lr"
    for name, module in (("hat", ref.experts.hat), ("dat", ref.experts.dat),
                         ("nafnet", ref.experts.nafnet)):
        (model_dir / "pretrained" / name).mkdir(parents=True)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    torch.save(ref.fusion.state_dict(), model_dir / "fusion_head.pth")
    rng = np.random.default_rng(5)
    sizes = {"a_whole.png": (70, 80), "b_tiny.png": (30, 40), "c_whole.png": (66, 90)}
    for name, (h, w) in sizes.items():
        save_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), str(src / name))

    n = main(str(model_dir), str(src), str(tmp_path / "sr"), "cpu", expert_kwargs=EXPERTS,
             tile=32, overlap=8, tile_batch=2)
    assert n == 3

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"expert_kwargs": _yaml_safe(EXPERTS)},
                                   "infer": {"tile": 32, "overlap": 8, "tile_batch": 2}}))
    monkeypatch.setenv("FREQFUSION_CONFIG", str(cfg))
    # one device, as the port serves: the test harness's 8 virtual CPU devices would make
    # the JAX `main` shard its batches over a mesh
    monkeypatch.setattr(jio, "InferencePipeline",
                        functools.partial(JInferencePipeline, n_devices=1))
    assert jmain(str(model_dir), str(src), str(tmp_path / "sr_jax")) == 3
    for name, (h, w) in sizes.items():
        got = np.asarray(Image.open(tmp_path / "sr" / name))
        want = np.asarray(Image.open(tmp_path / "sr_jax" / name))
        assert got.shape == (4 * h, 4 * w, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
        assert got.std() > 5   # an image, not a constant
