"""Port parity of the data path and the metrics: the augmentations, the datasets and the
batch iterator give the same arrays as the JAX package's from one seed (exact, or 1e-6
where float arithmetic differs; the validation set's bicubic resize to the ops' 2e-5); a cache written by either package's
``extract_cached_features`` reads back through the other's ``CachedFeatureDataset`` (and the
reference's ``.pt`` layout through both); PSNR within 1e-4 dB and SSIM within 1e-5 of the
JAX metrics, ``psnr_ssim_files`` likewise."""

import numpy as np
import pytest
import torch

from freqfusion_tpu.data import augment as ja
from freqfusion_tpu.data import cached as jc
from freqfusion_tpu.data import dataset as jd
from freqfusion_tpu.data import extract as jx
from freqfusion_tpu.utils import metrics as jm
from freqfusion_tpu_torch.data import augment as ta
from freqfusion_tpu_torch.data import cached as tc
from freqfusion_tpu_torch.data import dataset as td
from freqfusion_tpu_torch.data import extract as tx
from freqfusion_tpu_torch.utils import metrics as tm
from freqfusion_tpu_torch.utils.imageio import save_image

torch.set_num_threads(2)


def _pair(seed, lr_hw=(24, 28)):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(size=(4 * lr_hw[0], 4 * lr_hw[1], 3)).astype(np.float32)
    lr = hr.reshape(lr_hw[0], 4, lr_hw[1], 4, 3).mean(axis=(1, 3)).astype(np.float32)
    return lr, hr


def _same(a, b, tol=0.0):
    assert a.shape == b.shape and a.dtype == b.dtype
    if tol:
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(a, b)


def test_train_augmentation_matches_jax():
    """Crop, flips, rotations, colour jitter and LR blur, all on, ten draws (CutBlur on its
    own below: the JAX one raises on some draws)."""
    kw = dict(lr_patch=16, scale=4, use_color_jitter=True, use_cutblur=False, use_blur=True,
              seed=3)
    j, t = ja.TrainAugmentation(**kw), ta.TrainAugmentation(**kw)
    for i in range(10):
        lr, hr = _pair(i)
        for a, b in zip(t(lr, hr), j(lr, hr)):
            _same(a, b)


def test_cutblur_center_crop_and_geometric_group_match_jax():
    """CutBlur equals the JAX one wherever the JAX one computes; on the draws where its
    pasted block overruns the region (a ValueError there) the port clips the block."""
    raised = 0
    for seed in range(12):
        lr, hr = _pair(seed)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ta.cutblur(lr, hr, rt, p=1.0)
        try:
            want = ja.cutblur(lr, hr, rj, p=1.0)
        except ValueError:
            raised += 1
            assert got[1].shape == hr.shape and np.array_equal(got[0], lr)
            continue
        for a, b in zip(got, want):
            _same(a, b)
    assert 0 < raised < 12
    for seed in range(6):
        lr, hr = _pair(seed)
        arrays = [lr, hr, np.random.default_rng(seed).standard_normal((24, 28, 5))]
        for a, b in zip(ta.geometric_augment_group(arrays, np.random.default_rng(seed)),
                        ja.geometric_augment_group(arrays, np.random.default_rng(seed))):
            _same(a, b)
    small = _pair(9, (10, 12))
    for a, b in zip(ta.CenterCrop(16, 4)(*small), ja.CenterCrop(16, 4)(*small)):
        _same(a, b)   # reflect-padded up to the patch first


def test_frequency_augmentation_matches_jax():
    j, t = ja.FrequencyAugmentation(prob=1.0, seed=4), ta.FrequencyAugmentation(prob=1.0, seed=4)
    for i in range(3):
        lr, hr = _pair(20 + i, (13, 21))   # not whole 8x8 blocks: reflect-padded
        for a, b in zip(t(lr, hr), j(lr, hr)):
            _same(a, b, 1e-6)


def _write_split(root, split, n, lr_hw, seed, lr_suffix="x4"):
    rng = np.random.default_rng(seed)
    for i in range(n):
        hr = rng.integers(0, 256, (4 * lr_hw[0], 4 * lr_hw[1], 3), dtype=np.uint8)
        lr = hr.reshape(lr_hw[0], 4, lr_hw[1], 4, 3).mean(axis=(1, 3)).astype(np.uint8)
        save_image(hr, str(root / f"{split}_HR" / f"{i:04d}.png"))
        save_image(lr, str(root / f"{split}_LR" / f"{i:04d}{lr_suffix}.png"))


def test_datasets_and_loaders_match_jax(tmp_path):
    _write_split(tmp_path, "train", 3, (20, 22), 0)
    _write_split(tmp_path, "val", 2, (40, 36), 1, lr_suffix="_LR")
    for split in ("train", "val"):
        dirs = td.find_split_dirs(tmp_path, split)
        assert dirs == jd.find_split_dirs(tmp_path, split)
        assert td.match_pairs(*map(td.list_image_paths, dirs)) == \
            jd.match_pairs(*map(jd.list_image_paths, dirs))
    for stem in ("0001x4", "img_LR", "a_bicubic_x2", "plain"):
        assert td.clean_lr_stem(stem) == jd.clean_lr_stem(stem)
    with pytest.raises(FileNotFoundError):
        td.find_split_dirs(tmp_path / "none", "train")

    tr = td.find_split_dirs(tmp_path, "train")
    tds, jds = td.SRDataset(*tr, 16, repeat=2, seed=5), jd.SRDataset(*tr, 16, repeat=2, seed=5)
    assert len(tds) == len(jds) == 6
    for i in range(len(tds)):
        a, b = tds[i], jds[i]
        assert a["name"] == b["name"]
        _same(a["lr"], b["lr"])
        _same(a["hr"], b["hr"])

    # the validation set clamps the LR side to 32 px, resized bicubic: torch against the JAX
    # re-implementation of torch's kernel, held to the ops' 2e-5 (tests/test_torch_ops.py)
    tv, jv = td.ValidationDataset(*td.find_split_dirs(tmp_path, "val"), max_lr_size=32), \
        jd.ValidationDataset(*jd.find_split_dirs(tmp_path, "val"), max_lr_size=32)
    for i in range(len(tv)):
        a, b = tv[i], jv[i]
        assert a["lr"].shape == b["lr"].shape == (32, 28, 3)
        _same(a["lr"], b["lr"], 2e-5)
        _same(a["hr"], b["hr"], 2e-5)

    t_train, _, t_iter = td.create_dataloaders(tmp_path, lr_patch=16, batch_size=2, seed=7)
    j_train, _, j_iter = jd.create_dataloaders(tmp_path, lr_patch=16, batch_size=2, seed=7)
    for a, b in zip(t_iter(1), j_iter(1)):
        _same(a["lr"], b["lr"])
        _same(a["hr"], b["hr"])


def _fake_forward(batch):
    """A deterministic stand-in for the experts: outputs and features from the batch."""
    up = np.repeat(np.repeat(batch, 4, axis=1), 4, axis=2)
    feats = {n: np.repeat(batch[..., :1], c, axis=-1) * (i + 1)
             for i, (n, c) in enumerate((("hat", 6), ("dat", 6), ("nafnet", 4)))}
    return {n: up * s for n, s in (("hat", 0.9), ("dat", 0.8), ("nafnet", 0.7))}, feats


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caches_are_interchangeable(tmp_path, writer):
    _write_split(tmp_path, "train", 2, (20, 20), 2)
    pairs = jd.match_pairs(*map(jd.list_image_paths, jd.find_split_dirs(tmp_path, "train")))
    extract = jx.extract_cached_features if writer == "jax" else tx.extract_cached_features
    from freqfusion_tpu_torch.utils.imageio import load_image
    n = extract(pairs, lambda lp, hp: (load_image(str(lp)), load_image(str(hp))),
                _fake_forward, str(tmp_path / "cache"), patch=8, crops_per_image=3, batch=4)
    assert n == 6
    for augment in (False, True):
        tds = tc.CachedFeatureDataset(tmp_path / "cache", augment=augment, seed=1)
        jds = jc.CachedFeatureDataset(tmp_path / "cache", augment=augment, seed=1)
        assert len(tds) == len(jds) == 6
        for i in range(6):
            a, b = tds[i], jds[i]
            assert sorted(a) == sorted(b) == sorted(
                ["lr", "hr", "out_hat", "out_dat", "out_nafnet", "feat_hat", "feat_dat",
                 "feat_nafnet"])
            for k in a:
                _same(a[k], b[k])
    tb = list(tc.batch_iterator(tc.CachedFeatureDataset(tmp_path / "cache", augment=False), 4,
                                shuffle=True, seed=3, drop_last=False))
    jb = list(jc.batch_iterator(jc.CachedFeatureDataset(tmp_path / "cache", augment=False), 4,
                                shuffle=True, seed=3, drop_last=False))
    assert [b["lr"].shape[0] for b in tb] == [4, 2]
    for a, b in zip(tb, jb):
        for k in ("lr", "hr"):
            _same(a[k], b[k])
        for group in ("expert_outputs", "expert_features"):
            for name in a[group]:
                _same(a[group][name], b[group][name])
    assert list(tc.prefetch(iter(range(5)))) == list(range(5))


def test_reference_pt_layout_reads_as_in_jax(tmp_path):
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    torch.save({"lr": t(3, 8, 8), "hr": t(3, 32, 32), "outputs": {"drct": t(1, 3, 32, 32)},
                "features": {"drct": t(1, 180, 8, 8)}}, tmp_path / "s0_hat_part.pt")
    torch.save({"outputs": {"grl": t(1, 3, 32, 32), "nafnet": t(1, 3, 32, 32)},
                "features": {"grl": t(1, 180, 8, 8), "nafnet": t(1, 64, 8, 8)}},
               tmp_path / "s0_rest_part.pt")
    a = tc.CachedFeatureDataset(tmp_path, augment=False)[0]
    b = jc.CachedFeatureDataset(tmp_path, augment=False)[0]
    assert sorted(a) == sorted(b) and a["feat_dat"].shape == (8, 8, 180)
    for k in a:
        _same(a[k], b[k])


def test_psnr_ssim_and_the_calculator_match_jax():
    rng = np.random.default_rng(8)
    hr = rng.uniform(size=(2, 40, 36, 3)).astype(np.float32)
    sr = np.clip(hr + 0.05 * rng.standard_normal(hr.shape), -0.1, 1.1).astype(np.float32)
    for border, y in ((0, False), (4, True), (4, False)):
        assert abs(float(tm.psnr(torch.from_numpy(sr), torch.from_numpy(hr), border, y))
                   - float(jm.psnr(sr, hr, border, y))) <= 1e-4
        assert abs(float(tm.ssim(torch.from_numpy(sr), torch.from_numpy(hr), border, y))
                   - float(jm.ssim(sr, hr, border, y))) <= 1e-5
    tcalc, jcalc = tm.MetricCalculator(), jm.MetricCalculator()
    tcalc.update(torch.from_numpy(sr), hr)
    jcalc.update(sr, hr)
    a, b = tcalc.compute(), jcalc.compute()
    assert a["count"] == b["count"] == 2
    assert abs(a["psnr"] - b["psnr"]) <= 1e-4 and abs(a["ssim"] - b["ssim"]) <= 1e-5


def test_psnr_ssim_files_match_jax():
    rng = np.random.default_rng(9)
    target = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
    output = np.clip(target.astype(int) + rng.integers(-9, 10, target.shape), 0, 255).astype(
        np.uint8)
    for border in (0, 4):
        (tp, ts), (jp, js) = tm.psnr_ssim_files(output, target, border), \
            jm.psnr_ssim_files(output, target, border)
        assert abs(tp - jp) <= 1e-4 and abs(ts - js) <= 1e-5
    assert tm.psnr_ssim_files(target, target)[0] == float("inf")
