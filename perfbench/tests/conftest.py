"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests``): the checkout
root on the import path, and the ``cuda`` marker of the tests that need a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: a small FreqFusionSR and a small stream, for runs of the harness on the CPU
TINY_CONFIG = {
    "hat": dict(embed_dim=24, depths=[2], num_heads=[4], window=8, compress=3, squeeze=4,
                conv_scale=0.01, overlap_ratio=0.5, mlp_ratio=2.0, num_feat=16, img_range=1.0),
    "dat": dict(embed_dim=64, depths=[2], num_heads=[4], split_size=[4, 16], expansion=2.0,
                num_feat=16, img_range=1.0),
    "nafnet": dict(width=8, middle_blk_num=1, enc_blk_nums=[1, 1], dec_blk_nums=[1, 1]),
    "head": dict(fusion_dim=16, num_heads=2, refine_depth=2, refine_channels=8, block_size=8)}
TINY_STREAM = {"shapes": [[70, 50], [60, 40]], "length": 8, "run_length": [1, 3],
               "sample": {"first": 4}}
TINY_TILED = {"shapes": [[90, 70]], "length": 3, "tile": 32, "overlap": 8, "tile_batch": 2,
              "whole_image_px": 0, "sample": {"first": 1}}


def tiny(workload: str) -> dict:
    """Overrides that shrink a cell to a CPU run of a few seconds."""
    if "tiled" in workload:
        return {"config": TINY_CONFIG, "traffic": TINY_TILED}
    return {"config": TINY_CONFIG, "traffic": TINY_STREAM}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card's machine)")
    return torch.device("cuda", 0)
