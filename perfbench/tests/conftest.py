"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests``): the checkout
root on the import path, the small runs of a cell on the CPU, and the ``cuda`` marker of the
tests that need a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: a small stream, whole images or tiles, for runs of the harness on the CPU
TINY_STREAM = {"shapes": [[70, 50], [60, 40]], "length": 8, "run_length": [1, 3],
               "sample": {"first": 4}}
TINY_TILED = {"shapes": [[90, 70]], "length": 3, "tile": 32, "overlap": 8, "tile_batch": 2,
              "whole_image_px": 0, "sample": {"first": 1}}


def tiny(workload: str, spec=None) -> dict:
    """Overrides that shrink a cell to a CPU run of a few seconds: the model file's ``TINY``
    sizes, and a small stream of the kind the cell's mix serves (tiles where one of its
    frames takes the tiled path)."""
    from perfbench import models
    from perfbench.core import cell
    from perfbench.reference.serving import whole_bucket

    spec = spec or cell.Spec(ROOT)
    wl = spec.workload(workload)
    cfg, mix = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    tiled = any(whole_bucket(h, w, mix) is None for w, h in mix["shapes"])
    return {"config": dict(models.load(cfg["model"]).TINY),
            "traffic": TINY_TILED if tiled else TINY_STREAM}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card's machine)")
    return torch.device("cuda", 0)
