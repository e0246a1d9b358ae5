"""A model the harness has never seen comes in as files of its own: the toy model file, its
configuration and its limits (``toy/``), with ``models.load`` pointed at that directory, are
served through ``cell.run`` on the CPU and checked, and the metrics without a list of cells
read it."""

import json
import time
from pathlib import Path

import torch

from conftest import ROOT, tiny
from perfbench import models
from perfbench.core import cell
from perfbench.tools.control import control

TOY = Path(__file__).resolve().parent / "toy"
WORKLOAD = "toy.div2k"
#: metrics over the device time of the trace, which a CPU run has none of
CARD_ONLY = {"kernels.port_roofline", "kernels.launched_roofline", "kernels.glue_share"}


class ToySpec(cell.Spec):
    """``BENCHMARK.json`` with the toy's configuration and its cell on the DIV2K-class stream
    added, and the toy's limits beside its model file."""

    def __init__(self):
        super().__init__(ROOT)
        self.bench = {
            **self.bench,
            "configs": self.bench["configs"] + [
                {"name": "toy", "source": "perfbench/tests/toy/toy_sr.py",
                 "file": str((TOY / "toy.json").relative_to(ROOT)), "reduced": [],
                 "why": "a model no cell serves"}],
            "workloads": self.bench["workloads"] + [
                {"name": WORKLOAD, "config": "toy", "traffic": "div2k-stream", "chips": 1,
                 "why": "the toy on the DIV2K-class stream"}]}

    def limits(self, workload):
        return json.loads((TOY / "limits.json").read_text())


def test_a_model_the_harness_has_never_seen(monkeypatch):
    monkeypatch.setattr(models, "PATHS", [TOY, *models.PATHS])
    spec = ToySpec()
    overrides = tiny(WORKLOAD, spec)
    torch.manual_seed(0)
    result, rows, numbers = cell.run(spec, WORKLOAD, 2 ** 31 + 7, 4.0, True, time.perf_counter(),
                                     device="cpu", log=lambda m: None, overrides=overrides)
    assert result["correct"] and result["attempted"] >= 4, rows
    assert set(result["checks"]) == {"features", "u8", "u8_exact"}
    listless = {m["name"] for m in spec.bench["per_layer"] if "workloads" not in m}
    assert listless - CARD_ONLY
    for name in listless:
        if name in CARD_ONLY:
            assert name not in result["metrics"], name
        else:
            value = result["metrics"][name]["value"]
            assert isinstance(value, float) and value >= 0, (name, value)
    # a metric with a list of cells is not the toy's
    listed = {m["name"] for m in spec.bench["per_layer"] if "workloads" in m}
    assert not listed & set(result["metrics"])
    _, control_rows, ok = control(spec, WORKLOAD, 2 ** 31 + 7, torch.device("cpu"),
                                  overrides=overrides)
    assert not ok, control_rows
