"""The check on the CPU at a small size: the reference against the program's plain path, the
control, and the faults of a broken timed path, each of which must come out not correct."""

import time

import numpy as np
import pytest
import torch

from conftest import tiny
from perfbench import models
from perfbench.core import cell
from perfbench.reference.ops import round_mantissa
from perfbench.tools.control import control

SPEC = cell.Spec(cell.HERE.parent)
CELLS = [w["name"] for w in SPEC.bench["workloads"]]
# each cell, and the whole-image f32 cell on four CPU replicas: the replica path of the
# pipeline (threads, the gather to the first device, padded groups) under the same check
RUNS = [(w, 1) for w in CELLS] + [("ff-f32.div2k", 4)]
WINDOW_S = 4.0


def run_tiny(workload, seed=20240611, replicas=1):
    torch.manual_seed(0)
    overrides = tiny(workload)
    if replicas > 1:
        # full groups, so that every replica serves a real frame
        overrides["traffic"] = {**overrides["traffic"], "n_devices": replicas,
                                "run_length": [4, 6], "length": 12, "sample": {"first": 8}}
    # a window of some forwards even on a loaded machine, so that the sampled frames are served
    result, _, numbers = cell.run(SPEC, workload, seed, WINDOW_S, False, time.perf_counter(),
                                  device="cpu", log=lambda m: None, overrides=overrides)
    return result, numbers


def config_of(workload):
    return SPEC.config(SPEC.workload(workload)["config"])


@pytest.mark.parametrize("workload,replicas", RUNS)
def test_reference_agrees_with_the_program(workload, replicas):
    result, numbers = run_tiny(workload, replicas=replicas)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and set(result["checks"]) == set(SPEC.limits(workload))
    cfg = config_of(workload)
    if (cfg["dtype"], cfg["precision"]) == ("float32", "highest"):   # f32 exact: rounding only
        assert max(numbers[n] for n in models.load(cfg["model"]).NUMBERS) < 2e-6, numbers
        assert numbers["u8"] < 1e-3


@pytest.mark.parametrize("workload", ["ff-f32.div2k", "ff-bf16.div2k", "ff-default.div2k"])
def test_control_reads_above_the_program(workload):
    """Each number the cell compares of the model's, on the control, reads over three times
    the program's."""
    _, program = run_tiny(workload, seed=5)
    numbers, _, _ = control(SPEC, workload, 5, torch.device("cpu"), overrides=tiny(workload))
    compared = set(SPEC.limits(workload)) & set(models.load(config_of(workload)["model"]).NUMBERS)
    assert compared
    for n in compared:
        assert numbers[n] > 3 * program[n], (n, numbers[n], program[n])


def test_operand_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 3 * 2 ** -11, 1e-8])
    tf32 = round_mantissa(x, 10)
    assert tf32.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -1.0 - 2 ** -9, pytest.approx(1e-8, 1e-3)]
    assert round_mantissa(torch.tensor([1.1875, 1.0625]), 3).tolist() == [1.25, 1.0]


def _patch(monkeypatch, fault):
    """Breaks InferencePipeline's forward underneath the harness."""
    from freqfusion_tpu_torch.infer.io import InferencePipeline
    real = InferencePipeline._forward_device
    last = {}

    def broken(self, x):
        out = real(self, x)
        n = len(out)
        if fault == "answer_altered":        # a served image altered where it is made
            out = out.clone()
            out[..., ::5, :, :] = 1.0 - out[..., ::5, :, :]
        elif fault == "half_batch":          # half the batch left out: the rest's answers
            out = torch.cat([out[: n // 2]] * 2) if n > 1 else out
        elif fault == "no_exchange":         # card 0 keeps its own rows for every replica's
            k = n // self.n_devices
            out = torch.cat([out[:k]] * self.n_devices)
        elif fault == "state_unchanged":     # the previous answer of this shape, again
            key = tuple(out.shape)
            out, last[key] = last.get(key, out), out
        return out

    monkeypatch.setattr(InferencePipeline, "_forward_device", broken)


FAULTS = [("ff-f32.div2k", 1, "answer_altered"), ("ff-f32.div2k", 1, "state_unchanged"),
          ("ff-bf16.div2k", 1, "answer_altered"), ("ff-bf16.div2k", 1, "state_unchanged"),
          ("ff-default.div2k", 1, "answer_altered"), ("ff-default.div2k", 1, "state_unchanged"),
          ("ff-f32.div2k", 4, "answer_altered"), ("ff-f32.div2k", 4, "half_batch"),
          ("ff-f32.div2k", 4, "no_exchange"), ("ff-f32.div2k", 4, "state_unchanged"),
          ("ff-f32.tiled-540p", 1, "answer_altered"), ("ff-f32.tiled-540p", 1, "half_batch"),
          ("ff-f32.tiled-540p", 1, "state_unchanged")]


@pytest.mark.parametrize("workload,replicas,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, replicas, fault):
    _patch(monkeypatch, fault)
    result, numbers = run_tiny(workload, replicas=replicas)
    assert not result["correct"], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    """On the card at the cell's own size: the reference at the precision below the
    configuration's, in the program's place, fails the cell's limits."""
    numbers, rows, ok = control(SPEC, workload, 31, card)
    assert not ok, rows
