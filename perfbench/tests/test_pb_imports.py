"""What the harness loads: no JAX, no JAX package; the reference loads nothing of the
program; the command fails without a card and in a tree without the program."""

import os
import shutil
import subprocess
import sys

from conftest import ROOT

RUN = [sys.executable, "perfbench/run.py", "--workload", "ff-f32.div2k", "--seed", "3",
       "--seconds", "1", "--trace", "0"]


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                          f"{code}\nprint(' '.join(sorted(sys.modules)))"],
                         capture_output=True, text=True, check=True, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(ROOT / "perfbench"))
    from run import forbidden_modules
    assert forbidden_modules(["freqfusion_tpu_torch", "freqfusion_tpu_torch.infer.io",
                              "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["freqfusion_tpu.models", "jax._src", "flax"]) == [
        "flax", "freqfusion_tpu", "jax"]


def test_harness_and_program_load_no_jax():
    mods = loaded_after("import perfbench.core.cell, perfbench.tools.control\n"
                        "from perfbench import models\n"
                        "models.load('freqfusion_sr')\n"
                        "import perfbench.core.flops, perfbench.core.bounds\n"
                        "from perfbench.core import cell\n"
                        "for m in ('device.mfu', 'kernels.port_roofline'): cell.reader(m)\n"
                        "import freqfusion_tpu_torch.infer.io, freqfusion_tpu_torch.models.experts")
    sys.path.insert(0, str(ROOT / "perfbench"))
    from run import forbidden_modules
    assert "freqfusion_tpu_torch.infer.io" in mods
    assert forbidden_modules(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after("import perfbench.reference.serving, perfbench.core.check, "
                        "perfbench.core.flops\n"
                        "from perfbench import models\n"
                        "models.load('freqfusion_sr').reference")
    assert not [m for m in mods if m.split(".")[0].startswith("freqfusion_tpu")]


def test_command_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    out = subprocess.run(RUN, capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_command_fails_in_a_tree_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
