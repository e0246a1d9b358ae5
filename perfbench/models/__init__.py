"""The models the benchmark serves, one file each, ``models/<name>.py``, found by the
``"model"`` key of a configuration file. The harness keeps no model's names: everything it
needs of one model is in that file, which gives

* ``build(cfg, device)``: the program's model at the configuration's sizes, made on `device`
  (the program is imported inside, never when the file is loaded);
* ``reference(cfg)``: the plain reference (``perfbench/reference``), made under the ambient
  device; its forward takes an NCHW LR batch and returns a dict of NCHW tensors holding
  ``"sr"`` and every name of ``NUMBERS``;
* ``UNSERVED``: prefixes of the state-dict entries the served forward never reads;
* ``NUMBERS``: {name: comparison} (a key of ``core/check.COMPARE``): what the check compares
  each sampled row by, besides the served image;
* ``taps(model)``: [(submodule, pick)]: ``pick(args, out)`` of the submodule's forward gives
  {name of ``NUMBERS``: the batch's tensor, laid out as the reference's};
* ``timed(model)``: {name: submodule} that a traced run puts CUDA events around;
* ``launches(cfg, b, h, w)``: [(kernel, (CUDA-core FLOPs, tensor-core FLOPs, elements))] of
  the program's hand-written kernels in one forward of a [b, h, w, 3] batch, from
  ``core/bounds``' formulas;
* ``BOUNDS``: {kernel wrapper: formula} for the wrappers the model launches that
  ``core/bounds`` has no formula for (``kernels.launched_roofline`` reads it): the formula
  takes the shape the wrapper counts and gives (CUDA-core FLOPs, tensor-core FLOPs, elements);
* ``TINY``: small sizes of the configuration's model keys, which the CPU tests put over the
  configuration's (``perfbench/tests/conftest.py``).

``load`` looks for the file in each directory of ``PATHS`` in turn: this one, and any a test
puts before it.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

from perfbench.reference import serving

HERE = Path(__file__).resolve().parent
PATHS = [HERE]


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The module of ``<name>.py`` in the first directory of ``PATHS`` that holds one."""
    path = next((d / f"{name}.py" for d in PATHS if (d / f"{name}.py").exists()), None)
    if path is None:
        raise FileNotFoundError(f"no model file {name}.py in {[str(d) for d in PATHS]}")
    spec = importlib.util.spec_from_file_location(f"perfbench_model_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(model, cfg: dict, state_dict, device):
    """`model`'s reference (a loaded model file) at `cfg`'s sizes on `device`, filled from
    `state_dict`."""
    with torch.device("meta"):
        ref = model.reference(cfg)
    return serving.build(ref, state_dict, device, model.UNSERVED)
