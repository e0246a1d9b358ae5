"""``utils/summary.py`` and ``utils/profiling.py`` of the port against the JAX twins: the
parameter count of each model family this slice ports equals the JAX module's (at the
published sizes, shapes only), the FLOPs of one linear and one conv agree with XLA's cost
analysis within 1%, ``StepTimer.summary()`` has the JAX keys, and ``trace`` writes a
Chrome trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freqfusion_tpu.models import fusion_v2 as jv2
from freqfusion_tpu.models import mambair as jm
from freqfusion_tpu.models import tsdsr as jts
from freqfusion_tpu.models import vae as jvae
from freqfusion_tpu.utils import profiling as jprof
from freqfusion_tpu.utils import summary as jsum
from freqfusion_tpu_torch.models import fusion_v2 as tv2
from freqfusion_tpu_torch.models import mambair as tm
from freqfusion_tpu_torch.models import tsdsr as tts
from freqfusion_tpu_torch.models import vae as tvae
from freqfusion_tpu_torch.utils import profiling as tprof
from freqfusion_tpu_torch.utils import summary as tsum

torch.set_num_threads(2)
LR = jnp.zeros((1, 8, 8, 3))
HEAD_ARGS = (LR, {n: jnp.zeros((1, 32, 32, 3)) for n in ("hat", "dat", "nafnet")},
             {"hat": jnp.zeros((1, 8, 8, 180)), "dat": jnp.zeros((1, 8, 8, 180)),
              "nafnet": jnp.zeros((1, 8, 8, 64))})
FAMILIES = {
    "fusion_v2": (jv2.FusionHeadV2(), HEAD_ARGS, tv2.FusionHeadV2),
    "mambair": (jm.MambaIR(), (LR,), tm.MambaIR),
    "vae": (jvae.AutoencoderKL(), (jnp.zeros((1, 16, 16, 3)),), tvae.AutoencoderKL),
    "tsdsr_base": (jts.tsdsr_base(), (jnp.zeros((1, 8, 8, 4)),), tts.tsdsr_base),
    "tsdsr_small": (jts.tsdsr_small(), (jnp.zeros((1, 8, 8, 4)),), tts.tsdsr_small),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_counts_match_jax(family):
    jmodule, args, make = FAMILIES[family]
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *args)["params"]
    model = make()
    assert tsum.count_params(model) == jsum.count_params(shapes)
    breakdown = tsum.params_breakdown(model)
    assert sum(breakdown.values()) == tsum.count_params(model)
    assert list(breakdown.values()) == sorted(breakdown.values(), reverse=True)


def test_flops_match_xla():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((64, 256), (128, 256), (128,)))
    ours = tsum.flop_cost(F.linear, *map(torch.from_numpy, (x, w, b)))
    xla = jsum.xla_cost(lambda x, w, b: x @ w.T + b, x, w, b)
    assert abs(ours["flops"] - xla["flops"]) <= 0.01 * xla["flops"]
    assert ours["bytes accessed"] == 4 * (64 * 256 + 128 * 256 + 128 + 64 * 128)
    # a VALID conv: XLA counts only the taps inside the image, FlopCounterMode all of them
    img, k = (rng.standard_normal(s).astype(np.float32) for s in ((2, 32, 16, 16), (48, 32, 3, 3)))
    ours = tsum.flop_cost(F.conv2d, torch.from_numpy(img), torch.from_numpy(k))
    xla = jsum.xla_cost(lambda a, b: jax.lax.conv_general_dilated(a, b, (1, 1), "VALID"), img, k)
    assert abs(ours["flops"] - xla["flops"]) <= 0.01 * xla["flops"]
    conv = torch.nn.Conv2d(3, 8, 3)
    text, cost = tsum.summarize(lambda t: tv2.run_nhwc([conv], t), conv, torch.zeros(1, 10, 10, 3))
    assert cost["params"] == 8 * 3 * 9 + 8 and cost["flops"] == 2 * 64 * 8 * 27
    assert text.startswith("params: ")


def test_step_timer_keys_match_jax():
    ours, theirs = tprof.StepTimer(), jprof.StepTimer()
    for timer, result in ((ours, torch.ones(3)), (theirs, jnp.ones(3))):
        for _ in range(3):
            timer.start()
            assert timer.stop({"out": [result]}) >= 0.0
    assert set(ours.summary()) == set(theirs.summary()) and ours.summary()["n"] == 3
    assert tprof.StepTimer().summary() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(16, 16) @ torch.ones(16, 16)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)
    stats = tprof.device_memory_stats()
    assert isinstance(stats, dict) and (stats or not torch.cuda.is_available())
