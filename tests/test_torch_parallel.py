"""Data parallelism of the port on the CPU: training over 2 ``gloo`` ranks against one
process at the same global batch (``parallel/mesh.py``, ``training/steps.py``,
``cli/train.py`` under ``torchrun``), the 2-rank cached step against the JAX step, serving
from 2 CPU replicas (``infer/io.py`` with ``n_devices=2``) against one replica and against
the JAX package on a 2-device mesh, and ``cli/graft_entry.py:dryrun_multichip(2)``.

The rank comparisons run in float64, so that the rounding of another summation order cannot
hide a split that is wrong (a rank's own BatchNorm statistics, its own dropout mask, its own
adaptive-band mean, a gradient left unaveraged): loss and ``grad_norm`` within 1e-5
relative, each leaf's gradient within 1e-5 x its max|g|, the parameters after two steps
within 1e-6, the BatchNorm running statistics within 1e-6, the dropout masks equal. The
CLI under ``torchrun`` runs as shipped, in float32, to the same bounds; the 2-rank step
against JAX to the 2e-4 of ``tests/test_torch_training.py``. Every spawned rank runs under a
deadline that kills it and fails the test (``run_ranks``; 60 s to form a process group)."""

import copy
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from freqfusion_tpu import losses as JL
from freqfusion_tpu.infer import io as jio
from freqfusion_tpu.infer.io import InferencePipeline as JInferencePipeline
from freqfusion_tpu.infer.io import main as jmain
from freqfusion_tpu_torch.cli import graft_entry
from freqfusion_tpu_torch.cli import train as ttrain
from freqfusion_tpu_torch.infer.io import InferencePipeline, main, replica_devices
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.models.fusion import FusionConfig, FusionHead
from freqfusion_tpu_torch.parallel.mesh import Mesh, make_mesh, run_ranks, shard_batch
from freqfusion_tpu_torch.utils.convert import fusion_params_from_flax
from freqfusion_tpu_torch.utils.imageio import save_image

import torch_parallel_ranks as ranks
from test_torch_ensemble import EXPERTS, _reference_model
from test_torch_training import _batch, _jbatch, _synthetic_data, _tiny_head_pair
from torch_parallel_ranks import TINY, double, head_batch, hold

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
FLAG_OFF = dict(TINY, enable_multi_domain_freq=False)   # adaptive bands: a batch mean


@pytest.mark.parametrize("cfg", [TINY, FLAG_OFF], ids=["shipped_flags", "adaptive_bands"])
def test_cached_steps_on_two_ranks_match_one_process(cfg):
    """Two cached steps with dropout and BatchNorm on; `adaptive_bands` also takes the
    adaptive-band split's batch mean, which must be the global batch's."""
    torch.manual_seed(3)
    state = double(FusionHead(FusionConfig(**cfg)).state_dict())
    batches = [head_batch(16, 16, 10), head_batch(16, 16, 20)]
    two = run_ranks(ranks.cached_steps, 2, 2, cfg, state, batches, 1e-3, True,
                    timeout_s=RANK_TIMEOUT_S)
    one = ranks.cached_steps(0, 1, cfg, state, batches, 1e-3, True)
    assert len(one[2]) == 4   # two dropouts a step drew masks
    hold(one, two)


def test_live_steps_on_two_ranks_match_one_process():
    """A tiny FreqFusionSR: the experts frozen in the step, the head's gradients averaged."""
    torch.manual_seed(4)
    state = double(FreqFusionSR(FusionConfig(**TINY), **ranks.LIVE_EXPERTS).state_dict())
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        lr = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
        hr = np.clip(np.kron(lr, np.ones((1, 4, 4, 1), np.float32))
                     + 0.05 * rng.standard_normal((4, 64, 64, 3)), 0, 1).astype(np.float32)
        batches.append({"lr": lr, "hr": hr})
    two = run_ranks(ranks.live_steps, 2, 2, TINY, state, batches, 1e-3,
                    timeout_s=RANK_TIMEOUT_S)
    one = ranks.live_steps(0, 1, TINY, state, batches, 1e-3)
    hold(one, two)
    for _, state2, _ in two:   # the experts never changed
        assert all(torch.equal(state2[k], v) for k, v in state.items()
                   if k.startswith("experts."))


def test_two_rank_cached_step_matches_jax(monkeypatch):
    """The 2-rank float32 step against what the JAX ``make_train_step`` computes before its
    optimizer (its ``loss_fn`` under ``jax.value_and_grad``, one program) on the global batch
    of ``test_cached_step_matches_jax`` (2 samples, one a rank), dropout off on both sides:
    the metrics (the loss components, ``total`` and ``grad_norm``) within 2e-4 relative, the
    running statistics after the step within 1e-5, and the averaged gradient within 2e-4 x
    max|g|, max|g| over every leaf (a leaf whose whole gradient is a cancellation near 0,
    such as a bias of 3e-7, differs by float32's rounding of the terms that cancel, on one
    process too)."""
    import flax.linen as fnn
    import optax

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    batch = _batch(16, 16, 21)
    jm, v, tm = _tiny_head_pair(batch, 22)
    crit = JL.CombinedLoss(ranks.WEIGHTS)
    jb = _jbatch(batch)

    def loss_fn(params):   # jsteps.make_train_step's, without the dropout key
        sr, updates = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb["lr"],
                               jb["expert_outputs"], jb["expert_features"], True,
                               mutable=["batch_stats"])
        total, components = crit(jnp.clip(sr, 0.0, 1.0), jb["hr"])
        return total, (components, updates["batch_stats"])

    (_, (components, stats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    jmetrics = dict(components, grad_norm=optax.global_norm(jgrads))
    want_g = fusion_params_from_flax(jgrads)
    want_stats = fusion_params_from_flax({}, stats)
    two = run_ranks(ranks.cached_steps, 2, 2, TINY, tm.state_dict(), [batch], 5e-3, False, 0,
                    torch.float32, timeout_s=RANK_TIMEOUT_S)
    named = dict(tm.named_parameters())
    assert set(want_g) == set(named)
    top = max(float(g.abs().max()) for g in want_g.values())
    for (steps, sd, _) in two:
        metrics, grads = steps[0]
        assert sorted(metrics) == sorted(jmetrics)
        for k in metrics:
            assert abs(metrics[k] - float(jmetrics[k])) <= 2e-4 * abs(float(jmetrics[k])), k
        for k, w in want_stats.items():
            if not k.endswith("num_batches_tracked"):   # a counter JAX does not keep
                np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
        for k, g in want_g.items():
            got = grads.get(k, torch.zeros_like(g))
            assert float((got - g).abs().max()) <= 2e-4 * top, k


def test_a_batch_the_mesh_does_not_divide_raises():
    mesh = Mesh(2, 1, torch.device("cpu"))
    batch = {"lr": np.zeros((3, 4, 4, 3), np.float32)}
    with pytest.raises(ValueError, match="does not split over 2"):
        shard_batch(batch, mesh)
    rows = shard_batch({"lr": np.arange(4, dtype=np.float32)[:, None]}, mesh)["lr"]
    assert rows.flatten().tolist() == [2.0, 3.0]   # rank 1's rows of the global batch
    with pytest.raises(ValueError, match="rank"):   # two ranks asked, one running
        make_mesh(2, "cpu")


def _torchrun(args, timeout_s=RANK_TIMEOUT_S):
    """`python -m torch.distributed.run` in its own process group, killed whole on a hang."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", "2", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-4000:]
    return out


def test_cli_train_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m freqfusion_tpu_torch.cli.train --debug --device cpu``
    on cached features: every logged loss and grad_norm, the validation PSNR and the
    checkpoint (the head, its BatchNorm statistics, the EMA) equal the one-process run's;
    rank 0 alone writes."""
    from freqfusion_tpu_torch.data.dataset import find_split_dirs, list_image_paths, match_pairs
    from freqfusion_tpu_torch.data.extract import extract_cached_features
    from freqfusion_tpu_torch.models.experts import ExpertEnsemble
    from freqfusion_tpu_torch.utils.imageio import load_image

    _synthetic_data(tmp_path / "data", n=2)
    torch.manual_seed(0)
    experts = ExpertEnsemble(**EXPERTS).eval()

    def forward(x):
        with torch.no_grad():
            outs, feats = experts(torch.from_numpy(x))
        return ({k: v.numpy() for k, v in outs.items()}, {k: v.numpy() for k, v in feats.items()})

    for split, crops in (("train", 2), ("val", 1)):
        pairs = match_pairs(*map(list_image_paths, find_split_dirs(tmp_path / "data", split)))
        extract_cached_features(pairs, lambda lp, hp: (load_image(str(lp)), load_image(str(hp))),
                                forward, str(tmp_path / f"cache_{split}"), patch=16,
                                crops_per_image=crops, batch=2)
    runs = {}
    for name in ("one", "two"):
        with open(os.path.join(REPO, "configs", "train_config.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg["model"].update(TINY)
        cfg["data"].update(cached_train_dir=str(tmp_path / "cache_train"),
                           cached_val_dir=str(tmp_path / "cache_val"))
        cfg["train"].update(checkpoint_dir=str(tmp_path / name / "ckpt"), print_freq=1,
                            log_dir=str(tmp_path / name / "logs"), validate_start=0,
                            save_every=1)
        path = tmp_path / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        args = ["--config", str(path), "--debug", "--device", "cpu"]
        if name == "one":
            ttrain.main(args)
        else:
            _torchrun(["-m", "freqfusion_tpu_torch.cli.train", *args])
        with open(tmp_path / name / "logs" / "metrics.jsonl") as f:
            logged = [json.loads(line) for line in f]
        runs[name] = (logged, torch.load(tmp_path / name / "ckpt" / "latest.ckpt",
                                         weights_only=True))
    (log1, ck1), (log2, ck2) = runs["one"], runs["two"]
    assert [sorted(r) for r in log1] == [sorted(r) for r in log2]
    steps = [r for r in log1 if "train/total" in r]
    assert len(steps) == 4   # 2 epochs of 2 global batches of 2
    for r1, r2 in zip(log1, log2):
        for k in ("train/total", "train/grad_norm", "val/psnr"):
            if k in r1:
                assert abs(r2[k] - r1[k]) <= 1e-5 * abs(r1[k]), (k, r1, r2)
    assert ck1["step"] == ck2["step"] == 4
    for part in ("model", "ema_state"):
        assert sorted(ck1[part]) == sorted(ck2[part])
        for k, v in ck1[part].items():
            bound = 1e-6 if v.is_floating_point() else 0
            assert float((ck2[part][k].double() - v.double()).abs().max()) <= bound, (part, k)
    assert sorted(os.listdir(tmp_path / "two" / "ckpt")) == sorted(os.listdir(tmp_path / "one"
                                                                              / "ckpt"))


# ---- serving from replicas ------------------------------------------------------------

def test_launch_counts_add_up_from_replica_threads():
    """Replicas launch from threads of their own: every launch is counted (16 threads, a
    switch interval of 1 us)."""
    from freqfusion_tpu_torch.ops.kernels import _build

    counts = {"k": 0}

    def launch():
        for _ in range(20000):
            _build.count(counts, "k")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(before)
    assert counts["k"] == 16 * 20000


def test_replicas_follow_the_jax_mesh_rules(monkeypatch):
    ref = _reference_model(9)
    with pytest.raises(ValueError, match="at least 1"):
        InferencePipeline(ref, "cpu", n_devices=0)
    pipe = InferencePipeline(ref, "cpu", tile=32, overlap=8, tile_batch=3, n_devices=2)
    assert pipe.n_devices == 2 and pipe.tile_batch == 4 and pipe.u8_group_max == 2
    assert pipe.replicas[0] is pipe.model and pipe.replicas[1] is not pipe.model
    assert InferencePipeline(_reference_model(9), "cpu", tile_batch=1,
                             n_devices=3).tile_batch == 3
    # None: every card for "cuda", one device otherwise; more cards than present raise
    assert InferencePipeline(_reference_model(9), "cpu").n_devices == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert replica_devices(torch.device("cuda:0"), None) == [torch.device("cuda:0")]
    with pytest.raises(ValueError, match="only 1 card"):
        replica_devices(torch.device("cuda"), 2)
    # a head whose forward takes a batch mean is refused on replicas, served on one device
    flag_off = FreqFusionSR(FusionConfig(**FLAG_OFF), **EXPERTS)
    with pytest.raises(ValueError, match="mean over its batch"):
        InferencePipeline(flag_off, "cpu", n_devices=2)
    assert InferencePipeline(flag_off, "cpu", n_devices=1).n_devices == 1


def test_replicas_serve_as_one_device():
    """On 2 replicas a single image takes the tiled path: within 1e-5 of one device's tiled
    run (the tiled tests' bound against JAX is 2e-4). Where both run whole (a batch of 4
    through ``forward_batch``; groups of 1, 2 and 3 through the batch protocol, the ragged
    ones padded by repeat), within 1e-5, and the uint8 images within 1 LSB."""
    ref = _reference_model(11)
    one = InferencePipeline(ref, "cpu", tile=32, overlap=8, tile_batch=2)
    two = InferencePipeline(copy.deepcopy(ref), "cpu", tile=32, overlap=8, tile_batch=2,
                            n_devices=2)
    tiled_one = InferencePipeline(copy.deepcopy(ref), "cpu", tile=32, overlap=8, tile_batch=2)
    tiled_one.WHOLE_IMAGE_MAX_PX = 0
    rng = np.random.default_rng(12)
    lr = rng.uniform(size=(40, 50, 3)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(two.run_image(lr), tiled_one.run_image(lr), atol=1e-5)
    x = rng.uniform(size=(4, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(two.forward_batch(x).numpy(), one.forward_batch(x).numpy(),
                               atol=1e-5)
    lrs = [rng.uniform(size=(40, 50, 3)).astype(np.float32) for _ in range(3)]
    for group in (lrs[:1], lrs[:2], lrs):
        outs = two.materialize_u8(two.dispatch_batch_u8(group))
        assert len(outs) == len(group)
        for a, out in zip(group, outs):
            want = one.materialize_u8(one.dispatch_batch_u8([a]))[0]
            assert out.shape == (160, 200, 3) and out.dtype == np.uint8
            assert np.abs(out.astype(np.int32) - want.astype(np.int32)).max() <= 1


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    return list(obj) if isinstance(obj, tuple) else obj


def test_main_on_two_replicas_matches_one_and_jax_on_two_devices(tmp_path, monkeypatch):
    """`main` with n_devices=2, through the submission runner's ``--n_devices 2``, on three
    whole frames of one bucket (a group of 2, then a ragged 1 padded by repeat) and a tiled
    one, against n_devices=1 and against the JAX `main` on a 2-device mesh: every PNG within
    1 LSB."""
    from freqfusion_tpu_torch.cli import test as cli_test
    from freqfusion_tpu_torch.infer import io as tio

    built = []

    class Recorded(InferencePipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self.n_devices)

    monkeypatch.setattr(tio, "InferencePipeline", Recorded)

    ref = _reference_model(13)
    model_dir, src = tmp_path / "model", tmp_path / "lr"
    for name, module in (("hat", ref.experts.hat), ("dat", ref.experts.dat),
                         ("nafnet", ref.experts.nafnet)):
        (model_dir / "pretrained" / name).mkdir(parents=True)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    torch.save(ref.fusion.state_dict(), model_dir / "fusion_head.pth")
    rng = np.random.default_rng(14)
    sizes = {"a.png": (70, 80), "b.png": (66, 90), "c.png": (70, 90), "d.png": (30, 40)}
    for name, (h, w) in sizes.items():
        save_image(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), str(src / name))
    kw = dict(expert_kwargs=EXPERTS, tile=32, overlap=8, tile_batch=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(str(model_dir), str(src), str(tmp_path / "sr1"), "cpu", n_devices=1,
                    **kw) == 4
        monkeypatch.setenv("FREQFUSION_MODEL_DIR", str(model_dir))
        cli_test.main(["--input", str(src), "--save_dir", str(tmp_path / "run"), "--device",
                       "cpu", "--n_devices", "2"], **kw)
    sr2 = tmp_path / "run" / cli_test.MODEL_NAME / "valid"
    assert built == [1, 2]
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"expert_kwargs": _yaml_safe(EXPERTS)},
                                   "infer": {"tile": 32, "overlap": 8, "tile_batch": 2}}))
    monkeypatch.setenv("FREQFUSION_CONFIG", str(cfg))
    monkeypatch.setattr(jio, "InferencePipeline",
                        functools.partial(JInferencePipeline, n_devices=2))
    assert jmain(str(model_dir), str(src), str(tmp_path / "sr_jax")) == 4
    for name, (h, w) in sizes.items():
        got = np.asarray(Image.open(sr2 / name)).astype(np.int32)
        assert got.shape == (4 * h, 4 * w, 3)
        for other in ("sr1", "sr_jax"):
            want = np.asarray(Image.open(tmp_path / other / name)).astype(np.int32)
            assert np.abs(got - want).max() <= 1, (name, other)


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    lines = graft_entry.dryrun_multichip(2, device="cpu", timeout_s=RANK_TIMEOUT_S)
    printed = capsys.readouterr().out.splitlines()
    assert printed == lines and len(lines) == 4
    for line, what in zip(lines, ("cached train step OK", "live train step OK",
                                  "sharded inference batch OK",
                                  "sharded whole-image uint8 batch OK")):
        assert line.startswith("dryrun_multichip(2): ") and what in line
