"""Port parity of the training path: the head in train mode (output, BatchNorm running
statistics, every parameter's gradient), the optimizer against optax, one whole cached step
and one whole live step against the JAX steps, the schedules, EMA, the checkpoint manager
and the native ``.ckpt`` formats that ``main`` serves, and ``cli/train.py --debug`` on the
CPU in both modes. JAX runs on the CPU as the reference.

Dropout is neutralised on both sides inside the tests (flax's ``nn.Dropout`` returns its
input, the port's ``layers.dropout`` is the identity); ``test_dropout_keeps_1_minus_p_and_
scales`` holds the port's helper on its own. Bounds: the head 2e-4 (PARITY.md), running
statistics 1e-5, gradients 2e-4 x the leaf's max|g|, the optimizer 1e-6 relative, the
schedule 1e-7 relative, EMA 1e-7, served images 1 LSB."""

import functools
import json
import os
import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from freqfusion_tpu import losses as JL
from freqfusion_tpu.infer import io as jio
from freqfusion_tpu.infer.io import InferencePipeline as JInferencePipeline
from freqfusion_tpu.infer.io import main as jmain
from freqfusion_tpu.models import fusion as jfusion
from freqfusion_tpu.models.experts import FreqFusionSR as JFreqFusionSR
from freqfusion_tpu.training import checkpoint as jckpt
from freqfusion_tpu.training import ema as jema
from freqfusion_tpu.training import schedule as jsched
from freqfusion_tpu.training import steps as jsteps
from freqfusion_tpu_torch import losses as TL
from freqfusion_tpu_torch.cli import train as ttrain
from freqfusion_tpu_torch.infer.io import main as tmain
from freqfusion_tpu_torch.infer.io import read_native_checkpoint
from freqfusion_tpu_torch.models import fusion as tfusion
from freqfusion_tpu_torch.models import layers as tlayers
from freqfusion_tpu_torch.models.experts import FreqFusionSR
from freqfusion_tpu_torch.training import checkpoint as tckpt
from freqfusion_tpu_torch.training import ema as tema
from freqfusion_tpu_torch.training import schedule as tsched
from freqfusion_tpu_torch.training import steps as tsteps
from freqfusion_tpu_torch.utils.convert import (fusion_params_from_flax,
                                                freqfusion_params_from_flax)
from freqfusion_tpu_torch.utils.imageio import save_image
from test_torch_ensemble import EXPERTS
from test_torch_fusion import head_inputs, jarr, tarr

torch.set_num_threads(2)
T = torch.from_numpy
TINY = dict(fusion_dim=16, num_heads=2, refine_depth=2, refine_channels=16)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(tlayers, "dropout", lambda x, p, training: x)


def _batch(h, w, seed, b=2):
    """A batch of b: lr, the experts' outputs and features, hr (numpy)."""
    parts = [head_inputs(h, w, seed + i) for i in range(b)]
    lr = np.concatenate([p[0] for p in parts])
    outs = {n: np.concatenate([p[1][n] for p in parts]) for n in parts[0][1]}
    feats = {n: np.concatenate([p[2][n] for p in parts]) for n in parts[0][2]}
    rng = np.random.default_rng(seed + 100)
    hr = np.clip(outs["hat"] + 0.05 * rng.standard_normal(outs["hat"].shape), 0, 1)
    return {"lr": lr, "expert_outputs": outs, "expert_features": feats,
            "hr": hr.astype(np.float32)}


def _random_variables(init_fn, seed):
    """Variables of the shapes that `init_fn` gives (traced only, nothing computed), drawn
    with numpy as ``test_torch_ensemble.random_variables`` draws them: kernels N(0,
    1/fan_in), biases and running means N(0, 0.1), running variances U(0.6, 1.4), the FFT
    mask logits N(0, 1), scalars near 0.2, other scales and weights N(1, 0.1)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in jax.eval_shape(init_fn).items():
        flat = {}
        for path, leaf in flatten_dict(tree).items():
            shape, name = leaf.shape, path[-1]
            stack = (path[2] == "layers") + ("pairs" in path) if path[0] == "experts" else 0
            if name.endswith("kernel") or name == "in_proj_weight":
                a = rng.standard_normal(shape) * float(np.prod(shape[stack:-1])) ** -0.5
            elif name in ("var", "running_var"):
                a = rng.uniform(0.6, 1.4, shape)
            elif name in ("bias", "mean", "running_mean", "in_proj_bias", "beta", "gamma") \
                    or name.endswith("_bias"):
                a = 0.1 * rng.standard_normal(shape)
            elif name == "relative_position_bias_table":
                a = 0.5 * rng.standard_normal(shape)
            elif name == "freq_mask_logits":
                a = rng.standard_normal(shape)
            elif len(shape) == 0:
                a = (5.0 if name == "temperature" else 0.2) + 0.05 * rng.standard_normal()
            else:
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            flat[path] = np.asarray(a, dtype=np.float32)
        out[col] = unflatten_dict(flat)
    return out


def _tiny_head_pair(batch, seed):
    jm = jfusion.FusionHead(jfusion.FusionConfig(**TINY))
    v = _random_variables(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["lr"][:1]),
        jarr({k: a[:1] for k, a in batch["expert_outputs"].items()}),
        jarr({k: a[:1] for k, a in batch["expert_features"].items()})), seed)
    tm = tfusion.FusionHead(tfusion.FusionConfig(**TINY))
    tm.load_state_dict(fusion_params_from_flax(v["params"], v["batch_stats"]), strict=True)
    return jm, v, tm


def _tbatch(batch):
    return {k: (tarr(v) if isinstance(v, dict) else T(v)) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jarr(v) for k, v in batch.items()}


def test_head_in_train_mode_matches_jax(no_dropout):
    """Output, the running statistics after the step (each BatchNorm of the per-band LKA
    updated once a band, in band order) and every parameter's gradient of an L1 loss."""
    batch = _batch(16, 16, 3)
    jm, v, tm = _tiny_head_pair(batch, 4)
    jb = _jbatch(batch)

    def jloss(params):
        sr, upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jb["lr"],
                           jb["expert_outputs"], jb["expert_features"], True,
                           mutable=["batch_stats"])
        return JL.l1_loss(jnp.clip(sr, 0.0, 1.0), jb["hr"]), (sr, upd["batch_stats"])

    (_, (jsr, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(v["params"])
    tm.train()
    tb = _tbatch(batch)
    sr = tm(tb["lr"], tb["expert_outputs"], tb["expert_features"])
    TL.l1_loss(sr.clamp(0.0, 1.0), tb["hr"]).backward()
    np.testing.assert_allclose(sr.detach().numpy(), np.asarray(jsr), atol=2e-4)

    want_stats = fusion_params_from_flax({}, jstats)
    sd = tm.state_dict()
    stat_keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 18 and set(stat_keys) <= set(want_stats)
    for k in stat_keys:
        np.testing.assert_allclose(sd[k].numpy(), want_stats[k].numpy(), atol=1e-5, err_msg=k)
        assert not np.allclose(want_stats[k].numpy(),
                               fusion_params_from_flax({}, v["batch_stats"])[k].numpy())

    want_g = fusion_params_from_flax(jgrads)
    named = dict(tm.named_parameters())
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        got = named[k].grad
        got = torch.zeros_like(named[k]) if got is None else got
        bound = 2e-4 * float(g.abs().max()) + 1e-12
        assert float((got - g).abs().max()) <= bound, k


def test_dropout_keeps_1_minus_p_and_scales():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    with tlayers.dropout_generator(gen):
        y = tlayers.dropout(x, 0.1, True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    with tlayers.dropout_generator(torch.Generator().manual_seed(0)):
        assert torch.equal(tlayers.dropout(x, 0.1, True), y)   # the generator fixes the mask
    assert tlayers.dropout(x, 0.1, False) is x


def _flat(tree):
    return {"/".join(k): np.asarray(a) for k, a in flatten_dict(tree).items()}


def test_optimizer_matches_optax():
    """Four mini-steps of accumulation 2: JAX gradients through the port's clip + AdamW +
    MultiSteps + schedule against optax, a large gradient (clipped) and a small one."""
    rng = np.random.default_rng(0)
    params = {"a": {"kernel": rng.standard_normal((6, 5)).astype(np.float32)},
              "b": {"bias": rng.standard_normal(5).astype(np.float32)},
              "s": np.float32(0.1)}
    grads = []
    for i, scale in enumerate((3.0, 0.01, 0.02, 5.0)):
        grads.append(jax.tree_util.tree_map(
            lambda a: (scale * rng.standard_normal(np.shape(a))).astype(np.float32), params))
    jsched_fn = jsched.warmup_then_cosine_restarts(1e-2, 1, 2, 2)
    tx = jsteps.make_optimizer(jsched_fn, 1e-4, 1.0, accum_steps=2)
    jp, state = jax.tree_util.tree_map(jnp.asarray, params), None
    state = tx.init(jp)
    tp = {k: torch.tensor(a) for k, a in _flat(params).items()}
    opt = tsteps.OptaxAdamW(tp.values(), tsched.warmup_then_cosine_restarts(1e-2, 1, 2, 2),
                            1e-4, 1.0, accum_steps=2)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, a in _flat(g).items():
            tp[k].grad = torch.tensor(a)
        opt.step()
        for k, want in _flat(jax.device_get(jp)).items():
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.param_groups[0]["count"] == 2 and opt.param_groups[0]["mini_step"] == 0


def _step_setup(batch, seed):
    jm, v, tm = _tiny_head_pair(batch, seed)
    weights = {"l1": 0.6, "swt": 0.25, "fft": 0.1, "edge": 0.05, "ssim": 0.05}
    crit_j, crit_t = JL.CombinedLoss(weights), TL.CombinedLoss(weights)
    return jm, v, tm, crit_j, crit_t


def test_cached_step_matches_jax(no_dropout):
    """One cached step at a constant lr of 5e-3, so that AdamW's update (about lr * sign(g)
    on a first step) stands well above the rounding of the parameters: the metrics, the
    running statistics after the step within 1e-5, and each parameter's change against
    JAX's. Where JAX's change is at least 0.9 lr (|g| >= 9 eps: sign and size settled) the
    two agree within 1e-3 lr; below (|g| within about 1e-7 of 0, a key bias's exact 0
    among them), g / (|g| + eps) follows the gradient's last bits, and they agree within
    2e-2 lr (1e-4)."""
    batch = _batch(16, 16, 21)
    jm, v, tm, crit_j, crit_t = _step_setup(batch, 22)
    lr = 5e-3
    tx = jsteps.make_optimizer(lambda count: lr, 1e-4, 1.0, 1)
    state = jsteps.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                              jnp.asarray(0))
    jstep = jax.jit(jsteps.make_train_step(jm, crit_j, tx))
    new_state, jmetrics = jstep(state, _jbatch(batch), jax.random.PRNGKey(0))

    before = {k: t.clone() for k, t in tm.state_dict().items()}
    opt = tsteps.make_optimizer(tm, lambda n: lr, 1e-4, 1.0, 1)
    metrics = tsteps.make_train_step(tm, crit_t, opt)(_tbatch(batch))
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 2e-4 * abs(float(jmetrics[k])), k
    want = fusion_params_from_flax(jax.device_get(new_state.params),
                                   jax.device_get(new_state.batch_stats))
    sd, named = tm.state_dict(), dict(tm.named_parameters())
    moved = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):   # a counter the JAX trees do not keep
            continue
        if k not in named:   # running statistics
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5, err_msg=k)
            continue
        d_t, d_j = (sd[k] - before[k]).numpy(), (w - before[k]).numpy()
        settled = np.abs(d_j) >= 0.9 * lr
        err = np.abs(d_t - d_j)
        assert err[settled].max(initial=0.0) <= 1e-3 * lr, k
        assert err[~settled].max(initial=0.0) <= 2e-2 * lr, k
        moved.append(np.abs(d_j).ravel())
    assert np.median(np.concatenate(moved)) > 0.9 * lr   # most changes are settled steps


# one-stage experts for the live step: its JAX side compiles the experts' forward and the
# head's step as one program
LIVE_EXPERTS = dict(
    hat_kwargs=dict(EXPERTS["hat_kwargs"], depths=(2,), num_heads=(4,)),
    dat_kwargs=dict(EXPERTS["dat_kwargs"], depths=(2,), num_heads=(4,)),
    nafnet_kwargs=dict(EXPERTS["nafnet_kwargs"], enc_blk_nums=(1,), dec_blk_nums=(1,)))


def test_live_step_matches_jax(no_dropout):
    """FreqFusionSR with tiny experts: one live step; the experts never change."""
    rng = np.random.default_rng(31)
    lr = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    hr = np.clip(np.kron(lr, np.ones((1, 4, 4, 1), np.float32))
                 + 0.05 * rng.standard_normal((2, 64, 64, 3)), 0, 1).astype(np.float32)
    jm = JFreqFusionSR(jfusion.FusionConfig(**TINY), **LIVE_EXPERTS)
    v = _random_variables(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(lr[:1]), True), 32)
    tm = FreqFusionSR(tfusion.FusionConfig(**TINY), **LIVE_EXPERTS)
    tm.load_state_dict(freqfusion_params_from_flax(v), strict=True)
    weights = {"l1": 0.75, "swt": 0.2, "fft": 0.05}
    sched = (jsched.warmup_then_cosine_restarts(1e-3, 2, 4, 2),
             tsched.warmup_then_cosine_restarts(1e-3, 2, 4, 2))
    tx = jsteps.make_frozen_expert_optimizer(sched[0], 1e-4, 1.0, 1)
    state = jsteps.TrainState(v["params"], v["batch_stats"], tx.init(v["params"]),
                              jnp.asarray(0))
    jstep = jax.jit(jsteps.make_live_train_step(jm, JL.CombinedLoss(weights), tx))
    _, jmetrics = jstep(state, {"lr": jnp.asarray(lr), "hr": jnp.asarray(hr)},
                        jax.random.PRNGKey(0))
    experts_before = {k: t.clone() for k, t in tm.experts.state_dict().items()}
    head_before = {k: t.clone() for k, t in tm.fusion.state_dict().items()}
    opt = tsteps.make_frozen_expert_optimizer(tm, sched[1], 1e-4, 1.0, 1)
    metrics = tsteps.make_live_train_step(tm, TL.CombinedLoss(weights), opt)(
        {"lr": T(lr), "hr": T(hr)})
    for k in ("total", "grad_norm"):
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 2e-4 * abs(float(jmetrics[k])), k
    assert all(torch.equal(t, experts_before[k]) for k, t in tm.experts.state_dict().items())
    assert any(not torch.equal(t, head_before[k]) for k, t in tm.fusion.state_dict().items())
    assert not tm.experts.training and all(not p.requires_grad for p in tm.experts.parameters())


def test_schedule_matches_optax():
    """The shipped recipe's shape (5-epoch warmup, T0 50, T_mult 2) at 3 steps an epoch:
    every update count to 400, across the warmup's end and two restarts. Both sides in
    float64 (optax under jax's x64 mode), so that the formulas and their boundaries are
    compared, not float32's rounding of them (optax in float32 is off by about 1e-11
    absolute, which near a cycle's end, where the rate tends to 0, is large relative)."""
    got = tsched.warmup_then_cosine_restarts(1.5e-4, 15, 150, 2)
    sgdr_t = tsched.cosine_warm_restarts(1.0, 4, 2, 3, 0.1)
    with jax.enable_x64(True):
        want = jsched.warmup_then_cosine_restarts(1.5e-4, 15, 150, 2)
        sgdr_j = jsched.cosine_warm_restarts(1.0, 4, 2, 3, 0.1)
        for n in range(401):
            w = float(want(jnp.asarray(n, jnp.int64)))
            assert abs(got(n) - w) <= 1e-7 * abs(w), n
        for n in range(40):
            w = float(sgdr_j(jnp.asarray(n, jnp.int64)))
            assert abs(sgdr_t(n) - w) <= 1e-7 * abs(w), n
    assert got(0) == pytest.approx(1.5e-6, rel=1e-12)


def test_multi_stage_loss_scheduler_matches_jax():
    with open("configs/train_config.yaml") as f:
        stages = yaml.safe_load(f)["loss"]["stages"]
    js, ts = jsched.MultiStageLossScheduler(stages), tsched.MultiStageLossScheduler(stages)
    for epoch in (0, 1, 79, 80, 149, 150, 199, 200, 500):
        assert ts.stage_index(epoch) == js.stage_index(epoch)
        assert ts.weights_for_epoch(epoch) == js.weights_for_epoch(epoch)
        assert ts.is_transition(epoch) == js.is_transition(epoch)
        assert ts.describe(epoch) == js.describe(epoch)
    for bad in ([], [{"epochs": [1, 5], "weights": {}}],
                [{"epochs": [0, 5], "weights": {}}, {"epochs": [6, 9], "weights": {}}]):
        with pytest.raises(ValueError):
            jsched.MultiStageLossScheduler(bad)
        with pytest.raises(ValueError):
            tsched.MultiStageLossScheduler(bad)


def test_ema_matches_jax():
    """Three updates, both sides in float64 (jax's x64 mode): the formula, not float32's
    rounding of it (XLA fuses the update's multiply-add, torch rounds twice: 1 ulp)."""
    rng = np.random.default_rng(5)
    module = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3)).double()
    names = [k for k, _ in module.named_parameters()]
    te = tema.EMA(module, 0.9995)
    assert sorted(te.shadow) == sorted(names)   # parameters only: no running statistics
    with jax.enable_x64(True):
        je = jema.EMA({k: jnp.asarray(p.detach().numpy()) for k, p in module.named_parameters()},
                      0.9995)
        for _ in range(3):
            with torch.no_grad():
                for p in module.parameters():
                    p.add_(torch.from_numpy(rng.standard_normal(p.shape)))
            je.update({k: jnp.asarray(p.detach().numpy())
                       for k, p in module.named_parameters()})
            te.update(module)
        for k in names:
            np.testing.assert_allclose(te.shadow[k].numpy(), np.asarray(je.shadow[k]),
                                       rtol=1e-7, atol=1e-7)
    live = {k: p.detach().clone() for k, p in module.named_parameters()}
    te.apply(module)
    assert torch.equal(dict(module.named_parameters())["0.weight"], te.shadow["0.weight"])
    te.shadow["0.weight"].add_(1.0)   # the shadow is a copy, not the parameter
    assert not torch.equal(dict(module.named_parameters())["0.weight"], te.shadow["0.weight"])
    te.restore(module)
    assert all(torch.equal(p, live[k]) for k, p in module.named_parameters())
    other = tema.EMA(module)
    other.load_state_dict(te.state_dict())
    assert all(torch.equal(other.shadow[k], te.shadow[k]) for k in names)


def test_checkpoint_manager_names_evicts_and_records_as_jax(tmp_path):
    seq = [(0, 20.0, True), (1, 22.5, True), (2, 21.0, False), (3, 23.25, True),
           (4, 19.0, True), (5, 24.0, True), (9, 10.0, False)]
    dirs = {"jax": tmp_path / "j", "port": tmp_path / "t"}
    jm = jckpt.CheckpointManager(str(dirs["jax"]), max_best=2, save_every=5)
    tm = tckpt.CheckpointManager(str(dirs["port"]), max_best=2, save_every=5)
    for epoch, psnr, best in seq:
        best = best and jm.is_best(psnr)
        assert tm.is_best(psnr) == best and tm.should_save(epoch) == jm.should_save(epoch)
        jm.save_checkpoint(epoch, {"params": {"w": np.ones(2, np.float32)}}, {"psnr": psnr},
                           best)
        tm.save_checkpoint(epoch, {"model": {"w": torch.ones(2)}}, {"psnr": psnr}, best)
        assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    assert tm.best_value() == jm.best_value() == 24.0
    assert os.path.basename(tm.get_best_checkpoint()) == "best_epoch0005_psnr24.00.ckpt"

    def history(d):
        with open(d / "training_history.json") as f:
            data = json.load(f)
        for b in data["best"]:
            b["path"] = os.path.basename(b["path"])
        return data

    assert history(dirs["port"]) == history(dirs["jax"])
    # resume: the best-K entries come back from the history
    again = tckpt.CheckpointManager(str(dirs["port"]), max_best=2)
    assert again.best == tm.best and again.best_value() == 24.0


def _tiny_model_dir(tmp_path, seed):
    """A model directory with the tiny experts' .pth files (seeded port weights) and LR
    frame (40x40: one whole-image bucket of 64x64); returns (model_dir, lr_dir)."""
    torch.manual_seed(seed)
    ref = FreqFusionSR(tfusion.FusionConfig(**TINY), **EXPERTS)
    model_dir = tmp_path / "model"
    for name, module in (("hat", ref.experts.hat), ("dat", ref.experts.dat),
                         ("nafnet", ref.experts.nafnet)):
        (model_dir / "pretrained" / name).mkdir(parents=True)
        torch.save(module.state_dict(), model_dir / "pretrained" / name / f"{name}.pth")
    src = tmp_path / "lr"
    save_image(np.random.default_rng(seed).integers(0, 256, (40, 40, 3), dtype=np.uint8),
               str(src / "a.png"))
    return model_dir, src


def _yaml_safe(obj):
    if isinstance(obj, dict):
        return {k: _yaml_safe(v) for k, v in obj.items()}
    return list(obj) if isinstance(obj, tuple) else obj


def test_a_jax_written_ckpt_serves_through_the_port_like_jax(tmp_path, monkeypatch):
    """A msgpack .ckpt that the JAX CheckpointManager wrote for a tiny head (live layout:
    the head under params/fusion) serves through the port's `main` within 1 LSB of the JAX
    `main` on the same directory."""
    model_dir, src = _tiny_model_dir(tmp_path, 41)
    batch = _batch(8, 8, 42, b=1)
    _, v, _ = _tiny_head_pair(batch, 43)
    mgr = jckpt.CheckpointManager(str(model_dir / "checkpoints"))
    mgr.save_checkpoint(3, {"params": {"fusion": v["params"]},
                            "batch_stats": {"fusion": v["batch_stats"]},
                            "opt_state": {}, "step": 7, "ema_state": {}},
                        {"psnr": 27.5}, is_best=True)
    assert os.path.exists(model_dir / "checkpoints" / "best_epoch0003_psnr27.50.ckpt")
    sd = read_native_checkpoint(str(model_dir / "checkpoints" / "latest.ckpt"))
    assert set(sd) >= {k for k in fusion_params_from_flax(v["params"], v["batch_stats"])}

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tmain(str(model_dir), str(src), str(tmp_path / "sr"), "cpu",
                     fusion_config=tfusion.FusionConfig(**TINY), expert_kwargs=EXPERTS) == 1
        cfg = tmp_path / "tiny.yaml"
        cfg.write_text(yaml.safe_dump({"model": {"expert_kwargs": _yaml_safe(EXPERTS),
                                                 **TINY}}))
        monkeypatch.setenv("FREQFUSION_CONFIG", str(cfg))
        monkeypatch.setattr(jio, "InferencePipeline",
                            functools.partial(JInferencePipeline, n_devices=1))
        assert jmain(str(model_dir), str(src), str(tmp_path / "sr_jax")) == 1
    got = np.asarray(Image.open(tmp_path / "sr" / "a.png")).astype(np.int32)
    want = np.asarray(Image.open(tmp_path / "sr_jax" / "a.png")).astype(np.int32)
    assert got.shape == (160, 160, 3) and np.abs(got - want).max() <= 1
    assert got.std() > 5


def _synthetic_data(root, n=3, lr_hw=(40, 40), seed=0):
    """LR/HR PNG pairs under root/{train,val}_{LR,HR}."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for i in range(n):
            hr = rng.integers(0, 256, (4 * lr_hw[0], 4 * lr_hw[1], 3), dtype=np.uint8)
            lr = hr.reshape(lr_hw[0], 4, lr_hw[1], 4, 3).mean(axis=(1, 3)).astype(np.uint8)
            save_image(hr, str(root / f"{split}_HR" / f"img{i}.png"))
            save_image(lr, str(root / f"{split}_LR" / f"img{i}x4.png"))


def _debug_cfg(tmp_path, **data):
    args = ttrain.argparse.Namespace(batch_size=None, epochs=None, data_root=None,
                                     cached=None, debug=True)
    cfg = ttrain.load_config("configs/train_config.yaml", args)
    cfg["model"].update(TINY)
    cfg["data"].update(data)
    cfg["train"].update(checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
                        validate_start=0, save_every=1)
    return cfg


def test_cli_train_debug_cached_writes_and_resumes(tmp_path):
    """--debug on caches that extract_cached_features wrote; the checkpoint serves through
    `main`, and a second run resumes: step, optimizer state, EMA and best-K come back."""
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
        assert extract_cached_features(
            pairs, lambda lp, hp: (load_image(str(lp)), load_image(str(hp))), forward,
            str(tmp_path / f"cache_{split}"), patch=16, crops_per_image=crops, batch=2) \
            == 2 * crops
    cfg = _debug_cfg(tmp_path, cached_train_dir=str(tmp_path / "cache_train"),
                     cached_val_dir=str(tmp_path / "cache_val"))
    best = ttrain.train(cfg, "cpu")
    ckpt_dir = tmp_path / "ckpt"
    names = sorted(os.listdir(ckpt_dir))
    assert "latest.ckpt" in names and any(n.startswith("best_epoch") for n in names)
    first = torch.load(ckpt_dir / "latest.ckpt", weights_only=True)
    assert first["epoch"] == 1 and first["step"] == 4
    assert best == max(first["metrics"]["psnr"], best) and best > 0
    assert first["opt_state"]["param_groups"][0]["count"] == 2   # accumulation 2
    assert first["ema_state"]

    cfg["train"]["epochs"] = 3
    ttrain.train(cfg, "cpu")
    second = torch.load(ckpt_dir / "latest.ckpt", weights_only=True)
    assert second["epoch"] == 2 and second["step"] == 6
    assert second["opt_state"]["param_groups"][0]["count"] == 3
    with open(ckpt_dir / "training_history.json") as f:
        assert [h["epoch"] for h in json.load(f)["history"]] == [0, 1, 2]

    # the trained head (the best checkpoint: main's order) serves through main with its EMA
    # weights, as the same weights do from a .pth
    model_dir, src = _tiny_model_dir(tmp_path, 51)
    best_path = sorted(ckpt_dir.glob("best_*.ckpt"))[0]
    record = torch.load(best_path, weights_only=True)
    head = {**record["model"], **record["ema_state"]}
    assert any(not torch.equal(head[k], record["model"][k]) for k in record["ema_state"])
    torch.save(head, model_dir / "head.pth")
    kw = dict(fusion_config=tfusion.FusionConfig(**TINY), expert_kwargs=EXPERTS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tmain(str(model_dir), str(src), str(tmp_path / "sr_pth"), "cpu", **kw) == 1
        os.replace(ckpt_dir, model_dir / "checkpoints")
        assert tmain(str(model_dir), str(src), str(tmp_path / "sr"), "cpu", **kw) == 1
    got = np.asarray(Image.open(tmp_path / "sr" / "a.png"))
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "sr_pth" / "a.png")))


def test_cli_train_debug_live_writes_a_checkpoint(tmp_path, monkeypatch):
    """--no-cached --debug on LR/HR PNGs with tiny experts: the head trains, the experts
    from model_dir do not change, latest.ckpt holds the head."""
    _synthetic_data(tmp_path / "data", n=2, lr_hw=(20, 20))
    model_dir, _ = _tiny_model_dir(tmp_path, 61)
    cfg = _debug_cfg(tmp_path, root=str(tmp_path / "data"), cached=False, lr_patch=16)
    cfg["model"]["expert_kwargs"] = EXPERTS
    cfg["model_dir"] = str(model_dir)
    ttrain.train(cfg, "cpu")
    record = torch.load(tmp_path / "ckpt" / "latest.ckpt", weights_only=True)
    assert record["epoch"] == 1 and record["step"] == 2
    assert set(record["model"]) == set(
        tfusion.FusionHead(tfusion.FusionConfig(**TINY)).state_dict())


def test_cli_train_refuses_a_missing_card_and_several_devices(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ttrain.main(["--debug", "--data_root", str(tmp_path)])
    from freqfusion_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        make_mesh(2, "cpu")
