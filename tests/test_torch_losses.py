"""Port parity of the training losses: each loss of ``freqfusion_tpu_torch.losses`` and its
gradient with respect to the prediction against the JAX package's on the same numpy inputs
(CPU, f32), the wavelet filters against the JAX ones, and ``CombinedLoss`` at each of the
shipped recipe's three stages and through the VGG/CLIP redirect. Bounds: values within 2e-4
relative, gradients within 2e-4 x max|g|; the FFT loss within 3e-3 (its phase terms are
ill-conditioned near zero bins: PARITY.md)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from freqfusion_tpu import losses as JL
from freqfusion_tpu_torch import losses as TL

torch.set_num_threads(2)


def _pair(seed=0, shape=(2, 32, 40, 3)):
    rng = np.random.default_rng(seed)
    target = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return pred, target


def _value_and_grad_jax(fn, pred, target):
    v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(target)))(jnp.asarray(pred))
    return float(v), np.asarray(g)


def _value_and_grad_torch(fn, pred, target):
    p = torch.from_numpy(pred).requires_grad_(True)
    v = fn(p, torch.from_numpy(target))
    v.backward()
    return float(v), p.grad.numpy()


LOSSES = {
    "l1": (JL.l1_loss, TL.l1_loss, 2e-4),
    "l2": (JL.l2_loss, TL.l2_loss, 2e-4),
    "charbonnier": (JL.charbonnier_loss, TL.charbonnier_loss, 2e-4),
    "ssim": (JL.ssim_loss, TL.ssim_loss, 2e-4),
    "fft": (JL.fft_loss, TL.fft_loss, 3e-3),
    "swt": (JL.swt_loss, TL.swt_loss, 2e-4),
    "swt_haar_3": (lambda p, t: JL.swt_loss(p, t, "haar", 3),
                   lambda p, t: TL.swt_loss(p, t, "haar", 3), 2e-4),
    "edge": (JL.edge_loss, TL.edge_loss, 2e-4),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    jfn, tfn, tol = LOSSES[name]
    pred, target = _pair(len(name))
    jv, jg = _value_and_grad_jax(jfn, pred, target)
    tv, tg = _value_and_grad_torch(tfn, pred, target)
    assert abs(tv - jv) <= tol * abs(jv)
    assert np.abs(tg - jg).max() <= tol * np.abs(jg).max()


def _families():
    names = ["haar", "db4", "db1", "db2", "db7", "db12", "db20", "sym2", "sym4", "sym10",
             "sym11", "sym14", "coif1", "coif5", "bior1.1", "bior2.2", "bior3.9", "bior4.4",
             "rbio2.4", "rbio3.1"]
    return names


@pytest.mark.parametrize("name", _families())
def test_wavelet_filters_match_jax(name):
    for a, b in zip(JL.wavelet_filters(name), TL.wavelet_filters(name)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=1e-12)


def test_wavelet_filters_refuse_what_jax_refuses():
    for name in ("bior5.5", "db21", "morl"):
        with pytest.raises(ValueError):
            JL.wavelet_filters(name)
        with pytest.raises(ValueError):
            TL.wavelet_filters(name)


def _stages():
    with open("configs/train_config.yaml") as f:
        return yaml.safe_load(f)["loss"]["stages"]


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_combined_loss_at_each_stage_matches_jax(stage):
    weights = _stages()[stage]["weights"]
    pred, target = _pair(10 + stage)
    jc, tc = JL.CombinedLoss(weights), TL.CombinedLoss(weights)
    assert jc.weights == tc.weights

    def jtotal(p, t):
        return jc(p, t)[0]

    def ttotal(p, t):
        return tc(p, t)[0]

    jv, jg = _value_and_grad_jax(jtotal, pred, target)
    tv, tg = _value_and_grad_torch(ttotal, pred, target)
    # stage 2 and 3 carry the FFT loss: its bound
    tol = 2e-4 if weights.get("fft", 0) == 0 else 3e-3
    assert abs(tv - jv) <= tol * abs(jv)
    assert np.abs(tg - jg).max() <= tol * np.abs(jg).max()
    _, jcomp = jc(jnp.asarray(pred), jnp.asarray(target))
    _, tcomp = tc(torch.from_numpy(pred), torch.from_numpy(target))
    assert sorted(jcomp) == sorted(tcomp)


def test_perceptual_weights_move_to_fft_as_in_jax(monkeypatch):
    monkeypatch.delenv("FREQFUSION_VGG19_WEIGHTS", raising=False)
    monkeypatch.delenv("FREQFUSION_CLIP_WEIGHTS", raising=False)
    weights = {"l1": 0.5, "vgg": 0.2, "clip": 0.1, "fft": 0.05}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc, tc = JL.CombinedLoss(weights), TL.CombinedLoss(weights)
    assert jc.weights == tc.weights
    assert tc.weights["vgg"] == tc.weights["clip"] == 0.0
    assert abs(tc.weights["fft"] - 0.35) < 1e-12
    pred, target = _pair(3)
    jv = float(jc(jnp.asarray(pred), jnp.asarray(target))[0])
    tv = float(tc(torch.from_numpy(pred), torch.from_numpy(target))[0])
    assert abs(tv - jv) <= 3e-3 * abs(jv)
    with pytest.raises(KeyError):
        tc.set_weights({"perceptual": 1.0})


def test_a_named_vgg_checkpoint_is_refused_not_replaced(monkeypatch, tmp_path):
    """Where the variable names a VGG19 checkpoint, the port loads it and computes the JAX
    package's perceptual loss (test_torch_perceptual_losses.py holds the values); where the
    named file does not exist, the weight moves to FFT, as in the JAX package."""
    from freqfusion_tpu_torch.losses.vgg import VGG19Features

    monkeypatch.setenv("FREQFUSION_VGG19_WEIGHTS", str(tmp_path / "vgg19.pth"))
    with pytest.warns(UserWarning, match="redirecting"):
        tc = TL.CombinedLoss({"vgg": 0.1})
    with pytest.warns(UserWarning, match="redirecting"):
        assert tc.weights == JL.CombinedLoss({"vgg": 0.1}).weights
    torch.save(VGG19Features().state_dict(), str(tmp_path / "vgg19.pth"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tc = TL.CombinedLoss({"vgg": 0.1})
    assert tc.weights["vgg"] == 0.1
    pred, target = _pair(3)
    _, comp = tc(torch.from_numpy(pred[:, :32, :32]), torch.from_numpy(target[:, :32, :32]))
    assert "vgg" in comp and torch.isfinite(comp["vgg"])
    TL.CombinedLoss({"vgg": 0.0, "l1": 1.0})   # a zero weight needs no backbone
