"""Port parity: the window helpers DAT and HAT need in freqfusion_tpu_torch/ops/windows.py
against freqfusion_tpu/ops/windows.py on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from freqfusion_tpu.ops import windows as JW
from freqfusion_tpu_torch.ops import windows as TW

torch.set_num_threads(2)

WINDOWS = [(2, 4), (4, 2), (8, 8), (8, 32)]


@pytest.mark.parametrize("hs,ws", WINDOWS)
def test_window_partition_and_reverse_match_jax(hs, ws):
    x = np.random.default_rng(hs * ws).standard_normal((2, 2 * hs, 3 * ws, 5)).astype(np.float32)
    want = np.asarray(JW.window_partition(jnp.asarray(x), hs, ws))
    got = TW.window_partition(torch.from_numpy(x), hs, ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = TW.window_reverse(got, hs, ws, 2 * hs, 3 * ws)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JW.window_reverse(jnp.asarray(want), hs, ws, 2 * hs, 3 * ws)))


@pytest.mark.parametrize("hs,ws", WINDOWS)
def test_relative_tables_match_jax(hs, ws):
    np.testing.assert_array_equal(TW.relative_coords_table(hs, ws),
                                  JW.relative_coords_table(hs, ws))
    np.testing.assert_array_equal(TW.relative_position_index(hs, ws),
                                  JW.relative_position_index(hs, ws))
    assert not TW.relative_coords_table(hs, ws).flags.writeable


@pytest.mark.parametrize("hs,ws", WINDOWS)
def test_swin_bias_gather_equals_the_toeplitz_einsum(hs, ws):
    table = np.random.default_rng(7).standard_normal(
        ((2 * hs - 1) * (2 * ws - 1), 3)).astype(np.float32)
    want = np.asarray(JW.swin_bias_from_table(jnp.asarray(table), hs, ws))
    got = TW.swin_bias_from_table(torch.from_numpy(table), hs, ws)
    assert got.shape == (3, hs * ws, hs * ws) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    idx = torch.from_numpy(TW.relative_position_index(hs, ws).copy())
    np.testing.assert_array_equal(
        TW.swin_bias_from_table(torch.from_numpy(table), hs, ws, idx).numpy(), got.numpy())


@pytest.mark.parametrize("h,w,hs,ws", [(8, 8, 2, 4), (8, 8, 4, 2), (16, 24, 8, 8),
                                       (32, 64, 8, 32), (64, 32, 32, 8)])
def test_shift_attn_mask_matches_jax(h, w, hs, ws):
    want = JW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
    got = TW.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2)
    assert got.dtype == np.float32 and not got.flags.writeable
    np.testing.assert_array_equal(got, want)


OCA_WINDOWS = [(4, 6), (8, 12), (16, 24), (6, 8)]   # (window, extended window)


@pytest.mark.parametrize("ws,wse", OCA_WINDOWS)
def test_oca_relative_position_index_matches_jax(ws, wse):
    """The JAX index may be negative (it wraps around the table's end, as the reference's
    does); the port's is the same entry, already modulo the table's length."""
    want = JW.oca_relative_position_index(ws, wse).astype(np.int64)
    got = TW.oca_relative_position_index(ws, wse)
    d = ws + wse - 1
    assert got.shape == (ws * ws, wse * wse) and got.dtype == np.int64
    assert not got.flags.writeable and got.min() >= 0 and got.max() < d * d
    np.testing.assert_array_equal(got, want % (d * d))


@pytest.mark.parametrize("ws,wse", OCA_WINDOWS)
def test_oca_bias_gather_equals_the_roll_and_slice_build(ws, wse):
    table = np.random.default_rng(ws).standard_normal(((ws + wse - 1) ** 2, 3)).astype(np.float32)
    want = np.asarray(JW.oca_bias_from_table(jnp.asarray(table), ws, wse))
    got = TW.oca_bias_from_table(torch.from_numpy(table), ws, wse)
    assert got.shape == (3, ws * ws, wse * wse) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    idx = torch.from_numpy(TW.oca_relative_position_index(ws, wse).copy())
    np.testing.assert_array_equal(
        TW.oca_bias_from_table(torch.from_numpy(table), ws, wse, idx).numpy(), got.numpy())


@pytest.mark.parametrize("win,overlap,h,w", [(4, 2, 8, 12), (8, 4, 16, 8), (16, 8, 32, 48),
                                             (4, 4, 4, 8)])
def test_extract_overlapping_windows_matches_jax(win, overlap, h, w):
    x = np.random.default_rng(win + h).standard_normal((2, h, w, 5)).astype(np.float32)
    want = np.asarray(JW.extract_overlapping_windows(jnp.asarray(x), win, overlap))
    got = TW.extract_overlapping_windows(torch.from_numpy(x), win, overlap)
    assert got.shape == (2 * (h // win) * (w // win), (win + overlap) ** 2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
