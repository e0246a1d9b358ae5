"""Port parity: the window helpers DAT needs in freqfusion_tpu_torch/ops/windows.py against
freqfusion_tpu/ops/windows.py on the same numpy inputs."""

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
