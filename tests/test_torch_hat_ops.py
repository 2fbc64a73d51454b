"""The HAT geometry ops of the port against the JAX package's ops, exact.

The overlapping cross-attention index (with the reference's negative
wraparound made explicit), the shifted-window mask, the overlapping-window
gather and the nearest x2 resize are integer maps or data movement, so both
frameworks must give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.models.hat import _overlap_windows as jax_overlap_windows
from superresolution_def_tpu.ops import windows as jax_windows
from superresolution_def_tpu.ops.resize import resize_nearest as jax_resize_nearest
from superresolution_def_tpu_torch.ops import (
    overlap_windows,
    relative_position_bias_oca,
    relative_position_index_oca,
    resize_nearest,
    shift_window_attn_mask,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("ws,ratio", [(8, 0.5), (4, 0.5), (8, 0.25), (6, 0.5)])
def test_oca_index_matches_jax(ws, ratio):
    got = relative_position_index_oca(ws, ratio)
    want = jax_windows.relative_position_index_oca(ws, ratio)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    wse = ws + int(ratio * ws)
    assert got.min() >= 0 and got.max() < (ws + wse - 1) ** 2


def test_oca_bias_gathers_the_table():
    table = torch.from_numpy(np.random.default_rng(0).standard_normal((19 * 19, 6)))
    bias = relative_position_bias_oca(table, 8, 0.5)
    idx = jax_windows.relative_position_index_oca(8, 0.5)
    assert bias.shape == (6, 64, 144)
    np.testing.assert_array_equal(bias.numpy(), table.numpy()[idx.reshape(-1)].reshape(
        64, 144, 6).transpose(2, 0, 1))


@pytest.mark.parametrize("h,w,ws,ss", [(16, 16, 8, 4), (32, 24, 8, 4), (16, 32, 4, 2)])
def test_shift_mask_matches_jax(h, w, ws, ss):
    got = shift_window_attn_mask(h, w, ws, ss)
    want = jax_windows.shift_window_attn_mask(h, w, ws, ss)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, -100.0}


@pytest.mark.parametrize("h,w,c", [(16, 16, 5), (16, 32, 60)])
def test_overlap_windows_match_jax(h, w, c):
    kv = np.random.default_rng(h + w).standard_normal((2, h, w, c)).astype(np.float32)
    got = overlap_windows(torch.from_numpy(kv), 8, 12).numpy()
    want = np.asarray(jax_overlap_windows(jnp.asarray(kv), 8, 12))
    assert got.shape == want.shape == (2 * (h // 8) * (w // 8), 144, c)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("scale", [2, 3])
def test_resize_nearest_matches_jax_and_torch(scale):
    x = np.random.default_rng(scale).standard_normal((2, 5, 7, 3)).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), scale)
    assert np.array_equal(got.numpy(), np.asarray(jax_resize_nearest(jnp.asarray(x), scale)))
    ref = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                          scale_factor=scale, mode="nearest")
    assert torch.equal(got, ref.permute(0, 2, 3, 1))
