"""The port's ops against the JAX package's on the same numpy inputs.

Index tables and data movement must match exactly; the metrics to 1e-6
(float32 sums taken in another order by XLA and by PyTorch).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from superresolution_def_tpu.ops import metrics as jmetrics
from superresolution_def_tpu.ops import padding as jpadding
from superresolution_def_tpu.ops import pixelshuffle as jpixelshuffle
from superresolution_def_tpu.ops import windows as jwindows
from superresolution_def_tpu_torch.ops import (
    TrainMetrics,
    pixel_shuffle,
    psnr,
    reflect_pad_2d,
    relative_position_bias,
    relative_position_index_sa,
    ssim,
    window_partition,
    window_reverse,
)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("ws", [4, 7, 8])
def test_relative_position_index_matches_jax(ws):
    np.testing.assert_array_equal(
        relative_position_index_sa(ws), jwindows.relative_position_index_sa(ws)
    )


def test_relative_position_bias_gathers_like_jax():
    ws, heads = 8, 3
    table = _rand(((2 * ws - 1) ** 2, heads), 0)
    rpi = jwindows.relative_position_index_sa(ws)
    want = table[rpi.reshape(-1)].reshape(ws * ws, ws * ws, heads).transpose(2, 0, 1)
    np.testing.assert_array_equal(relative_position_bias(torch.from_numpy(table), ws).numpy(), want)


@pytest.mark.parametrize("shape,ws", [((2, 16, 24, 5), 8), ((1, 14, 7, 3), 7)])
def test_window_partition_and_reverse_match_jax(shape, ws):
    x = _rand(shape, 1)
    got = window_partition(torch.from_numpy(x), ws)
    want = np.asarray(jwindows.window_partition(jnp.asarray(x), ws))
    np.testing.assert_array_equal(got.numpy(), want)
    back = window_reverse(got, ws, shape[1], shape[2])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwindows.window_reverse(jnp.asarray(want), ws, shape[1], shape[2]))
    )
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(r):
    x = _rand((2, 5, 6, 4 * r * r), 2)
    got = pixel_shuffle(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpixelshuffle.pixel_shuffle(jnp.asarray(x), r)))


def test_pixel_shuffle_is_torch_pixel_shuffle_in_nhwc():
    x = _rand((1, 3, 4, 8), 3)
    want = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(pixel_shuffle(torch.from_numpy(x), 2).numpy(), want.numpy())


@pytest.mark.parametrize("pad_h,pad_w", [(0, 0), (4, 0), (0, 3), (4, 5)])
def test_reflect_pad_matches_jax(pad_h, pad_w):
    x = _rand((2, 12, 9, 1), 4)
    got = reflect_pad_2d(torch.from_numpy(x), pad_h, pad_w).numpy()
    want = np.asarray(jpadding.reflect_pad_2d(jnp.asarray(x), pad_h, pad_w))
    np.testing.assert_array_equal(got, want)


def _pair(seed, shape=(3, 32, 40, 1)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), -0.1, 1.1).astype(np.float32)
    return a, b


def test_psnr_matches_jax():
    a, b = _pair(5)
    got = psnr(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 32, 40, 1), (1, 64, 64, 2)])
def test_ssim_matches_jax(shape):
    a, b = _pair(6, shape)
    got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-6


def test_train_metrics_accumulate_like_jax():
    ours, ref = TrainMetrics(), jmetrics.TrainMetrics()
    for seed, shape in [(7, (2, 32, 32, 1)), (8, (3, 32, 32, 1))]:
        a, b = _pair(seed, shape)
        ours.update(torch.from_numpy(a), torch.from_numpy(b))
        ref.update(jnp.asarray(a), jnp.asarray(b))
    got, want = ours.compute(), ref.compute()
    assert ours.count == ref.count == 5
    assert abs(got["psnr"] - want["psnr"]) <= 1e-6 * abs(want["psnr"]) + 1e-6
    assert abs(got["ssim"] - want["ssim"]) <= 1e-6
