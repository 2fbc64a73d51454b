"""The port's HAT and hybrid against the JAX package.

- The ``nn.Module`` forwards (HAT, HybridHATRealESRGAN) against the flax
  models in fp32, on weights bridged by ``hat_state_dict_from_jax`` /
  ``hybrid_state_dict_from_jax``; the bridge round-trips through the JAX
  ``hybrid_from_torch`` to the same tree, and ``detect_hybrid_params``
  agrees with the JAX one.
- The port's ``make_fused_hybrid`` on the CPU (each kernel wrapper runs its
  plain version) against the JAX ``make_fused_hybrid`` in Pallas interpret
  mode: fp32 at input widths 16 and 64, and bf16 at width 64, where the
  JAX trunk (width 128) runs its dense-block kernel rather than its XLA
  fallback.

Bounds: fp32 atol 5e-5 / rtol 2e-4 (the bound of tests/test_fused_hat.py).
bf16: the frameworks round at different places through 2 HABs, an OCAB, a
trunk of 3 dense blocks and 8 convs, so the bound is relative: L2 distance
<= 2e-2 of the output's norm and max |diff| <= 3e-2 (the bf16 atol of the
kernel tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels.fused_hat import make_fused_hybrid as jax_make_fused_hybrid
from superresolution_def_tpu.models import HybridHATRealESRGAN as FlaxHybrid
from superresolution_def_tpu.models.hat import HAT as FlaxHAT
from superresolution_def_tpu.models.torch_port import (
    detect_hybrid_params as jax_detect_hybrid_params,
    hybrid_from_torch,
)
from superresolution_def_tpu_torch.kernels import (
    fused_hab_block,
    fused_ocab_block,
    fused_rdb_cm,
    make_fused_hybrid,
)
from superresolution_def_tpu_torch.models import (
    HAT,
    HybridHATRealESRGAN,
    detect_hybrid_params,
    hat_state_dict_from_jax,
    hybrid_state_dict_from_jax,
)

torch.set_num_threads(1)

TINY = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8,
            num_rrdb=1, num_feat=16, num_grow_ch=8)
FP32 = dict(atol=5e-5, rtol=2e-4)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def hybrid():
    """(flax params, the port's model on the bridged weights)."""
    x = jnp.zeros((1, 16, 16, 1))
    params = _np_tree(FlaxHybrid(**TINY, upscale=4).init(jax.random.PRNGKey(0), x)["params"])
    model = HybridHATRealESRGAN(**TINY).eval()
    model.load_state_dict(hybrid_state_dict_from_jax(params), strict=True)
    return params, model


@pytest.mark.parametrize("in_chans", [1, 3])
def test_hat_module_matches_flax_fp32(in_chans):
    cfg = dict(img_size=16, in_chans=in_chans, embed_dim=30, depths=(2,), num_heads=(6,),
               window_size=8, upscale=2)
    x = np.random.default_rng(in_chans).random((2, 16, 24, in_chans), np.float32)
    flax_hat = FlaxHAT(**cfg, upsampler="pixelshuffle", img_range=1.0)
    params = _np_tree(flax_hat.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(flax_hat.apply({"params": params}, jnp.asarray(x), True))
    model = HAT(**cfg).eval()
    model.load_state_dict(hat_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 48, in_chans)
    np.testing.assert_allclose(got, want, **FP32)


def test_hybrid_module_matches_flax_fp32(hybrid):
    params, model = hybrid
    x = np.random.default_rng(0).random((2, 16, 16, 1), np.float32)
    want = np.asarray(FlaxHybrid(**TINY, upscale=4).apply({"params": params}, jnp.asarray(x), True))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, **FP32)


def test_bridge_round_trips_through_hybrid_from_torch(hybrid):
    params, model = hybrid
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = hybrid_from_torch(sd, {"depths": TINY["depths"], "num_rrdb": TINY["num_rrdb"]})
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        assert np.array_equal(flat_back[path], leaf), jax.tree_util.keystr(path)
    assert detect_hybrid_params(model.state_dict()) == jax_detect_hybrid_params(sd)


def test_detect_hybrid_params_defaults_and_sniffing():
    assert detect_hybrid_params({}) == jax_detect_hybrid_params({})
    model = HybridHATRealESRGAN(**{**TINY, "depths": (6, 6), "num_heads": (6, 6),
                                   "num_rrdb": 2, "num_feat": 24, "num_grow_ch": 16})
    det = detect_hybrid_params(model.state_dict())
    assert det == {"embed_dim": 30, "depths": (6, 6), "num_heads": (6, 6), "window_size": 8,
                   "num_rrdb": 2, "num_feat": 24, "num_grow_ch": 16}


def _fused_pair(hybrid, x, dtype):
    params, model = hybrid
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    fn = jax_make_fused_hybrid(depths=TINY["depths"], num_heads=TINY["num_heads"],
                               window_size=8, num_rrdb=TINY["num_rrdb"], dtype=jdt,
                               block_windows=4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(params, jnp.asarray(x)).astype(jnp.float32))
    got = make_fused_hybrid(model, dtype=dtype)(torch.from_numpy(x))
    assert got.dtype == dtype
    return got.float().numpy(), want


@pytest.mark.parametrize("width", [16, 64])
def test_fused_hybrid_matches_jax_fused_fp32(hybrid, width):
    x = np.random.default_rng(width).random((1, 16, width, 1), np.float32)
    got, want = _fused_pair(hybrid, x, torch.float32)
    assert got.shape == want.shape == (1, 64, 4 * width, 1)
    np.testing.assert_allclose(got, want, **FP32)
    assert fused_hab_block.launches == fused_ocab_block.launches == fused_rdb_cm.launches == 0


def test_fused_hybrid_matches_jax_fused_bf16(hybrid):
    x = np.random.default_rng(7).random((1, 16, 64, 1), np.float32)
    got, want = _fused_pair(hybrid, x, torch.bfloat16)
    assert got.shape == want.shape == (1, 64, 256, 1)
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 2e-2, rel
    assert np.abs(got - want).max() <= 3e-2
