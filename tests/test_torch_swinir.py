"""The port's SwinIR against the flax SwinIR on the same bridged weights.

Tiny config (embed 16, one stage of 2 blocks, 2 heads, window 8, mlp_ratio
2, x4) in fp32: the two frameworks agree to float32 summation order, bounded
as the JAX fused-block tests bound it (atol 3e-5, rtol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.models import SwinIR as FlaxSwinIR
from superresolution_def_tpu.models.torch_port import swinir_from_torch
from superresolution_def_tpu_torch.kernels import fused_swin_block, make_fused_swinir
from superresolution_def_tpu_torch.models import SwinIR, swinir_state_dict_from_jax

TINY = dict(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
            window_size=8, mlp_ratio=2.0, upscale=4)


@pytest.fixture(scope="module")
def flax_model_and_params():
    model = FlaxSwinIR(**TINY)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def port_model(flax_model_and_params):
    _, params = flax_model_and_params
    model = SwinIR(**TINY).eval()
    model.load_state_dict(swinir_state_dict_from_jax(params), strict=True)
    return model


def test_bridge_round_trips_through_swinir_from_torch(flax_model_and_params):
    _, params = flax_model_and_params
    sd = {k: v.numpy() for k, v in swinir_state_dict_from_jax(params).items()}
    back = swinir_from_torch(sd, TINY["depths"])
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a, err_msg=jax.tree_util.keystr(path))


def test_port_state_dict_uses_reference_torch_keys(port_model):
    keys = set(port_model.state_dict())
    assert {"conv_first.weight", "layers.0.1.attn.relative_position_bias_table",
            "layers.0.0.mlp.fc2.bias", "norm.weight", "conv_before_upsample.0.weight",
            "upsample.0.weight", "upsample.2.weight", "conv_last.bias"} <= keys
    assert not any(k.startswith("upsample.1") or k.startswith("upsample.3") for k in keys)


@pytest.mark.parametrize("size", [16, 20])  # 20 exercises reflect-pad and crop
def test_port_matches_flax_forward(flax_model_and_params, port_model, size):
    model, params = flax_model_and_params
    x = np.random.default_rng(size).random((2, size, size, 1), dtype=np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * size, 4 * size, 1)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_fused_forward_fp32_on_cpu_matches_flax(flax_model_and_params, port_model):
    model, params = flax_model_and_params
    x = np.random.default_rng(3).random((2, 16, 16, 1), dtype=np.float32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    got = make_fused_swinir(port_model, dtype=torch.float32)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    assert fused_swin_block.launches == 0  # CPU tensors never launch the kernel


def test_fused_forward_rejects_non_window_multiples(port_model):
    with pytest.raises(ValueError, match="multiples of 8"):
        make_fused_swinir(port_model)(torch.zeros(1, 20, 16, 1))


def test_seeded_init_is_reproducible_and_seed_dependent():
    sd0 = SwinIR(**TINY, generator=torch.Generator().manual_seed(7)).state_dict()
    sd1 = SwinIR(**TINY, generator=torch.Generator().manual_seed(7)).state_dict()
    sd2 = SwinIR(**TINY, generator=torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert not torch.equal(sd0["conv_first.weight"], sd2["conv_first.weight"])
    table = sd0["layers.0.0.attn.relative_position_bias_table"]
    assert table.abs().max() <= 0.04 and 0.005 < table.std() < 0.03
