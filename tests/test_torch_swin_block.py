"""K1's plain PyTorch version against the JAX fused Swin block.

The JAX kernel runs in Pallas interpret mode on the CPU, without head
packing, as tests/test_fused_block.py runs it. Shapes are small: Bw=8
windows of N=64 tokens, C=16, 2 heads, MLP hidden 32. In fp32 the two agree
to float32 summation order; in bf16 the frameworks round at different places
inside the matmuls and convs, so the bound is the bf16 one of the JAX tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels.swin_block import fused_swin_block as jax_fused_swin_block
from superresolution_def_tpu_torch.kernels import fused_swin_block, swin_block_reference

BW, N, C, HEADS, HIDDEN = 8, 64, 16, 2, 32
SCALE = (C // HEADS) ** -0.5


def _operands(seed):
    """Block operands as numpy: x, then the 13 parameters in kernel order."""
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in):
        return rng.uniform(-1, 1, shape).astype(np.float32) / np.sqrt(fan_in)

    return [
        rng.standard_normal((BW, N, C)).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        (0.1 * rng.standard_normal(C)).astype(np.float32),
        u(C, 3 * C, fan_in=C), u(3 * C, fan_in=C),
        (0.5 * rng.standard_normal((HEADS, N, N))).astype(np.float32),
        u(C, C, fan_in=C), u(C, fan_in=C),
        (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        (0.1 * rng.standard_normal(C)).astype(np.float32),
        u(C, HIDDEN, fan_in=C), u(HIDDEN, fan_in=C),
        u(HIDDEN, C, fan_in=HIDDEN), u(C, fan_in=HIDDEN),
    ]


# x and the four weight matrices take the io dtype; LN params, biases and the
# relative-position bias stay fp32, as make_fused_swinir passes them
_IO = {0, 3, 6, 10, 12}


def _run_both(dtype_np, dtype_torch, seed):
    ops = _operands(seed)
    jax_args = [jnp.asarray(a, dtype_np) if i in _IO else jnp.asarray(a) for i, a in enumerate(ops)]
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_swin_block(
            *jax_args, num_heads=HEADS, scale=SCALE, block_windows=4, packed=False
        )
    want = np.asarray(want.astype(jnp.float32))
    t_args = [torch.from_numpy(a).to(dtype_torch) if i in _IO else torch.from_numpy(a)
              for i, a in enumerate(ops)]
    got = swin_block_reference(*t_args, num_heads=HEADS, scale=SCALE)
    assert got.dtype == dtype_torch and got.shape == (BW, N, C)
    return got.float().numpy(), want


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_kernel_fp32(seed):
    got, want = _run_both(jnp.float32, torch.float32, seed)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_reference_matches_jax_kernel_bf16():
    got, want = _run_both(jnp.bfloat16, torch.bfloat16, 2)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_wrapper_on_cpu_is_the_plain_version(dtype):
    args = [torch.from_numpy(a).to(dtype) if i in _IO else torch.from_numpy(a)
            for i, a in enumerate(_operands(3))]
    before = fused_swin_block.launches
    got = fused_swin_block(*args, num_heads=HEADS, scale=SCALE)
    want = swin_block_reference(*args, num_heads=HEADS, scale=SCALE)
    assert torch.equal(got, want)
    assert fused_swin_block.launches == before == 0


def test_wrapper_rejects_devices_it_has_no_path_for():
    args = [torch.from_numpy(a) for a in _operands(4)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_swin_block(args[0].to("meta"), *args[1:], num_heads=HEADS, scale=SCALE)
