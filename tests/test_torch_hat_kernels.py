"""K5, K6 and K7's plain PyTorch versions against the JAX TPU kernels.

The JAX kernels run in Pallas interpret mode on the CPU, without head
packing, as tests/test_fused_hat.py and tests/test_fused_rdb_cm.py run them:
``fused_hab_block`` (K5) shifted and unshifted, ``fused_ocab_block`` (K6)
and ``fused_rdb_cm`` (K7). Widths are small, with an odd head_dim (embed 30,
6 heads: head_dim 5) and a dense-block height (20) that is not a multiple of
the JAX kernel's row tile. fp32: the two agree to float32 summation order
(atol 5e-5, rtol 2e-4, the bound of tests/test_fused_hat.py); bf16: the
frameworks round at different places inside the products and convs (atol
3e-2, rtol 5e-2, the bound of tests/test_torch_swin_block.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels.fused_rdb_cm import fused_rdb_cm as jax_fused_rdb_cm
from superresolution_def_tpu.kernels.ocab import fused_ocab_block as jax_fused_ocab_block
from superresolution_def_tpu.kernels.swin_block import fused_hab_block as jax_fused_hab_block
from superresolution_def_tpu_torch.kernels import (
    fused_hab_block,
    fused_ocab_block,
    fused_rdb_cm,
    hab_block_reference,
    ocab_block_reference,
    rdb_cm_reference,
)
from superresolution_def_tpu_torch.ops import shift_window_attn_mask

torch.set_num_threads(1)

C, HEADS, HIDDEN = 30, 6, 60
NW = 4          # windows of one 16x16 image
BW = 2 * NW     # two images
SCALE = (C // HEADS) ** -0.5
TOL = {torch.float32: dict(atol=5e-5, rtol=2e-4), torch.bfloat16: dict(atol=3e-2, rtol=5e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _u(rng, *shape, fan_in):
    return (rng.uniform(-1, 1, shape) / np.sqrt(fan_in)).astype(np.float32)


def _tail(rng):
    """proj, LN2 and MLP operands; the matrices take the io dtype."""
    return [
        _u(rng, C, C, fan_in=C), _u(rng, C, fan_in=C),
        (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        (0.1 * rng.standard_normal(C)).astype(np.float32),
        _u(rng, C, HIDDEN, fan_in=C), _u(rng, HIDDEN, fan_in=C),
        _u(rng, HIDDEN, C, fan_in=HIDDEN), _u(rng, C, fan_in=HIDDEN),
    ]


def _to_both(ops, io, dtype):
    """numpy operands -> (jax, torch); indices in ``io`` take the io dtype."""
    j = [jnp.asarray(a, JNP[dtype]) if i in io else jnp.asarray(a) for i, a in enumerate(ops)]
    t = [torch.from_numpy(a).to(dtype) if i in io else torch.from_numpy(a)
         for i, a in enumerate(ops)]
    return j, t


def _hab_operands(seed):
    """x, conv_x, then the 13 HAB parameters in kernel order."""
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((BW, 64, C)).astype(np.float32),
        rng.standard_normal((BW, 64, C)).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        (0.1 * rng.standard_normal(C)).astype(np.float32),
        _u(rng, C, 3 * C, fan_in=C), _u(rng, 3 * C, fan_in=C),
        (0.5 * rng.standard_normal((HEADS, 64, 64))).astype(np.float32),
    ] + _tail(rng)


_HAB_IO = {0, 1, 4, 7, 11, 13}


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hab_reference_matches_jax_kernel(dtype, shifted):
    ops = _hab_operands(int(shifted) + 2 * (dtype == torch.bfloat16))
    j, t = _to_both(ops, _HAB_IO, dtype)
    mask = shift_window_attn_mask(16, 16, 8, 4) if shifted else np.zeros((NW, 64, 64), np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_hab_block(j[0], j[1], jnp.tile(jnp.asarray(mask), (BW // NW, 1, 1)),
                                   *j[2:], num_heads=HEADS, scale=SCALE, conv_scale=0.01,
                                   block_windows=4, packed=False)
    got = hab_block_reference(t[0], t[1], torch.from_numpy(mask) if shifted else None, *t[2:],
                              num_heads=HEADS, scale=SCALE, conv_scale=0.01)
    assert got.dtype == dtype and got.shape == (BW, 64, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _ocab_operands(seed):
    """x, q, k, v, the OCA bias, then proj/LN2/MLP."""
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((BW, 64, C)).astype(np.float32),
        rng.standard_normal((BW, 64, C)).astype(np.float32),
        rng.standard_normal((BW, 144, C)).astype(np.float32),
        rng.standard_normal((BW, 144, C)).astype(np.float32),
        (0.5 * rng.standard_normal((HEADS, 64, 144))).astype(np.float32),
    ] + _tail(rng)


_OCAB_IO = {0, 1, 2, 3, 5, 9, 11}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ocab_reference_matches_jax_kernel(dtype):
    ops = _ocab_operands(10 + (dtype == torch.bfloat16))
    # keys of the overlap that fall outside the image are zero vectors that
    # stay in the softmax: zero some, as the gather's padding does
    ops[2][:, :14] = 0.0
    ops[3][:, :14] = 0.0
    j, t = _to_both(ops, _OCAB_IO, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused_ocab_block(*j, num_heads=HEADS, scale=SCALE, block_windows=4,
                                    packed=False)
    got = ocab_block_reference(*t, num_heads=HEADS, scale=SCALE)
    assert got.dtype == dtype and got.shape == (BW, 64, C)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _rdb_operands(seed, f, g, h, w):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((1, f, h * w))).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
           * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32) for i in range(5)]
    bs = [(0.05 * rng.standard_normal(g if i < 4 else f)).astype(np.float32) for i in range(5)]
    return x, ks, bs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rdb_reference_matches_jax_kernel(dtype):
    f, g, h, w = 16, 8, 20, 128
    x, ks, bs = _rdb_operands(20 + (dtype == torch.bfloat16), f, g, h, w)
    want = jax_fused_rdb_cm(jnp.asarray(x, JNP[dtype]), [jnp.asarray(k) for k in ks],
                            [jnp.asarray(b) for b in bs], h=h, w=w, tile_h=8, interpret=True)
    got = rdb_cm_reference(torch.from_numpy(x).to(dtype), [torch.from_numpy(k) for k in ks],
                           [torch.from_numpy(b) for b in bs], h=h, w=w)
    assert got.dtype == dtype and got.shape == (1, f, h * w)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_wrappers_on_cpu_are_the_plain_versions():
    t = [torch.from_numpy(a) for a in _hab_operands(30)]
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4))
    kw = dict(num_heads=HEADS, scale=SCALE)
    o = [torch.from_numpy(a) for a in _ocab_operands(31)]
    x, ks, bs = _rdb_operands(32, 16, 8, 16, 16)
    x, ks, bs = torch.from_numpy(x), [torch.from_numpy(k) for k in ks], [
        torch.from_numpy(b) for b in bs]
    assert torch.equal(fused_hab_block(t[0], t[1], mask, *t[2:], **kw),
                       hab_block_reference(t[0], t[1], mask, *t[2:], **kw))
    assert torch.equal(fused_ocab_block(*o, **kw), ocab_block_reference(*o, **kw))
    assert torch.equal(fused_rdb_cm(x, ks, bs, h=16, w=16),
                       rdb_cm_reference(x, ks, bs, h=16, w=16))
    assert fused_hab_block.launches == fused_ocab_block.launches == fused_rdb_cm.launches == 0


def test_wrappers_reject_devices_they_have_no_path_for():
    t = [torch.from_numpy(a) for a in _hab_operands(33)]
    o = [torch.from_numpy(a) for a in _ocab_operands(34)]
    x, ks, bs = _rdb_operands(35, 16, 8, 8, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_hab_block(t[0].to("meta"), t[1], None, *t[2:], num_heads=HEADS, scale=SCALE)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ocab_block(o[0].to("meta"), *o[1:], num_heads=HEADS, scale=SCALE)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_rdb_cm(torch.from_numpy(x).to("meta"), ks, bs, h=8, w=8)
