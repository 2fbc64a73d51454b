"""The port's channel-last dense block (K12) against the JAX package.

- ``fused_rdb`` on CPU tensors (its plain version, ``rdb_nhwc_reference``)
  against the JAX ``fused_rdb(..., interpret=True)`` in fp32 at F/G = 16/8,
  on a 16 x 16 image and a 16 x 24 one, max |diff| < 1e-4 (the bound of the
  JAX package's own tests/test_fused_rdb.py), and ``fused_rrdb_trunk``
  against the JAX ``fused_rrdb_trunk`` on one RRDB.
- The tiny hybrid through ``make_fused_hybrid(trunk_impl="kernel")`` against
  the JAX ``make_fused_hybrid(trunk_impl="kernel")`` in Pallas interpret mode,
  fp32 at atol 5e-5 / rtol 2e-4 (tests/test_torch_hat.py's bound), and
  against the port's ``"cm"`` and ``"xla"`` trunks.

Every JAX reference is jitted and finished (``block_until_ready``) before
the first torch call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels.fused_hat import make_fused_hybrid as jax_make_fused_hybrid
from superresolution_def_tpu.kernels.fused_rdb import fused_rdb as jax_fused_rdb
from superresolution_def_tpu.kernels.fused_rdb import fused_rrdb_trunk as jax_fused_rrdb_trunk
from superresolution_def_tpu.models.torch_port import hybrid_from_torch
from superresolution_def_tpu_torch.kernels import (
    fused_rdb,
    fused_rdb_cm,
    fused_rrdb_trunk,
    make_fused_hybrid,
)
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN

torch.set_num_threads(1)

HYBRID = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8,
              num_rrdb=1, num_feat=16, num_grow_ch=8)
FP32 = dict(atol=5e-5, rtol=2e-4)


def _weights(rng, f, g):
    ks = [(rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
           * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32) for i in range(5)]
    bs = [(0.05 * rng.standard_normal(g if i < 4 else f)).astype(np.float32) for i in range(5)]
    return ks, bs


@pytest.mark.parametrize("h,w", [(16, 16), (16, 24)])
def test_rdb_plain_version_matches_jax_fused_rdb(h, w):
    rng = np.random.default_rng(h + w)
    x = (0.5 * rng.standard_normal((1, h, w, 16))).astype(np.float32)
    ks, bs = _weights(rng, 16, 8)
    want = np.asarray(jax_fused_rdb(x, ks, bs, interpret=True).block_until_ready())
    got = fused_rdb(torch.from_numpy(x), [torch.from_numpy(k) for k in ks],
                    [torch.from_numpy(b) for b in bs])
    assert got.shape == (1, h, w, 16) and fused_rdb.launches == 0
    assert np.abs(got.numpy() - want).max() < 1e-4


def test_rrdb_trunk_matches_jax_fused_rrdb_trunk():
    rng = np.random.default_rng(5)
    x = (0.5 * rng.standard_normal((1, 16, 24, 16))).astype(np.float32)
    blocks = [_weights(rng, 16, 8) for _ in range(3)]
    params = {"rrdb_trunk_0": {
        f"rdb{b + 1}": {f"conv{i + 1}": {"conv": {"kernel": ks[i], "bias": bs[i]}}
                        for i in range(5)}
        for b, (ks, bs) in enumerate(blocks)}}
    fn = jax.jit(lambda p, v: jax_fused_rrdb_trunk(p, v, 1, interpret=True))
    want = np.asarray(fn(params, x).block_until_ready())
    rrdbs = [[([torch.from_numpy(k) for k in ks], [torch.from_numpy(b) for b in bs], None)
              for ks, bs in blocks]]
    got = fused_rrdb_trunk(rrdbs, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FP32)


def test_fused_hybrid_kernel_trunk_matches_jax():
    model = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(3)).eval()
    params = hybrid_from_torch({k: v.numpy() for k, v in model.state_dict().items()},
                               {"depths": HYBRID["depths"], "num_rrdb": HYBRID["num_rrdb"]})
    x = np.random.default_rng(6).random((1, 16, 24, 1), np.float32)
    fn = jax_make_fused_hybrid(depths=HYBRID["depths"], num_heads=HYBRID["num_heads"],
                               window_size=8, num_rrdb=HYBRID["num_rrdb"], dtype=jnp.float32,
                               block_windows=4, trunk_impl="kernel")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(params, x).block_until_ready())
    out = {impl: make_fused_hybrid(model, dtype=torch.float32, trunk_impl=impl)(
        torch.from_numpy(x)).numpy() for impl in ("kernel", "cm", "xla")}
    assert out["kernel"].shape == want.shape == (1, 64, 96, 1)
    assert fused_rdb.launches == fused_rdb_cm.launches == 0
    np.testing.assert_allclose(out["kernel"], want, **FP32)
    np.testing.assert_array_equal(out["kernel"], out["cm"])
    np.testing.assert_allclose(out["xla"], out["kernel"], **FP32)
    with pytest.raises(ValueError, match="trunk_impl"):
        make_fused_hybrid(model, trunk_impl="nhwc")
