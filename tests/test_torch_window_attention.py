"""The port's window attention (K11, ``attn_impl="pallas"``) against the JAX package.

- ``window_attention(impl="pallas")`` on CPU tensors (the plain version,
  ``window_attention_reference``) against the JAX ``window_attention(impl=
  "pallas")`` in Pallas interpret mode, as tests/test_kernels.py runs it:
  without a mask, with the 16x16 / window 8 / shift 4 mask, and at OCAB's
  64 x 144; fp32 at the JAX kernel tests' atol 2e-5 / rtol 1e-4, and bf16,
  where the two frameworks' bf16 matmuls round the products' sums at other
  places, at relative L2 <= 1e-2.
- The Pallas path raises under autograd, as the JAX one has no gradient.
- Tiny SwinIR and hybrid ``nn.Module``s with ``attn_impl="pallas"`` against
  the flax modules with it in interpret mode, on the port's seeded weights
  bridged to flax (``swinir_from_torch``, ``hybrid_from_torch``), fp32:
  relative L2 <= 1e-5 (float32 summation order through a few blocks).
  ``attn_impl="xla"`` gives the default module's output bit for bit.

Every JAX reference is jitted and finished (``block_until_ready``) before
the first torch call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import window_attention as jax_window_attention
from superresolution_def_tpu.models import HybridHATRealESRGAN as FlaxHybrid
from superresolution_def_tpu.models import SwinIR as FlaxSwinIR
from superresolution_def_tpu.models.torch_port import hybrid_from_torch, swinir_from_torch
from superresolution_def_tpu.ops import shift_window_attn_mask
from superresolution_def_tpu_torch.kernels import (
    window_attention,
    window_attention_masked,
    window_attention_nomask,
)
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR

torch.set_num_threads(1)

SWIN = dict(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2.0, upscale=4)
HYBRID = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8,
              num_rrdb=1, num_feat=16, num_grow_ch=8)
MODULE_REL_L2 = 1e-5


def _jax_pallas(q, k, v, bias, mask, *, scale, dtype):
    """The JAX Pallas attention of q, k, v cast to ``dtype``, as fp32 numpy."""
    def fn(q, k, v, b, m):
        q, k, v = (t.astype(dtype) for t in (q, k, v))
        out = jax_window_attention(q, k, v, b, m, scale=scale, impl="pallas")
        return out.astype(jnp.float32)

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.jit(fn)(q, k, v, bias, mask).block_until_ready())


def _operands(seed, bw, h, n, m, d, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((bw, h, n, d), (bw, h, m, d), (bw, h, m, d)))
    bias = (0.1 * rng.standard_normal((h, n, m))).astype(np.float32)
    mask = shift_window_attn_mask(16, 16, 8, 4) if masked else None  # (nW=4, 64, 64)
    return q, k, v, bias, mask


# one bf16 case: the shifted-window mask, the most rounding steps
@pytest.mark.parametrize("case,dtype", [("nomask", "float32"), ("mask", "float32"),
                                        ("ocab", "float32"), ("mask", "bfloat16")])
def test_pallas_path_matches_jax_pallas(case, dtype):
    m = 144 if case == "ocab" else 64
    q, k, v, bias, mask = _operands(len(case), 8, 2, 64, m, 32, case == "mask")
    tdt = getattr(torch, dtype)
    scale = 32**-0.5
    want = _jax_pallas(q, k, v, bias, mask, scale=scale, dtype=jnp.dtype(dtype))
    before = (window_attention_nomask.launches, window_attention_masked.launches)
    got = window_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
                           scale=scale, impl="pallas")
    assert got.dtype == tdt and got.shape == (8, 2, 64, 32)
    assert (window_attention_nomask.launches, window_attention_masked.launches) == before
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


def test_pallas_path_raises_under_autograd():
    q, k, v, bias, mask = (torch.from_numpy(a) for a in _operands(0, 4, 2, 64, 64, 8, True))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        window_attention(q, k, v, bias, mask, scale=0.5, impl="pallas")
    with torch.no_grad():
        window_attention(q, k, v, bias, mask, scale=0.5, impl="pallas")
    window_attention(q, k, v, bias, mask, scale=0.5, impl="xla").sum().backward()
    assert q.grad is not None
    with pytest.raises(ValueError, match="impl"):
        window_attention(q, k, v, bias, scale=0.5, impl="cuda")


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_swinir_pallas_module_matches_flax_pallas():
    x = np.random.default_rng(3).random((2, 16, 24, 1), np.float32)
    models = {impl: SwinIR(**SWIN, attn_impl=impl).eval() for impl in ("xla", "pallas")}
    models[None] = SwinIR(**SWIN).eval()
    params = swinir_from_torch(_state(models["pallas"]), SWIN["depths"])
    flax = FlaxSwinIR(**SWIN, attn_impl="pallas")
    fn = jax.jit(lambda p, v: flax.apply({"params": p}, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(params, jnp.asarray(x)).block_until_ready())
    with torch.no_grad():
        out = {impl: model(torch.from_numpy(x)) for impl, model in models.items()}
    assert out["pallas"].shape == (2, 64, 96, 1)
    assert _rel_l2(out["pallas"].numpy(), want) <= MODULE_REL_L2
    assert torch.equal(out["xla"], out[None])


def test_hybrid_pallas_module_matches_flax_pallas():
    x = np.random.default_rng(4).random((1, 16, 24, 1), np.float32)
    models = {impl: HybridHATRealESRGAN(**HYBRID, attn_impl=impl).eval()
              for impl in ("xla", "pallas")}
    models[None] = HybridHATRealESRGAN(**HYBRID).eval()
    params = hybrid_from_torch(_state(models["pallas"]),
                               {"depths": HYBRID["depths"], "num_rrdb": HYBRID["num_rrdb"]})
    flax = FlaxHybrid(**HYBRID, upscale=4, attn_impl="pallas")
    fn = jax.jit(lambda p, v: flax.apply({"params": p}, v, True))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(params, jnp.asarray(x)).block_until_ready())
    with torch.no_grad():
        out = {impl: model(torch.from_numpy(x)) for impl, model in models.items()}
    assert out["pallas"].shape == (1, 64, 96, 1)
    assert _rel_l2(out["pallas"].numpy(), want) <= MODULE_REL_L2
    assert torch.equal(out["xla"], out[None])
