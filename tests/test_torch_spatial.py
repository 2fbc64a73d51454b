"""The port's spatially sharded forwards (``parallel/spatial.py``, ``spatial_hat.py``).

- Against the JAX package: ``make_spatial_swinir`` in gloo worlds of 2 and
  4 ranks and ``make_spatial_hybrid`` in a world of 2, on the JAX spatial
  tests' tiny models and 64 x 16 frames, against the JAX ``make_spatial_*``
  on ``make_mesh(jax.devices()[:n])`` with the same weights (the port's
  seeded modules through the JAX ``torch_port`` readers); the JAX spatial
  tests' bounds: SwinIR atol 2e-5, rtol 1e-4; the hybrid atol 5e-5, rtol
  1e-4. Every rank returns the whole frame, bit for bit the same.
- A world of one in-process runs no collective: against the dense
  ``nn.Module`` forward (the convs' padding is the only difference: fp32
  sums in another order, atol 1e-5, rtol 1e-4), with the same JAX bounds
  for the halo primitives' semantics; and its input checks.

The JAX calls run with its compilation cache off: a cache hit on a sharded
executable aborts the process.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import run_world
from superresolution_def_tpu.models.torch_port import hybrid_from_torch, swinir_from_torch
from superresolution_def_tpu.parallel import make_mesh as jax_mesh
from superresolution_def_tpu.parallel.spatial import make_spatial_swinir as jax_spatial_swinir
from superresolution_def_tpu.parallel.spatial_hat import make_spatial_hybrid as jax_spatial_hybrid
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
from superresolution_def_tpu_torch.parallel import (
    make_mesh,
    make_spatial_hat,
    make_spatial_hybrid,
    make_spatial_swinir,
)

torch.set_num_threads(1)

SWIN = dict(img_size=64, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2.0, upscale=4)
HYBRID = dict(img_size=64, in_chans=1, embed_dim=30, depths=(2,), num_heads=(6,),
              window_size=8, num_rrdb=2, num_feat=16, num_grow_ch=8)


@contextlib.contextmanager
def _no_compile_cache():
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", old)


def _np_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _frame(seed, batch):
    return np.random.default_rng(seed).random((batch, 64, 16, 1), np.float32)


@pytest.mark.parametrize("ranks", [2, 4])
def test_spatial_swinir_matches_jax(tmp_path, ranks):
    model = SwinIR(**SWIN, generator=torch.Generator().manual_seed(3)).eval()
    x = _frame(2, 2)
    with _no_compile_cache():
        fn = jax_spatial_swinir(jax_mesh(jax.devices()[:ranks]), depths=(2,), num_heads=(2,),
                                window_size=8, upscale=4)
        want = np.asarray(fn(swinir_from_torch(_np_sd(model), (2,)), x))
    outs = run_world("spatial", ranks, tmp_path, {
        "arch": "swin", "config": SWIN, "state_dict": model.state_dict(),
        "x": torch.from_numpy(x)})
    got = outs[0]["out"].numpy()
    assert got.shape == want.shape == (2, 256, 64, 1)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    for out in outs[1:]:
        assert torch.equal(out["out"], outs[0]["out"])


def test_spatial_hybrid_matches_jax(tmp_path):
    model = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(4)).eval()
    x = _frame(1, 1)
    with _no_compile_cache():
        fn = jax_spatial_hybrid(jax_mesh(jax.devices()[:2]), depths=(2,), num_heads=(6,),
                                window_size=8, num_rrdb=2)
        params = hybrid_from_torch(_np_sd(model), {"depths": (2,), "num_rrdb": 2})
        want = np.asarray(fn(params, x))
    outs = run_world("spatial", 2, tmp_path, {
        "arch": "hat", "config": HYBRID, "state_dict": model.state_dict(),
        "x": torch.from_numpy(x)})
    got = outs[0]["out"].numpy()
    assert got.shape == want.shape == (1, 256, 64, 1)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    assert torch.equal(outs[1]["out"], outs[0]["out"])


@pytest.mark.parametrize("arch", ["swin", "hat", "hybrid"])
def test_world_of_one_matches_the_module(arch):
    """No process group: the spatial forward is the module's, its convs padded by concatenation."""
    gen = torch.Generator().manual_seed(5)
    if arch == "swin":
        model, make = SwinIR(**SWIN, generator=gen), make_spatial_swinir
    elif arch == "hat":
        model = HybridHATRealESRGAN(**HYBRID, generator=gen).hat
        make = make_spatial_hat
    else:
        model, make = HybridHATRealESRGAN(**HYBRID, generator=gen), make_spatial_hybrid
    model = model.eval()
    x = torch.from_numpy(_frame(6, 2)[:, :32])  # 32 x 16: both shifts and the OCAB borders
    with torch.no_grad():
        want = model(x)
    got = make(make_mesh("cpu"), model)(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-4)


def test_spatial_rejects_frames_that_do_not_divide():
    model = SwinIR(**SWIN).eval()
    with pytest.raises(ValueError, match="must divide"):
        make_spatial_swinir(make_mesh("cpu"), model)(torch.zeros(1, 60, 16, 1))
