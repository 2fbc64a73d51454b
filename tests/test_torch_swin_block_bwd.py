"""K4b's plain version and the recompute autograd node against the JAX kernels.

The JAX side runs ``fused_swin_block_bwd`` (the whole block's backward from
x and dout, the forward recomputed) and ``fused_swin_block_ad`` in Pallas
interpret mode on the CPU, each jitted and waited for before anything else
is dispatched; the port runs its plain versions (the kernels' CPU path) on
the same numpy-seeded inputs at Bw=8, C=16, 2 heads, hidden 32.

Tolerances: fp32 agrees to rtol 1e-4 / atol 1e-5 (the same math, summed in
another order; the JAX kernel's exact GELU uses a rational erf with 1.5e-7
error). In bf16 every output is held to 1e-2 of its largest entry, the JAX
kernel tests' bf16 bound: both sides round the same operands at the same
points (LN2 on the fp32 h, dh fp32 into dbproj and dx), but sums run in
other orders and an intermediate on the other side of a rounding step moves
what is computed from it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import swin_block as jsb
from superresolution_def_tpu_torch.kernels import (
    FusedSwinBlockRecomputeFn,
    make_fused_swinir,
    swin_block_bwd,
)
from superresolution_def_tpu_torch.models import SwinIR

# one torch thread per worker process (see test_torch_swin_block_train.py)
torch.set_num_threads(1)

BW, C, HEADS, HID = 8, 16, 2, 32
SCALE = (C // HEADS) ** -0.5
NAMES = ["x", "ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj", "bproj", "ln2_w", "ln2_b",
         "w1", "b1", "w2", "b2"]
GRADS = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj", "dln2_w",
         "dln2_b", "dw1", "db1", "dw2", "db2"]
# weights and windows in the io dtype, vectors and the bias table fp32
IO = {"x", "wqkv", "wproj", "w1", "w2"}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed):
    r = np.random.default_rng(seed)

    def f(*s, base=0.0, std=0.3):
        return (base + std * r.standard_normal(s)).astype(np.float32)

    return dict(
        x=f(BW, 64, C, std=1.0), ln1_w=f(C, base=1.0, std=0.1), ln1_b=f(C, std=0.1),
        wqkv=f(C, 3 * C), bqkv=f(3 * C, std=0.1), bias=f(HEADS, 64, 64, std=0.5),
        wproj=f(C, C), bproj=f(C, std=0.1), ln2_w=f(C, base=1.0, std=0.1),
        ln2_b=f(C, std=0.1), w1=f(C, HID), b1=f(HID, std=0.1), w2=f(HID, C),
        b2=f(C, std=0.1),
    )


def _jax(a, name, dt):
    return jnp.asarray(a, dt if name in IO else jnp.float32)


def _torch(a, name, dt):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dt) if name in IO else t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_bwd_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(0)
    dout = (0.1 * np.random.default_rng(1).standard_normal((BW, 64, C))).astype(np.float32)
    jargs = [_jax(p[k], k, jdt) for k in NAMES]
    bwd = jax.jit(functools.partial(jsb.fused_swin_block_bwd, num_heads=HEADS, scale=SCALE,
                                    block_windows=4))
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(bwd(jargs[0], jnp.asarray(dout, jdt), *jargs[1:]))
    targs = [_torch(p[k], k, tdt) for k in NAMES]
    got = swin_block_bwd(targs[0], torch.from_numpy(dout).to(tdt), *targs[1:], num_heads=HEADS,
                         scale=SCALE)
    assert len(got) == len(want) == 14
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(GRADS, got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-2 * max(np.abs(w).max(), 1e-3), (name, err, np.abs(w).max())


def test_recompute_node_matches_jax_vjp():
    """FusedSwinBlockRecomputeFn's gradients against jax.vjp of
    fused_swin_block_ad (K2 forward, K3 + K4 backward) in fp32, with one
    seeded cotangent: 1e-4 of each gradient's largest entry."""
    p = _inputs(2)
    cot = np.random.default_rng(3).standard_normal((BW, 64, C)).astype(np.float32)
    args = [jnp.asarray(p[k]) for k in NAMES]

    def run(*a):
        out, vjp = jax.vjp(lambda *b: jsb.fused_swin_block_ad(*b, None, HEADS, SCALE, 4), *a)
        return out, vjp(jnp.asarray(cot))

    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = jax.block_until_ready(jax.jit(run)(*args))
    targs = [torch.from_numpy(p[k]).requires_grad_() for k in NAMES]
    out = FusedSwinBlockRecomputeFn.apply(*targs, HEADS, SCALE)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jout)).max())
    for name, t, g in zip(NAMES, targs, jgrads):
        assert t.grad.dtype == t.dtype
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-4 * np.abs(g).max(),
                                   err_msg=f"grad of {name}")


def test_differentiable_fused_swinir_recompute_matches_module_autograd():
    """make_fused_swinir(differentiable=True, backward="recompute") in fp32 on
    the CPU (the plain versions behind K1 and K4b) against autograd of the
    nn.Module, as the split backward is held (1e-4 of each gradient's
    largest entry)."""
    model = SwinIR(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
                   window_size=8, mlp_ratio=2.0, upscale=4,
                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 16, 16, 1), dtype=np.float32))
    probe = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    fused = make_fused_swinir(model, dtype=torch.float32, differentiable=True,
                              backward="recompute")

    def grads(forward):
        xi = x.clone().requires_grad_()
        model.zero_grad()
        (forward(xi) * probe).sum().backward()
        return [xi.grad.clone()] + [p.grad.clone() for p in model.parameters()]

    want = grads(model)
    got = grads(fused)
    names = ["input"] + [n for n, _ in model.named_parameters()]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item(), err_msg=name)


def test_make_fused_swinir_names_its_backwards():
    model = SwinIR(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
                   window_size=8, mlp_ratio=2.0, upscale=4)
    with pytest.raises(ValueError, match="split' or 'recompute"):
        make_fused_swinir(model, differentiable=True, backward="checkpoint")
