"""K2/K3/K4 plain versions and the fused-block autograd node against the JAX kernels.

The JAX side runs ``fused_swin_block_fwd_h``, ``_bwd_mlp``, ``_bwd_attn`` and
``fused_swin_block_ad`` in Pallas interpret mode on the CPU; the port runs its
plain versions (the kernels' CPU path) on the same numpy-seeded inputs at
Bw=8, C=16, 2 heads, hidden 32.

Tolerances: fp32 agrees to ~1e-5 (the same math, summed in another order;
the JAX kernel's exact GELU uses a rational erf with 1.5e-7 error). In bf16
every output is held to 1e-2 of its largest entry, the JAX kernel tests'
bf16 bound: both sides round the same operands to bf16, but K2's LN2 reads
the bf16 h here (as K1 does) where the TPU kernel reads the fp32 h, and
sums run in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import swin_block as jsb
from superresolution_def_tpu_torch.kernels import (
    FusedSwinBlockFn,
    swin_block_bwd_attn,
    swin_block_bwd_mlp,
    swin_block_fwd_h,
)

# The suite runs in parallel worker processes on few cores, beside JAX tests
# whose CPU collectives abort when their threads starve: torch takes one
# thread per process (every worker imports this module at collection).
torch.set_num_threads(1)

BW, C, HEADS, HID = 8, 16, 2, 32
SCALE = (C // HEADS) ** -0.5
NAMES = ["x", "ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj", "bproj", "ln2_w", "ln2_b",
         "w1", "b1", "w2", "b2"]


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


# weights and windows in the io dtype, vectors and the bias table fp32
IO = {"x", "wqkv", "wproj", "w1", "w2"}


def _jax(a, name, dt):
    return jnp.asarray(a, dt if name in IO else jnp.float32)


def _torch(a, name, dt):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dt) if name in IO else t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= 1e-2 * max(np.abs(want).max(), 1e-3), (what, err, np.abs(want).max())


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_h_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        jout, jh = jsb.fused_swin_block_fwd_h(
            *(_jax(p[k], k, jdt) for k in NAMES), num_heads=HEADS, scale=SCALE,
            block_windows=4)
    out, h = swin_block_fwd_h(*(_torch(p[k], k, tdt) for k in NAMES), num_heads=HEADS,
                              scale=SCALE)
    assert out.dtype == h.dtype == tdt
    _assert_close(h, jh, dtype, "h")
    _assert_close(out, jout, dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_mlp_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(1)
    r = np.random.default_rng(2)
    h = r.standard_normal((BW, 64, C)).astype(np.float32)
    dout = (0.1 * r.standard_normal((BW, 64, C))).astype(np.float32)
    keys = ["ln2_w", "ln2_b", "w1", "b1", "w2", "b2"]
    with pltpu.force_tpu_interpret_mode():
        want = jsb._bwd_mlp(jnp.asarray(h, jdt), jnp.asarray(dout, jdt),
                            *(_jax(p[k], k, jdt) for k in keys), block_windows=4)
    got = swin_block_bwd_mlp(torch.from_numpy(h).to(tdt), torch.from_numpy(dout).to(tdt),
                             *(_torch(p[k], k, tdt) for k in keys[:-1]))
    assert got[0].dtype == tdt
    for name, g, w in zip(["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2"], got, want):
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_attn_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(3)
    dh = (0.1 * np.random.default_rng(4).standard_normal((BW, 64, C))).astype(np.float32)
    keys = ["x", "ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj"]
    with pltpu.force_tpu_interpret_mode():
        want = jsb._bwd_attn(_jax(p["x"], "x", jdt), jnp.asarray(dh, jdt),
                             *(_jax(p[k], k, jdt) for k in keys[1:]),
                             num_heads=HEADS, scale=SCALE, block_windows=4, packed=False)
    got = swin_block_bwd_attn(_torch(p["x"], "x", tdt), torch.from_numpy(dh).to(tdt),
                              *(_torch(p[k], k, tdt) for k in keys[1:]),
                              num_heads=HEADS, scale=SCALE)
    assert got[0].dtype == tdt
    names = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    for name, g, w in zip(names, got, want):
        _assert_close(g, w, dtype, name)


def test_autograd_node_matches_jax_grad():
    """FusedSwinBlockFn's gradients against jax.grad of fused_swin_block_ad
    (fp32, sum of squares of the block output)."""
    p = _inputs(5)
    args = [jnp.asarray(p[k]) for k in NAMES]

    def loss(*a):
        return jnp.sum(jsb.fused_swin_block_ad(*a, None, HEADS, SCALE, 4) ** 2)

    # one jitted program, waited for at once: eager JAX ops dispatched while an
    # interpreted kernel's host callbacks run can deadlock the CPU client
    with pltpu.force_tpu_interpret_mode():
        jval, jgrads = jax.block_until_ready(
            jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args)))))(*args))
    targs = [torch.from_numpy(p[k]).requires_grad_() for k in NAMES]
    out = FusedSwinBlockFn.apply(*targs, HEADS, SCALE)
    tval = (out**2).sum()
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5)
    for name, t, g in zip(NAMES, targs, jgrads):
        assert t.grad.dtype == t.dtype
        # fp32 sums of up to 512 tokens: entries near 0 cancel, so the
        # absolute bound scales with the gradient's largest entry
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=f"grad of {name}")


def test_differentiable_fused_swinir_matches_module_autograd():
    """make_fused_swinir(differentiable=True) in fp32 on the CPU (the plain
    versions behind K2/K3/K4) against autograd of the nn.Module: the window
    gathers, the operand casts and the bias-table gather carry the same
    gradients (fp32, summed in other orders: 1e-4 of each gradient's largest
    entry)."""
    from superresolution_def_tpu_torch.kernels import make_fused_swinir
    from superresolution_def_tpu_torch.models import SwinIR

    model = SwinIR(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
                   window_size=8, mlp_ratio=2.0, upscale=4,
                   generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((2, 16, 16, 1), dtype=np.float32))
    probe = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    fused = make_fused_swinir(model, dtype=torch.float32, differentiable=True)

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
