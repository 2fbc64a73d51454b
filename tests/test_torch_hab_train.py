"""K9a-c plain versions and the HAB autograd node against the JAX kernels.

The JAX side runs ``_hab_fwd_h``, ``_hab_bwd_mlp``, ``_hab_bwd_attn`` and
``hab_core_ad`` of ``kernels/hab_train.py`` in Pallas interpret mode on the
CPU, without head packing; the port runs its plain versions (the kernels' CPU
path) on the same numpy-seeded inputs: Bw = 8 (two 16x16 images), C = 30 in
two heads of 15 (the width the kernels pad), hidden 60, the shift mask of a
16x16 image (nonzero), and drop-path scales with one dropped sample (the JAX
kernels take them as (Bw, 1, C) windows of the per-sample value, the port as
one value per window).

Tolerances: fp32 agrees to float32 summation order (rtol 1e-4, atol 1e-5 of
each output's largest entry, as tests/test_torch_swin_block_train.py); in
bf16 every output is held to 1e-2 of its largest entry, the JAX kernel tests'
bf16 bound (LN2 reads the bf16 h here where the TPU kernel reads the fp32 h,
and sums run in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import hab_train as jht
from superresolution_def_tpu_torch.kernels import (
    HabCoreFn,
    hab_bwd_attn,
    hab_bwd_attn_reference,
    hab_bwd_mlp,
    hab_bwd_mlp_reference,
    hab_fwd_h,
    hab_fwd_h_reference,
)
from superresolution_def_tpu_torch.ops import shift_window_attn_mask

torch.set_num_threads(1)

# Every JAX reference below runs as one jitted program and is waited for at
# once: dispatching eager JAX ops while an interpreted Pallas kernel's host
# callbacks (which run jnp ops themselves) are in flight can deadlock the
# CPU client.

NW, B = 4, 2
BW, C, HEADS, HID = NW * B, 30, 2, 60
SCALE = (C // HEADS) ** -0.5
CONV_SCALE = 0.01
NAMES = ["x", "convx", "ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj", "bproj", "ln2_w",
         "ln2_b", "w1", "b1", "w2", "b2"]
IO = {"x", "convx", "wqkv", "wproj", "w1", "w2", "h", "dout", "dh"}
MASK = shift_window_attn_mask(16, 16, 8, 4)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed):
    r = np.random.default_rng(seed)

    def f(*s, base=0.0, std=0.3):
        return (base + std * r.standard_normal(s)).astype(np.float32)

    return dict(
        x=f(BW, 64, C, std=1.0), convx=f(BW, 64, C, std=1.0), ln1_w=f(C, base=1.0, std=0.1),
        ln1_b=f(C, std=0.1), wqkv=f(C, 3 * C), bqkv=f(3 * C, std=0.1),
        bias=f(HEADS, 64, 64, std=0.5), wproj=f(C, C), bproj=f(C, std=0.1),
        ln2_w=f(C, base=1.0, std=0.1), ln2_b=f(C, std=0.1), w1=f(C, HID), b1=f(HID, std=0.1),
        w2=f(HID, C), b2=f(C, std=0.1),
    )


def _dp(keep_first: bool = True):
    """Per-sample drop-path scales (one sample dropped), per window."""
    per_sample = np.array([1 / 0.9 if keep_first else 0.0, 0.0 if keep_first else 1 / 0.9],
                          np.float32)
    return np.repeat(per_sample, NW)


def _jax(a, name, dt):
    return jnp.asarray(a, dt if name in IO else jnp.float32)


def _torch(a, name, dt):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dt) if name in IO else t


def _jax_dp(dp):
    return jnp.asarray(np.broadcast_to(dp[:, None, None], (BW, 1, C)).copy())


def _jax_mask(shifted):
    m = MASK if shifted else np.zeros_like(MASK)
    return jnp.asarray(np.tile(m, (B, 1, 1)))


def _torch_mask(shifted):
    return torch.from_numpy(MASK) if shifted else None


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = max(np.abs(want).max(), 1e-3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * bound, err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= 1e-2 * bound, (what, err, bound)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_h_matches_jax(dtype, shifted):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(0 + shifted)
    dp1, dp2 = _dp(True), _dp(False)
    with pltpu.force_tpu_interpret_mode():
        jout, jh = jax.block_until_ready(jht._hab_fwd_h(
            _jax(p["x"], "x", jdt), _jax(p["convx"], "convx", jdt), _jax_mask(shifted),
            _jax_dp(dp1), _jax_dp(dp2), *(_jax(p[k], k, jdt) for k in NAMES[2:]),
            num_heads=HEADS, scale=SCALE, conv_scale=CONV_SCALE, block_windows=4))
    args = (_torch(p["x"], "x", tdt), _torch(p["convx"], "convx", tdt), _torch_mask(shifted),
            torch.from_numpy(dp1), torch.from_numpy(dp2),
            *(_torch(p[k], k, tdt) for k in NAMES[2:]))
    kw = dict(num_heads=HEADS, scale=SCALE, conv_scale=CONV_SCALE)
    out, h = hab_fwd_h_reference(*args, **kw)
    assert out.dtype == h.dtype == tdt
    _assert_close(h, jh, dtype, "h")
    _assert_close(out, jout, dtype, "out")
    # the wrapper on CPU tensors is the plain version; the dropped sample's
    # windows take no branch at all
    got = hab_fwd_h(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, (out, h))) and hab_fwd_h.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_mlp_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(2)
    r = np.random.default_rng(3)
    h = r.standard_normal((BW, 64, C)).astype(np.float32)
    dout = (0.1 * r.standard_normal((BW, 64, C))).astype(np.float32)
    dp2 = _dp(True)
    keys = ["ln2_w", "ln2_b", "w1", "b1", "w2", "b2"]
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jht._hab_bwd_mlp(
            _jax(h, "h", jdt), _jax(dout, "dout", jdt), _jax_dp(dp2),
            *(_jax(p[k], k, jdt) for k in keys), block_windows=4))
    args = (_torch(h, "h", tdt), _torch(dout, "dout", tdt), torch.from_numpy(dp2),
            *(_torch(p[k], k, tdt) for k in keys[:-1]))
    got = hab_bwd_mlp_reference(*args)
    assert got[0].dtype == tdt
    for name, g, w in zip(["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2"], got, want):
        _assert_close(g, w, dtype, name)
    # the dropped sample's windows pass dout through as dh
    np.testing.assert_array_equal(_np(got[0])[NW:], _np(args[1])[NW:])
    assert all(torch.equal(a, b) for a, b in zip(hab_bwd_mlp(*args), got))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_attn_matches_jax(dtype, shifted):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(4 + shifted)
    dh = (0.1 * np.random.default_rng(5).standard_normal((BW, 64, C))).astype(np.float32)
    dp1 = _dp(False)
    keys = ["ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj"]
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jht._hab_bwd_attn(
            _jax(p["x"], "x", jdt), _jax(dh, "dh", jdt), _jax_mask(shifted), _jax_dp(dp1),
            *(_jax(p[k], k, jdt) for k in keys), num_heads=HEADS, scale=SCALE,
            block_windows=4, packed=False))
    args = (_torch(p["x"], "x", tdt), _torch(dh, "dh", tdt), _torch_mask(shifted),
            torch.from_numpy(dp1), *(_torch(p[k], k, tdt) for k in keys))
    kw = dict(num_heads=HEADS, scale=SCALE)
    got = hab_bwd_attn_reference(*args, **kw)
    assert got[0].dtype == tdt
    names = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    for name, g, w in zip(names, got, want):
        _assert_close(g, w, dtype, name)
    np.testing.assert_array_equal(_np(got[0])[:NW], _np(args[1])[:NW])  # dropped: dx = dh
    assert all(torch.equal(a, b) for a, b in zip(hab_bwd_attn(*args, **kw), got))


def test_autograd_node_matches_jax_vjp():
    """HabCoreFn's gradients against jax.vjp of hab_core_ad (fp32, shifted,
    one sample's attention branch and the other's MLP branch dropped): every
    differentiable input, conv_x's conv_scale * dh included."""
    p = _inputs(6)
    dout = np.random.default_rng(7).standard_normal((BW, 64, C)).astype(np.float32)
    dp1, dp2 = _dp(True), _dp(False)
    jargs = [jnp.asarray(p[k]) for k in NAMES]
    front = (jargs[0], jargs[1], _jax_mask(True), _jax_dp(dp1), _jax_dp(dp2))

    def core(x, convx, *params):
        return jht.hab_core_ad(x, convx, *front[2:], *params, HEADS, SCALE, CONV_SCALE, 4, False)

    @jax.jit
    def fwd_bwd(args, ct):
        out, vjp = jax.vjp(core, *args)
        return out, vjp(ct)

    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = jax.block_until_ready(fwd_bwd(jargs, jnp.asarray(dout)))
    targs = [torch.from_numpy(p[k]).requires_grad_() for k in NAMES]
    out = HabCoreFn.apply(targs[0], targs[1], torch.from_numpy(MASK), torch.from_numpy(dp1),
                          torch.from_numpy(dp2), *targs[2:], HEADS, SCALE, CONV_SCALE, None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    out.backward(torch.from_numpy(dout))
    for name, t, g in zip(NAMES, targs, jgrads):
        assert t.grad.dtype == t.dtype
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=f"grad of {name}")
