"""K10a-b plain versions, the OCAB tail's autograd node and ``ocab_train``
against the JAX package.

The JAX side runs ``_ocab_fwd_h``, ``_ocab_bwd_attn``, ``ocab_tail_ad`` and
``ocab_train`` of ``kernels/ocab_train.py`` in Pallas interpret mode on the
CPU (no head packing off the TPU); the port runs its plain versions on the
same numpy-seeded inputs: Bw = 8, C = 30 in six heads of 5, hidden 60, 64
queries against 144 keys of which some are the zero vectors of the overlap
gather's padding. ``ocab_train`` runs one OCAB of a tiny HAT whose weights
both packages share through ``hat_state_dict_from_jax``.

Tolerances: fp32 to float32 summation order (rtol 1e-4, atol 1e-5 of each
output's largest entry; the parameter gradients of ``ocab_train`` 2e-4 and
2e-5 of their largest entry, the bound of tests/test_fused_hat_train.py's
``ocab_train`` test); bf16 to 1e-2 of each output's largest entry, the JAX
kernel tests' bf16 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import ocab_train as jot
from superresolution_def_tpu.models.hat import HAT as JaxHAT
from superresolution_def_tpu_torch.kernels import (
    OcabTailFn,
    ocab_bwd_attn,
    ocab_bwd_attn_reference,
    ocab_fwd_h,
    ocab_fwd_h_reference,
    ocab_train,
)
from superresolution_def_tpu_torch.models import HAT, hat_state_dict_from_jax

torch.set_num_threads(1)

# Every JAX reference below runs as one jitted program and is waited for at
# once: dispatching eager JAX ops while an interpreted Pallas kernel's host
# callbacks (which run jnp ops themselves) are in flight can deadlock the
# CPU client.

BW, C, HEADS, HID, NK = 8, 30, 6, 60, 144
SCALE = (C // HEADS) ** -0.5
NAMES = ["x", "q", "k", "v", "bias", "wproj", "bproj", "ln2_w", "ln2_b", "w1", "b1", "w2", "b2"]
IO = {"x", "q", "k", "v", "wproj", "w1", "w2", "dh"}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed):
    r = np.random.default_rng(seed)

    def f(*s, base=0.0, std=0.3):
        return (base + std * r.standard_normal(s)).astype(np.float32)

    p = dict(
        x=f(BW, 64, C, std=1.0), q=f(BW, 64, C, std=1.0), k=f(BW, NK, C, std=1.0),
        v=f(BW, NK, C, std=1.0), bias=f(HEADS, 64, NK, std=0.5), wproj=f(C, C),
        bproj=f(C, std=0.1), ln2_w=f(C, base=1.0, std=0.1), ln2_b=f(C, std=0.1), w1=f(C, HID),
        b1=f(HID, std=0.1), w2=f(HID, C), b2=f(C, std=0.1),
    )
    # keys of the overlap outside the image are zero vectors that stay in the softmax
    p["k"][:, :14] = 0.0
    p["v"][:, :14] = 0.0
    return p


def _jax(a, name, dt):
    return jnp.asarray(a, dt if name in IO else jnp.float32)


def _torch(a, name, dt):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(dt) if name in IO else t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _assert_close(got, want, dtype, what, rtol=1e-4, atol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = max(np.abs(want).max(), 1e-3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * bound, err_msg=what)
    else:
        err = np.abs(got - want).max()
        assert err <= 1e-2 * bound, (what, err, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_h_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        jout, jh = jax.block_until_ready(jot._ocab_fwd_h(
            *(_jax(p[k], k, jdt) for k in NAMES), num_heads=HEADS, scale=SCALE,
            block_windows=4))
    args = [_torch(p[k], k, tdt) for k in NAMES]
    out, h = ocab_fwd_h_reference(*args, num_heads=HEADS, scale=SCALE)
    assert out.dtype == h.dtype == tdt
    _assert_close(h, jh, dtype, "h")
    _assert_close(out, jout, dtype, "out")
    got = ocab_fwd_h(*args, num_heads=HEADS, scale=SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, (out, h))) and ocab_fwd_h.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_attn_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(1)
    dh = (0.1 * np.random.default_rng(2).standard_normal((BW, 64, C))).astype(np.float32)
    keys = ["q", "k", "v"]
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(jot._ocab_bwd_attn(
            *(_jax(p[k], k, jdt) for k in keys), _jax(dh, "dh", jdt),
            _jax(p["bias"], "bias", jdt), _jax(p["wproj"], "wproj", jdt), num_heads=HEADS,
            scale=SCALE, block_windows=4, packed=False))
    args = (*(_torch(p[k], k, tdt) for k in keys), _torch(dh, "dh", tdt),
            _torch(p["bias"], "bias", tdt), _torch(p["wproj"], "wproj", tdt))
    got = ocab_bwd_attn_reference(*args, num_heads=HEADS, scale=SCALE)
    assert got[0].dtype == got[1].dtype == got[2].dtype == tdt
    for name, g, w in zip(["dq", "dk", "dv", "dbias", "dwproj", "dbproj"], got, want):
        _assert_close(g, w, dtype, name)
    again = ocab_bwd_attn(*args, num_heads=HEADS, scale=SCALE)
    assert all(torch.equal(a, b) for a, b in zip(again, got)) and ocab_bwd_attn.launches == 0


def test_autograd_node_matches_jax_vjp():
    """OcabTailFn's gradients against jax.vjp of ocab_tail_ad (fp32): dx = dh
    and every other differentiable input."""
    p = _inputs(3)
    dout = np.random.default_rng(4).standard_normal((BW, 64, C)).astype(np.float32)
    jargs = [jnp.asarray(p[k]) for k in NAMES]

    def tail(*a):
        return jot.ocab_tail_ad(*a, HEADS, SCALE, 4, False)

    @jax.jit
    def fwd_bwd(args, ct):
        out, vjp = jax.vjp(tail, *args)
        return out, vjp(ct)

    with pltpu.force_tpu_interpret_mode():
        jout, jgrads = jax.block_until_ready(fwd_bwd(jargs, jnp.asarray(dout)))
    targs = [torch.from_numpy(p[k]).requires_grad_() for k in NAMES]
    out = OcabTailFn.apply(*targs, HEADS, SCALE, None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    out.backward(torch.from_numpy(dout))
    for name, t, g in zip(NAMES, targs, jgrads):
        assert t.grad.dtype == t.dtype
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4, atol=1e-6 * np.abs(g).max(),
                                   err_msg=f"grad of {name}")


def test_ocab_train_matches_jax_with_parameter_gradients():
    """ocab_train of one OCAB module against the JAX ocab_train on the same
    (bridged) weights, fp32: the output, dx and the gradient of every OCAB
    parameter (LN1, qkv, the bias table, proj, LN2, the MLP)."""
    cfg = dict(img_size=16, in_chans=1, embed_dim=C, depths=(2,), num_heads=(HEADS,),
               window_size=8, upscale=2, img_range=1.0)
    params = JaxHAT(**cfg, upsampler="pixelshuffle").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    port = HAT(**cfg)
    port.load_state_dict(hat_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    oc = port.layers[0].residual_group.overlap_attn
    jp = params["layers_0"]["overlap_attn"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    probe = rng.standard_normal((2, 16, 16, C)).astype(np.float32)

    def fwd(p_, xin):
        return jot.ocab_train(p_, xin, 8, 0.5, HEADS, 4)

    def loss(p_, xin):
        return jnp.sum(fwd(p_, xin) * probe)

    with pltpu.force_tpu_interpret_mode():
        jout = jax.block_until_ready(jax.jit(fwd)(jp, jnp.asarray(x)))
        gp, gx = jax.block_until_ready(jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jp, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = ocab_train(oc, xt, dtype=torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=2e-5)
    (out * torch.from_numpy(probe)).sum().backward()
    _assert_close(xt.grad, gx, "float32", "dx")
    want = {k[len("layers.0.residual_group.overlap_attn."):]: v for k, v in hat_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {**params, "layers_0": {
            **params["layers_0"], "overlap_attn": gp}})).items()
        if k.startswith("layers.0.residual_group.overlap_attn.")}
    got = dict(oc.named_parameters())
    assert set(got) == set(want)
    for k, g in got.items():
        _assert_close(g.grad, want[k], "float32", f"grad of {k}", rtol=2e-4, atol=2e-5)
