"""K4b's three phases, each in its plain form, against K4b's plain version
and the JAX kernel.

K4b (``swin_block_bwd``) runs as three kernels: the recompute to the fp32 h
(K2's forward up to h), the MLP phase on that fp32 h (K3's kernel, keeping
dh in fp32) and the attention phase on the fp32 dh (K4's kernel). Their
plain forms are ``swin_block_h_reference``, ``swin_block_bwd_mlp_reference``
given the fp32 h and a bf16 dout, and ``swin_block_bwd_attn_reference``
given the fp32 dh. Composed, they must give ``swin_block_bwd_reference`` and
the JAX ``fused_swin_block_bwd`` (Pallas interpret mode, as
``tests/test_torch_swin_block_bwd.py`` runs it), which pins each phase's
rounding points: LN2 on the fp32 h, dh fp32 into dbproj and dx's residual,
bf16(dh) into do and dWproj.

Tolerances. Against K4b's plain version: fp32 to rtol 1e-5 of each entry and
1e-6 of each output's largest entry (the same products; h sums x, proj and
bproj in another order); bf16 to 1e-2 of each output's largest entry (that
reordering can move an intermediate across a bf16 rounding step). Against
JAX: the bounds of ``tests/test_torch_swin_block_bwd.py``. The packing test
is exact: the operands are small multiples of powers of two.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.kernels import swin_block as jsb
from superresolution_def_tpu_torch.kernels.swin_block import (
    attn_head_width,
    attn_pack_reference,
    swin_block_bwd_attn_reference,
    swin_block_bwd_mlp_reference,
    swin_block_bwd_reference,
    swin_block_fwd_h_reference,
    swin_block_h_reference,
)

torch.set_num_threads(1)

BW, C, HEADS, HID = 8, 16, 2, 32
SCALE = (C // HEADS) ** -0.5
NAMES = ["x", "ln1_w", "ln1_b", "wqkv", "bqkv", "bias", "wproj", "bproj", "ln2_w", "ln2_b",
         "w1", "b1", "w2", "b2"]
GRADS = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj", "dln2_w",
         "dln2_b", "dw1", "db1", "dw2", "db2"]
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


def _torch_args(seed, tdt):
    p = _inputs(seed)
    return [torch.from_numpy(p[k]).to(tdt) if k in IO else torch.from_numpy(p[k])
            for k in NAMES]


def _dout(tdt):
    d = 0.1 * np.random.default_rng(1).standard_normal((BW, 64, C))
    return torch.from_numpy(d.astype(np.float32)).to(tdt)


def _phases(args, dout):
    """K4b's three phases, plain, in the kernel's order; the 14 gradients in
    swin_block_bwd_reference's order."""
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, _ = args
    kw = dict(num_heads=HEADS, scale=SCALE)
    h = swin_block_h_reference(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, **kw)
    dh, dln2_w, dln2_b, dw1, db1, dw2, db2 = swin_block_bwd_mlp_reference(
        h, dout, ln2_w, ln2_b, w1, b1, w2)
    attn = swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    return (h, dh), (*attn, dln2_w, dln2_b, dw1, db1, dw2, db2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recompute_phase_is_k2s_h_before_its_rounding(dtype):
    """Phase 1 stops at K2's h in fp32: rounded to the io dtype it is K2's h
    bit for bit; the MLP phase keeps dh in fp32 whatever the io dtype."""
    tdt = DTYPES[dtype][1]
    args = _torch_args(0, tdt)
    (h, dh), _ = _phases(args, _dout(tdt))
    assert h.dtype == torch.float32 and dh.dtype == torch.float32
    assert h.shape == dh.shape == (BW, 64, C)
    _, k2_h = swin_block_fwd_h_reference(*args, num_heads=HEADS, scale=SCALE)
    assert torch.equal(h.to(tdt), k2_h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phases_compose_to_the_block_backward(dtype):
    tdt = DTYPES[dtype][1]
    args = _torch_args(0, tdt)
    dout = _dout(tdt)
    _, got = _phases(args, dout)
    want = swin_block_bwd_reference(args[0], dout, *args[1:], num_heads=HEADS, scale=SCALE)
    assert len(got) == len(want) == 14
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        g, w = g.float().numpy(), w.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-2 * max(np.abs(w).max(), 1e-3), (name, err, np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phases_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    p = _inputs(0)
    dout = (0.1 * np.random.default_rng(1).standard_normal((BW, 64, C))).astype(np.float32)
    jargs = [jnp.asarray(p[k], jdt if k in IO else jnp.float32) for k in NAMES]
    bwd = jax.jit(functools.partial(jsb.fused_swin_block_bwd, num_heads=HEADS, scale=SCALE,
                                    block_windows=4))
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(bwd(jargs[0], jnp.asarray(dout, jdt), *jargs[1:]))
    _, got = _phases(_torch_args(0, tdt), torch.from_numpy(dout).to(tdt))
    for name, g, w in zip(GRADS, got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:
            err = np.abs(g - w).max()
            assert err <= 1e-2 * max(np.abs(w).max(), 1e-3), (name, err, np.abs(w).max())


def _tiles(packed, c, heads):
    """(heads * 4, ck, hp) from the attention packing: element (c, j) of a
    tile at (c // 8) hp*8 + (j // 8) 64 + (c % 8) 8 + j % 8."""
    hp, ck = attn_head_width(c, heads), -(-c // 64) * 64
    cc, jj = np.meshgrid(np.arange(ck), np.arange(hp), indexing="ij")
    pos = (cc // 8) * hp * 8 + (jj // 8) * 64 + (cc % 8) * 8 + jj % 8
    return packed.reshape(heads * 4, ck * hp)[:, pos]


def _recompute_stream(heads):
    """The packed tiles the recompute's producer streams for one window, in
    order (swin_fwd_wg.cuh): per head wq, wk, wv (4h + 1 .. 3), then wproj
    (4h)."""
    return [4 * (t // 4) + (t % 4 + 1 if t % 4 < 3 else 0) for t in range(4 * heads)]


def _attention_stream(heads):
    """The packed tiles the attention phase's producer streams for one window
    (swin_bwd_wg.cuh): phase A per head wproj, wq, wk, wv (4h .. 4h + 3),
    then phase B per head wq, wk, wv again."""
    return list(range(4 * heads)) + [4 * (u // 3) + 1 + u % 3 for u in range(3 * heads)]


@pytest.mark.parametrize("c,heads", [(180, 6), (96, 3), (16, 2)])
def test_one_packing_serves_the_recompute_and_the_attention_phase(c, heads):
    """K4b packs wqkv and wproj once for its phases 1 and 3. Walked in each
    phase's streaming order and applied as that phase applies each tile, the
    one packing gives the recompute's q, k, v and proj and the attention
    phase's q, k, v, do and dxn, exactly."""
    rng = np.random.default_rng(c + heads)
    hd, hp, ck = c // heads, attn_head_width(c, heads), -(-c // 64) * 64

    def exact(*shape, scale):
        return rng.integers(-8, 9, shape).astype(np.float64) / scale

    wqkv, wproj = exact(c, 3 * c, scale=8), exact(c, c, scale=8)
    bf = torch.bfloat16
    packed = attn_pack_reference(torch.from_numpy(wqkv).to(bf), torch.from_numpy(wproj).to(bf),
                                 heads)
    tiles = _tiles(packed.double().numpy(), c, heads).reshape(heads * 4, ck, hp)
    xn = np.zeros((64, ck))
    xn[:, :c] = exact(64, c, scale=16)
    o = exact(64, c, scale=16)     # the attention output, head h at columns h*hd ..
    dh = np.zeros((64, ck))
    dh[:, :c] = exact(64, c, scale=16)
    dqkv = exact(64, 3 * c, scale=16)

    # the recompute: three tiles for qkv, then wproj^T for proj (K-major B)
    qkv, proj = np.zeros((64, 3 * c)), np.zeros((64, ck))
    stream = iter(_recompute_stream(heads))
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        for which in range(3):
            qkv[:, which * c:(which + 1) * c][:, cols] = (xn @ tiles[next(stream)])[:, :hd]
        oh = np.zeros((64, hp))
        oh[:, :hd] = o[:, cols]
        proj += oh @ tiles[next(stream)].T
    np.testing.assert_array_equal(qkv, xn[:, :c] @ wqkv)
    np.testing.assert_array_equal(proj[:, :c], o @ wproj)
    assert not proj[:, c:].any()

    # the attention phase: phase A wproj (do), wq, wk, wv; phase B dxn
    qkv2, do, dxn = np.zeros((64, 3 * c)), np.zeros((64, c)), np.zeros((64, ck))
    stream = iter(_attention_stream(heads))
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        do[:, cols] = (dh @ tiles[next(stream)])[:, :hd]
        for which in range(3):
            qkv2[:, which * c:(which + 1) * c][:, cols] = (xn @ tiles[next(stream)])[:, :hd]
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        for which in range(3):
            d = np.zeros((64, hp))
            d[:, :hd] = dqkv[:, which * c:(which + 1) * c][:, cols]
            dxn += d @ tiles[next(stream)].T
    np.testing.assert_array_equal(qkv2, qkv)
    np.testing.assert_array_equal(do, dh[:, :c] @ wproj.T)
    np.testing.assert_array_equal(dxn[:, :c], dqkv @ wqkv.T)
    assert not dxn[:, c:].any()
