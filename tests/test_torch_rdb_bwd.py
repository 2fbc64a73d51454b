"""K8's plain PyTorch version, the dense block's autograd.Function and the
differentiable trunk against the JAX package.

- ``rdb_cm_bwd_reference`` against the JAX TPU kernel ``fused_rdb_cm_bwd``
  in Pallas interpret mode at F/G = 16/8 on a 16 x 128 image with an 8-row
  tile, so the kernel's halos cross a tile edge. fp32: the two agree to
  float32 summation order (atol 5e-5, rtol 2e-4, the bound of
  tests/test_fused_hat.py); bf16: the frameworks round at different places
  inside the convs and an intermediate on the other side of a bf16 rounding
  step moves everything computed from it (atol 3e-2, rtol 5e-2, the bound of
  tests/test_torch_hat_kernels.py).
- the same reference against ``jax.vjp`` of the JAX ``ResidualDenseBlock``
  in fp32 (atol 5e-5, rtol 2e-4);
- ``DenseBlockFn`` on CPU tensors (its plain versions) against autograd
  through ``rdb_cm_reference``, and ``fused_rrdb_trunk_cm_ad`` against
  autograd of the ``nn.Module`` trunk, in fp32 (atol 1e-5, rtol 1e-4: the
  same convs in another order);
- K8's weight layout: the transposed convs the kernel computes from its
  packed B fragments equal ``conv_transpose2d`` of the HWIO weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_def_tpu.kernels.fused_rdb_cm_bwd import fused_rdb_cm_bwd as jax_rdb_bwd
from superresolution_def_tpu.models.hybrid import ResidualDenseBlock as JaxRDB
from superresolution_def_tpu_torch.kernels import (
    fused_rdb_cm_bwd,
    fused_rrdb_trunk_cm_ad,
    rdb_cm_bwd_reference,
    rdb_cm_reference,
)
from superresolution_def_tpu_torch.kernels.fused_rdb_cm_bwd import (
    bwd_fragment_index,
    dense_block_ad,
)
from superresolution_def_tpu_torch.models.hybrid import RRDBBlock

torch.set_num_threads(1)

TOL = {torch.float32: dict(atol=5e-5, rtol=2e-4), torch.bfloat16: dict(atol=3e-2, rtol=5e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _operands(seed, f, g, h, w, b=2):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, f, h * w))).astype(np.float32)
    dy = rng.standard_normal((b, f, h * w)).astype(np.float32)
    ks = [(rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
           * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32) for i in range(5)]
    bs = [(0.05 * rng.standard_normal(g if i < 4 else f)).astype(np.float32) for i in range(5)]
    return x, dy, ks, bs


def _torch(x, dy, ks, bs, dtype):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype),
            [torch.from_numpy(k) for k in ks], [torch.from_numpy(v) for v in bs])


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_reference_matches_jax_kernel(dtype):
    f, g, h, w = 16, 8, 16, 128
    x, dy, ks, bs = _operands(40 + (dtype == torch.bfloat16), f, g, h, w)
    jdx, jdks, jdbs = jax_rdb_bwd(jnp.asarray(x, JNP[dtype]), jnp.asarray(dy, JNP[dtype]),
                                  [jnp.asarray(k) for k in ks], [jnp.asarray(v) for v in bs],
                                  h=h, w=w, tile_h=8, interpret=True)
    dx, dks, dbs = rdb_cm_bwd_reference(*_torch(x, dy, ks, bs, dtype), h=h, w=w)
    assert dx.dtype == dtype and dx.shape == x.shape
    _close(dx.float().numpy(), jdx.astype(jnp.float32), TOL[dtype], "dx")
    for i in range(5):
        assert dks[i].dtype == dbs[i].dtype == torch.float32
        _close(dks[i].numpy(), jdks[i], TOL[dtype], f"dW{i + 1}")
        _close(dbs[i].numpy(), jdbs[i], TOL[dtype], f"db{i + 1}")


def test_bwd_reference_matches_jax_vjp_of_the_dense_block():
    f, g, h, w = 16, 8, 12, 20
    x, dy, ks, bs = _operands(42, f, g, h, w)
    params = {f"conv{i + 1}": {"conv": {"kernel": jnp.asarray(k), "bias": jnp.asarray(v)}}
              for i, (k, v) in enumerate(zip(ks, bs))}
    block = JaxRDB(num_feat=f, num_grow_ch=g)
    to_nhwc = lambda a: jnp.asarray(a).reshape(2, f, h, w).transpose(0, 2, 3, 1)  # noqa: E731
    _, vjp = jax.vjp(lambda p, xx: block.apply({"params": p}, xx), params, to_nhwc(x))
    jp, jdx = vjp(to_nhwc(dy))
    dx, dks, dbs = rdb_cm_bwd_reference(*_torch(x, dy, ks, bs, torch.float32), h=h, w=w)
    tol = TOL[torch.float32]
    _close(dx.numpy(), np.asarray(jdx).transpose(0, 3, 1, 2).reshape(2, f, h * w), tol, "dx")
    for i in range(5):
        _close(dks[i].numpy(), jp[f"conv{i + 1}"]["conv"]["kernel"], tol, f"dW{i + 1}")
        _close(dbs[i].numpy(), jp[f"conv{i + 1}"]["conv"]["bias"], tol, f"db{i + 1}")


def test_dense_block_function_on_cpu_matches_autograd_of_the_reference():
    f, g, h, w = 16, 8, 9, 14
    x, dy, ks, bs = _operands(43, f, g, h, w)
    dy = torch.from_numpy(dy)

    def leaves():
        xt = torch.from_numpy(x).requires_grad_()
        weights = [torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().requires_grad_()
                   for k in ks]
        biases = [torch.from_numpy(v).requires_grad_() for v in bs]
        return xt, weights, biases

    xt, weights, biases = leaves()
    (dense_block_ad(xt, weights, biases, h=h, w=w) * dy).sum().backward()
    xr, wr, br = leaves()
    kernels = [wt.permute(2, 3, 1, 0) for wt in wr]
    (rdb_cm_reference(xr, kernels, br, h=h, w=w) * dy).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-4)
    for got, want, what in [(xt, xr, "x")] + [(a, b, f"conv{i + 1}.weight")
                                            for i, (a, b) in enumerate(zip(weights, wr))] + [
            (a, b, f"conv{i + 1}.bias") for i, (a, b) in enumerate(zip(biases, br))]:
        _close(got.grad.numpy(), want.grad.numpy(), tol, what)
    assert fused_rdb_cm_bwd.launches == 0


def test_differentiable_trunk_on_cpu_matches_the_module_trunk():
    f, g, h, w = 16, 8, 10, 12
    gen = torch.Generator().manual_seed(44)
    rrdbs = [RRDBBlock(f, g) for _ in range(2)]
    for m in rrdbs:
        for p in m.parameters():
            with torch.no_grad():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, h, w, f, generator=gen)
    probe = torch.randn(2, h, w, f, generator=gen)
    blocks = [[([c.weight for c in rdb.convs()], [c.bias for c in rdb.convs()])
               for rdb in (m.rdb1, m.rdb2, m.rdb3)] for m in rrdbs]
    xa = x.clone().requires_grad_()
    (fused_rrdb_trunk_cm_ad(blocks, xa) * probe).sum().backward()
    got = [xa.grad] + [p.grad.clone() for m in rrdbs for p in m.parameters()]
    for m in rrdbs:
        m.zero_grad()
    xb = x.clone().requires_grad_()
    t = xb.permute(0, 3, 1, 2)
    for m in rrdbs:
        t = m(t)
    (t.permute(0, 2, 3, 1) * probe).sum().backward()
    want = [xb.grad] + [p.grad for m in rrdbs for p in m.parameters()]
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a.numpy(), b.numpy(), dict(atol=1e-5, rtol=1e-4), f"gradient {i}")


@pytest.mark.parametrize("f,g", [(48, 24), (16, 8)])
def test_bwd_fragments_compute_the_transposed_convs(f, g):
    """Walk K8's packed weights in the kernels' order into per-tap matrices,
    apply them as the kernels do (output pixel q reads each level at q +
    the tap's offset), and hold the result against conv_transpose2d. dx
    (the dx kernel's part): per 16-channel k step of the stack [m1 m2 m3 m4
    d5], per tap, (8 outputs, 8 stack channels) core matrices, outputs
    outer. m1..m4 (the stack kernel's B fragments): taps, levels, 16- then
    8-channel chunks, n8-tiles, lanes, each lane's rows 2t, 2t+1 (, 2t+8,
    2t+9) of column lane/4."""
    rng = np.random.default_rng(45)
    h = w = 5
    ks = [rng.standard_normal((3, 3, f + i * g, g if i < 4 else f)).astype(np.float32)
          for i in range(5)]
    flat = np.concatenate([k.reshape(-1) for k in ks])
    index, offsets = bwd_fragment_index(f, g)
    members = [rng.standard_normal((1, g if i < 4 else f, h, w)).astype(np.float32)
               for i in range(5)]  # the gradients of conv1..conv5
    tig = np.arange(32) % 4
    rows16 = np.stack([2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9], -1)
    cout = [g] * 4 + [f]

    def shifted(member, tap):
        oy, ox = tap // 3 - 1, tap % 3 - 1
        pad = np.pad(member[0], ((0, 0), (1, 1), (1, 1)))
        return pad[:, 1 + oy: 1 + oy + h, 1 + ox: 1 + ox + w]

    for k in range(5):
        nout = f if k == 0 else g
        c0 = 0 if k == 0 else f + (k - 1) * g
        pos = 2 * offsets[k]
        got = np.zeros((nout, h, w), np.float32)
        if k == 0:
            stack = np.concatenate(members, 1)
            for k16 in range((f + 4 * g) // 16):
                for tap in range(9):
                    vals = flat[index[pos: pos + 16 * f]].reshape(f // 8, 2, 8, 8)
                    b = vals.transpose(0, 2, 1, 3).reshape(f, 16)  # (output, stack channel)
                    pos += 16 * f
                    got += np.einsum("cyx,nc->nyx",
                                     shifted(stack, tap)[16 * k16: 16 * k16 + 16], b)
        for tap in range(9 if k else 0):
            for i in range(k, 5):
                sh = shifted(members[i], tap)
                k0 = 0
                while k0 < cout[i]:
                    kw = 4 if k0 + 16 <= cout[i] else 2
                    b = np.zeros((16, g), np.float32)  # rows k0.., the level's columns
                    vals = flat[index[pos: pos + (g // 8) * 32 * kw]].reshape(g // 8, 32, kw)
                    for j in range(g // 8):
                        for lane in range(32):
                            b[rows16[lane, :kw], j * 8 + lane // 4] = vals[j, lane]
                    pos += (g // 8) * 32 * kw
                    n = 16 if kw == 4 else 8
                    got += np.einsum("nyx,nc->cyx", sh[k0:k0 + n], b[:n])
                    k0 += n
        want = sum(F.conv_transpose2d(torch.from_numpy(members[i]),
                                      torch.from_numpy(ks[i]).permute(3, 2, 0, 1), padding=1)
                   [0, c0:c0 + nout].numpy() for i in range(k, 5))
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4, err_msg=f"level {k}")
