"""K10a-b: HAT's overlapping cross-attention block (OCAB) tail for training.

Port of ``superresolution_def_tpu/kernels/ocab_train.py``:

- K10a :func:`ocab_fwd_h` (``_ocab_fwd_h``): K6's tail that also returns
  h = x + proj(cross_attn(q, k, v, bias)) for the backward;
- K10b :func:`ocab_bwd_attn` (``_ocab_bwd_attn``): the cross-attention and
  proj backward from the saved q, k, v windows: dq ``(Bw, 64, C)``, dk and dv
  ``(Bw, nk, C)``, dbias ``(heads, 64, nk)``, dwproj and dbproj.

The MLP + LN2 backward between them is K9b's
(:func:`~.hab_train.hab_bwd_mlp`, no branch scale: OCAB has no drop-path).
On a CUDA tensor each launches its kernel (K10a ``csrc/ocab.cu``, K10b
``csrc/ocab_train.cu``; bf16, 64 queries, an even key count up to 144) or
raises; on a CPU tensor it runs its plain version.

:class:`OcabTailFn` is the JAX ``ocab_tail_ad`` and :func:`ocab_train` the
JAX ``ocab_train``: LN1, the qkv product and the window and overlap gathers
stay PyTorch autograd ops around the tail, as the JAX package leaves them to
XLA, so dq, dk and dv reach the qkv product through the gathers' backward
(which sums the overlaps and drops the out-of-image keys).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops import overlap_windows, relative_position_bias_oca, window_partition, window_reverse
from ._build import load_library
from .hab_train import hab_bwd_mlp
from .ocab import (
    check_ocab_windows,
    launch_ocab,
    ocab_fwd_h_reference,
    pack_ocab_weights,
    pad_ocab_operands,
)
from .swin_block import (
    MAX_SMEM_BYTES,
    _check,
    _colsum,
    _ln_f32,
    _on_cuda,
    _ptrs,
    _rounder,
    _sm_count,
    _softmax_f32,
    _stream,
    _train_library,
    _wgrad,
)


def ocab_fwd_h(x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj, ln2_w, ln2_b,
               w1, b1, w2, b2, *, num_heads: int, scale: float, padded: tuple | None = None,
               packed: torch.Tensor | None = None):
    """K10a: ``(out, h)`` of the OCAB tail over ``(Bw, 64, C)`` query windows.

    CUDA tensors launch the kernel (counted in ``ocab_fwd_h.launches``) or
    raise; CPU tensors take :func:`~.ocab.ocab_fwd_h_reference`. ``padded``:
    the weights already through :func:`~.ocab.pad_ocab_operands`; ``packed``:
    those through :func:`~.ocab.pack_ocab_weights` (without it each call
    packs them).
    """
    args = (x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("ocab_fwd_h", x_windows):
        return ocab_fwd_h_reference(*args, num_heads=num_heads, scale=scale)
    out = launch_ocab("ocab_fwd_h", *args, num_heads=num_heads, scale=scale, padded=padded,
                      packed=packed, store_h=True)
    ocab_fwd_h.launches += 1
    return out


ocab_fwd_h.launches = 0


def ocab_bwd_attn_reference(q_windows, k_windows, v_windows, dh, bias, wproj, *, num_heads: int,
                            scale: float):
    """Plain PyTorch form of K10b, with the TPU kernel's rounding points (its
    per-head branch): ``(dq, dk, dv, dbias, dwproj, dbproj)``, dq/dk/dv in the
    io dtype, the rest fp32 sums over all windows."""
    dt = q_windows.dtype
    bw, nq, c = q_windows.shape
    nk = k_windows.shape[1]
    hd = c // num_heads
    rnd = _rounder(dt)

    def heads(t, n):  # (Bw, n, C) -> (Bw, heads, n, hd) fp32
        return t.float().reshape(bw, n, num_heads, hd).transpose(1, 2)

    def tokens(t):  # (Bw, heads, n, hd) -> (Bw, n, C)
        return t.transpose(1, 2).reshape(bw, -1, c)

    q, k, v = heads(q_windows, nq), heads(k_windows, nk), heads(v_windows, nk)
    qs = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    a = _softmax_f32(torch.matmul(qs, k.transpose(-1, -2)) + bias.float())
    ad = rnd(a)
    dhf = dh.float().reshape(-1, c)
    do = rnd(heads(torch.matmul(rnd(dhf), wproj.float().T).reshape(bw, nq, c), nq))
    attn = tokens(torch.matmul(ad, v)).reshape(-1, c)
    da = torch.matmul(do, v.transpose(-1, -2))
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dq = torch.matmul(rnd(ds), k) * scale
    dk = torch.matmul(rnd(ds).transpose(-1, -2), q) * scale
    dv = torch.matmul(ad.transpose(-1, -2), do)
    return (tokens(dq).to(dt), tokens(dk).to(dt), tokens(dv).to(dt), ds.sum(0),
            torch.matmul(rnd(attn).T, rnd(dhf)), dhf.sum(0))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("ocab_train")
    lib.ocab_bwd_attn_bf16.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.ocab_bwd_attn_bf16.restype = ctypes.c_int
    lib.ocab_bwd_attn_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ocab_bwd_attn_smem_bytes.restype = ctypes.c_size_t
    return lib


def ocab_bwd_attn(q_windows, k_windows, v_windows, dh, bias, wproj, *, num_heads: int,
                  scale: float, padded_wproj: torch.Tensor | None = None):
    """K10b: ``(dq, dk, dv, dbias, dwproj, dbproj)``.

    CUDA tensors launch the kernels (counted in ``ocab_bwd_attn.launches``)
    or raise; CPU tensors take :func:`ocab_bwd_attn_reference`.
    ``padded_wproj``: wproj as :func:`~.ocab.pad_ocab_operands` pads it.
    Four launches: the window kernel (persistent blocks of ``ceil(Bw /
    SMs)`` windows, each summing its windows' ds and dh columns), the
    weight-gradient product and its ordered sum over token slices, and one
    ordered column sum over the blocks for dbias and dbproj.
    """
    if not _on_cuda("ocab_bwd_attn", q_windows):
        return ocab_bwd_attn_reference(q_windows, k_windows, v_windows, dh, bias, wproj,
                                       num_heads=num_heads, scale=scale)
    name = "ocab_bwd_attn"
    bw, nq, nk, c = check_ocab_windows(name, dh, q_windows, k_windows, v_windows)
    cp = -(-c // 16) * 16
    hd = c // num_heads
    if c % num_heads or hd > 32 or cp > 256:
        raise ValueError(f"{name}: unsupported width C={c} with {num_heads} heads")
    if tuple(wproj.shape) != (c, c) or wproj.dtype != torch.bfloat16:
        raise ValueError(f"{name}: wproj wants bfloat16 {(c, c)}, got {wproj.dtype} "
                         f"{tuple(wproj.shape)}")
    if tuple(bias.shape) != (num_heads, nq, nk):
        raise ValueError(f"{name}: bias wants {(num_heads, nq, nk)}, got {tuple(bias.shape)}")
    if any(t.device != q_windows.device for t in (k_windows, v_windows, dh, bias, wproj)):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    lib, train_lib = _library(), _train_library()
    if lib.ocab_bwd_attn_smem_bytes(cp, hd) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")
    if padded_wproj is None:
        padded_wproj = F.pad(wproj, (0, cp - c, 0, cp - c)).contiguous()
    # the kernel copies pairs of channels (4 bytes): rows of an even width
    # (a zero channel after an odd C), 4-byte aligned
    ld = c + c % 2
    q, k, v, dh = (F.pad(t, (0, ld - c)) if ld != c else t.contiguous()
                   for t in (q_windows, k_windows, v_windows, dh))
    q, k, v, dh = (t.clone() if t.data_ptr() % 4 else t for t in (q, k, v, dh))
    bias = bias.float().contiguous()
    wpb = -(-bw // _sm_count(q.device.index))
    grid = -(-bw // wpb)
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    att, dhp = (torch.empty(bw * nq, cp, dtype=torch.bfloat16, device=q.device)
                for _ in range(2))
    nbias = num_heads * nq * nk
    part = torch.empty(grid, nbias + cp, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _check(lib.ocab_bwd_attn_bf16(*_ptrs(q, k, v, dh, bias, padded_wproj, dq, dk, dv, att,
                                             dhp, part), bw, wpb, nk, cp, ld, num_heads, hd,
                                      float(scale), _stream(q.device)), "ocab_bwd_attn_bf16")
        dwproj = _wgrad(train_lib, att, dhp)[:c, :c]
        sums = _colsum(train_lib, part)
    if ld != c:
        dq, dk, dv = (t[..., :c].contiguous() for t in (dq, dk, dv))
    ocab_bwd_attn.launches += 1
    return dq, dk, dv, sums[:nbias].reshape(num_heads, nq, nk), dwproj, sums[nbias:nbias + c]


ocab_bwd_attn.launches = 0


class OcabTailFn(torch.autograd.Function):
    """The OCAB tail with K10a forward and K9b + K10b backward (the JAX
    ``ocab_tail_ad``). Inputs as :func:`ocab_fwd_h`'s, then ``num_heads``,
    ``scale``, ``padded`` (the weights through
    :func:`~.ocab.pad_ocab_operands`, or ``None``) and, optionally,
    ``packed`` (those through :func:`~.ocab.pack_ocab_weights`). dx = dh:
    the shortcut passes the MLP backward's output through. Each gradient
    comes back in its input's dtype, as ``_ocab_ad_bwd`` casts it."""

    @staticmethod
    def forward(ctx, x, q, k, v, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, num_heads,
                scale, padded, packed=None):
        params = (bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
        out, h = ocab_fwd_h(x, q, k, v, *params, num_heads=num_heads, scale=scale,
                            padded=padded, packed=packed)
        ctx.save_for_backward(q, k, v, h, bias, wproj, ln2_w, ln2_b, w1, b1, w2)
        ctx.dtypes = [t.dtype for t in (q, k, v, *params)]
        ctx.num_heads, ctx.scale, ctx.padded = num_heads, scale, padded
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, h, bias, wproj, ln2_w, ln2_b, w1, b1, w2 = ctx.saved_tensors
        padded = ctx.padded
        dh, dln2_w, dln2_b, dw1, db1, dw2, db2 = hab_bwd_mlp(
            h, dout.contiguous(), None, ln2_w, ln2_b, w1, b1, w2,
            padded=padded and padded[2:7])
        dq, dk, dv, dbias, dwproj, dbproj = ocab_bwd_attn(
            q, k, v, dh, bias, wproj, num_heads=ctx.num_heads, scale=ctx.scale,
            padded_wproj=padded and padded[0])
        grads = (dq, dk, dv, dbias, dwproj, dbproj, dln2_w, dln2_b, dw1, db1, dw2, db2)
        return (dh, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None, None, None)


def ocab_train(oc, x: torch.Tensor, *, dtype: torch.dtype, padded: tuple | None = None,
               packed: torch.Tensor | None = None):
    """One differentiable OCAB of the ``nn.Module`` ``oc`` over NHWC ``x``
    (in ``dtype``) with the tail through :class:`OcabTailFn` (the JAX
    ``ocab_train``): LN1 (fp32 statistics), the qkv product with its weight
    and bias cast to ``dtype``, the window and overlap gathers and the
    relative-position bias gather as autograd ops, and the tail's weights
    cast inside autograd (``(in, out)`` in ``dtype``, vectors fp32), so
    every gradient reaches ``oc``'s parameters. ``padded``, ``packed``: the
    tail's weights through :func:`~.ocab.pad_ocab_operands` and
    :func:`~.ocab.pack_ocab_weights`, for the kernels."""
    b, h, w, c = x.shape
    ws = oc.window_size
    n = ws * ws
    heads = oc.num_heads
    xn = _ln_f32(x, oc.norm1.weight, oc.norm1.bias).to(x.dtype)
    qkv = F.linear(xn, oc.qkv.weight.to(dtype), oc.qkv.bias.to(dtype))
    kv = overlap_windows(qkv[..., c:], ws, oc.overlap_win_size)
    bias = relative_position_bias_oca(oc.relative_position_bias_table, ws,
                                      oc.overlap_ratio).float()
    out = OcabTailFn.apply(
        window_partition(x, ws).reshape(-1, n, c),
        window_partition(qkv[..., :c], ws).reshape(-1, n, c),
        kv[..., :c].contiguous(), kv[..., c:].contiguous(), bias,
        oc.proj.weight.T.to(dtype), oc.proj.bias.float(), oc.norm2.weight.float(),
        oc.norm2.bias.float(), oc.mlp.fc1.weight.T.to(dtype), oc.mlp.fc1.bias.float(),
        oc.mlp.fc2.weight.T.to(dtype), oc.mlp.fc2.bias.float(), heads, (c // heads) ** -0.5,
        padded, packed)
    return window_reverse(out.reshape(-1, ws, ws, c), ws, h, w)


def ocab_operands(oc, dtype: torch.dtype) -> tuple:
    """``(padded, packed)``: the tail's weights of ``oc`` through
    :func:`~.ocab.pad_ocab_operands` and :func:`~.ocab.pack_ocab_weights`,
    for :func:`ocab_train` (no autograd)."""
    with torch.no_grad():
        padded = pad_ocab_operands(oc.proj.weight.T.to(dtype), oc.proj.bias, oc.norm2.weight,
                                   oc.norm2.bias, oc.mlp.fc1.weight.T.to(dtype),
                                   oc.mlp.fc1.bias, oc.mlp.fc2.weight.T.to(dtype),
                                   oc.mlp.fc2.bias)
        return padded, pack_ocab_weights(padded, num_heads=oc.num_heads,
                                         channels=oc.proj.weight.shape[0])
