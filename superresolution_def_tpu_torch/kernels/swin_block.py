"""Fused Swin transformer block: forward and backward as hand-written Hopper kernels.

Port of ``superresolution_def_tpu/kernels/swin_block.py``:

- K1 :func:`fused_swin_block` (``fused_swin_block``), the inference block;
- K2 :func:`swin_block_fwd_h` (``fused_swin_block_fwd_h``), the same block's
  function that also returns h = x + proj(attn) for the backward; K1 and K2
  are two instantiations of one wgmma kernel (``csrc/swin_fwd_wg.cuh``) on
  weights packed by :func:`pack_swin_block_weights`;
- K3 :func:`swin_block_bwd_mlp` (``_bwd_mlp``), the LN2 + MLP backward from h;
- K4 :func:`swin_block_bwd_attn` (``_bwd_attn``), the attention + LN1 backward;
- K4b :func:`swin_block_bwd` (``fused_swin_block_bwd``), the whole block's
  backward from x and dout alone, the forward recomputed: three phases on
  K2's, K3's and K4's wgmma kernels (``csrc/swin_block_bwd.cu``), whose plain
  forms are :func:`swin_block_h_reference`, :func:`swin_block_bwd_mlp_reference`
  on the fp32 h and :func:`swin_block_bwd_attn_reference` on the fp32 dh.

They keep the JAX argument layout: pre-rolled, pre-partitioned windows
``(Bw, N, C)``, weights ``(in, out)``, and the relative-position bias gathered
into ``(heads, N, N)`` fp32. On a CUDA tensor each launches its kernel
(``csrc/swin_block.cu`` for K1/K2, ``csrc/swin_block_train.cu`` for K3/K4,
``csrc/swin_block_bwd.cu`` for K4b; bf16 only, N = 64) or raises; on a CPU tensor it runs its plain
version (``swin_block_*_reference``), the same math in plain PyTorch with the
same rounding points. Weight, bias and LayerNorm gradients come back as fp32 sums
over all windows.

:class:`FusedSwinBlockFn` ties K2, K3 and K4 into one autograd node (the JAX
``fused_swin_block_ad``); :class:`FusedSwinBlockRecomputeFn` ties K1 and K4b
into another, which keeps only x for the backward. :func:`make_fused_swinir`
is the twin of the JAX ``make_fused_swinir``: the SwinIR forward with every
transformer block through the fused block, the rolls and window
partition/reverse as one row gather each way around it, and the conv head
and tail left to PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import torch
import torch.nn.functional as F

from ..ops import pixel_shuffle, relative_position_bias, window_partition
from ._build import load_library

# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
EPS = 1e-5


def _ln_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (eps 1e-5)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + EPS) * weight.float() + bias.float()


def _ln_parts(x: torch.Tensor):
    """fp32 (xhat, 1/std) of a LayerNorm over the last axis."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + EPS)
    return (xf - mu) * rstd, rstd


def _ln_backward(dxn, xhat, rstd, weight):
    """Gradient at a LayerNorm's input from the gradient at its output."""
    dxh = dxn * weight.float()
    return rstd * (dxh - dxh.mean(-1, keepdim=True)
                   - xhat * (dxh * xhat).mean(-1, keepdim=True))


def _gelu(u: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """tanh GELU for bf16 io, exact erf GELU otherwise (the JAX kernels' choice)."""
    return F.gelu(u, approximate="tanh" if dt == torch.bfloat16 else "none")


def _gelu_grad(u: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """d gelu(u) / du for the variant :func:`_gelu` picks."""
    if dt == torch.bfloat16:
        t = torch.tanh(0.7978845608028654 * (u + 0.044715 * u * u * u))
        ds = 0.7978845608028654 * (1.0 + 3.0 * 0.044715 * u * u)
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * ds
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return 0.5 * (1.0 + torch.erf(u * 2.0**-0.5)) + u * phi


def _rounder(dt: torch.dtype):
    def rnd(t):  # round to the io dtype, keep computing in fp32
        return t.to(dt).float()
    return rnd


def _qkv_heads(xn, wqkv, bqkv, num_heads, rnd):
    """q, k, v as (Bw, heads, N, hd), rounded to the io dtype."""
    bw, n, c = xn.shape
    qkv = rnd(torch.matmul(xn, wqkv.float()) + bqkv.float())
    qkv = qkv.reshape(bw, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _softmax_f32(s):
    s = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return s / s.sum(dim=-1, keepdim=True)


def swin_block_h_reference(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, *,
                           num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch form of K4b's first phase, the recompute to h: K2's
    forward up to h = x + (proj + bproj), returned in fp32 ``(Bw, N, C)``
    without K2's rounding to the io dtype."""
    dt = x.dtype
    bw, n, c = x.shape
    rnd = _rounder(dt)
    xf = x.float()
    q, k, v = _qkv_heads(rnd(_ln_f32(xf, ln1_w, ln1_b)), wqkv, bqkv, num_heads, rnd)
    q = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    p = _softmax_f32(torch.matmul(q, k.transpose(-1, -2)) + bias.float())
    o = torch.matmul(rnd(p), v).permute(0, 2, 1, 3).reshape(bw, n, c)
    return xf + (torch.matmul(rnd(o), wproj.float()) + bproj.float())


def swin_block_fwd_h_reference(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K2: ``(out, h)``, both in the io dtype.

    Products take their operands as stored (rounded to the io dtype) and sum
    in fp32; LayerNorm, softmax and both residuals stay fp32; LN2 reads h
    rounded to the io dtype, as K1 does, and that is the h returned. bf16 io
    uses the tanh GELU and fp32 io the exact erf GELU, as the JAX kernel does.
    """
    dt = x_windows.dtype
    rnd = _rounder(dt)
    h = swin_block_h_reference(x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
                               num_heads=num_heads, scale=scale)
    m = _gelu(torch.matmul(rnd(_ln_f32(rnd(h), ln2_w, ln2_b)), w1.float()) + b1.float(), dt)
    m = torch.matmul(rnd(m), w2.float()) + b2.float()
    return (h + m).to(dt), h.to(dt)


def swin_block_reference(*args, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch form of K1: the ``out`` of :func:`swin_block_fwd_h_reference`."""
    return swin_block_fwd_h_reference(*args, num_heads=num_heads, scale=scale)[0]


def _branch_scale(dp, bw: int):
    """A per-window branch scale ``(Bw,)`` as a factor of ``(Bw, N, C)``, or 1."""
    return 1.0 if dp is None else dp.float().reshape(bw, 1, 1)


def swin_block_bwd_mlp_reference(h, dout, ln2_w, ln2_b, w1, b1, w2, *, dp=None):
    """Plain PyTorch form of K3 (and of K9b with ``dp``), with the TPU
    kernel's rounding points.

    Returns ``(dh, dln2_w, dln2_b, dw1, db1, dw2, db2)``: dh in h's dtype,
    the rest fp32 sums over all windows. ``dp``: the MLP branch's scale per
    window ``(Bw,)``; the cotangent entering the branch is ``dp * dout`` while
    dh's residual term is ``dout`` itself. The io dtype is dout's: an fp32 h
    with a bf16 dout is K4b's MLP phase, LN2 of the fp32 h and dh kept fp32.
    """
    dt = dout.dtype
    c = h.shape[-1]
    rnd = _rounder(dt)
    xhat, rstd = _ln_parts(h)
    hn = rnd(xhat * ln2_w.float() + ln2_b.float()).reshape(-1, c)
    u = torch.matmul(hn, w1.float()) + b1.float()
    g = rnd(_gelu(u, dt))
    dm = (dout.float() * _branch_scale(dp, h.shape[0])).reshape(-1, c)
    dw2 = torch.matmul(g.T, rnd(dm))
    du = torch.matmul(rnd(dm), w2.float().T) * _gelu_grad(u, dt)
    dw1 = torch.matmul(hn.T, rnd(du))
    dhn = torch.matmul(rnd(du), w1.float().T).reshape(h.shape)
    dh = _ln_backward(dhn, xhat, rstd, ln2_w) + dout.float()
    return (dh.to(h.dtype), (dhn * xhat).sum((0, 1)), dhn.sum((0, 1)), dw1, du.sum(0), dw2,
            dm.sum(0))


def swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, *,
                                  num_heads: int, scale: float, mask=None, dp=None):
    """Plain PyTorch form of K4 (the TPU kernel's per-head branch), and of
    K9c with ``mask`` and ``dp``.

    Returns ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj)``: dx
    in the io dtype, the rest fp32 sums over all windows. ``mask``: the
    ``(nW, N, N)`` shift mask, window w adding ``mask[w mod nW]`` to its
    scores; ``dp``: the attention branch's scale per window ``(Bw,)``, which
    scales the cotangent entering the branch but not dx's residual term. The
    io dtype is x's: an fp32 dh with bf16 x is K4b's attention phase, do and
    dWproj on bf16(dh), dbproj and dx's residual on the fp32 dh.
    """
    dt = x.dtype
    bw, n, c = x.shape
    hd = c // num_heads
    rnd = _rounder(dt)
    xhat, rstd = _ln_parts(x)
    xn = rnd(xhat * ln1_w.float() + ln1_b.float())
    q, k, v = _qkv_heads(xn, wqkv, bqkv, num_heads, rnd)
    qs = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    s = torch.matmul(qs, k.transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, num_heads, n, n) + mask.float()[None, :, None]).reshape(
            bw, num_heads, n, n)
    a = _softmax_f32(s)
    ad = rnd(a)
    dhf = (dh.float() * _branch_scale(dp, bw)).reshape(-1, c)

    def heads(t):  # (Bw, N, C) -> (Bw, heads, N, hd)
        return t.reshape(bw, n, num_heads, hd).transpose(1, 2)

    def tokens(t):  # (Bw, heads, N, hd) -> (Bw * N, C)
        return t.transpose(1, 2).reshape(-1, c)

    do = rnd(heads(torch.matmul(rnd(dhf), wproj.float().T).reshape(bw, n, c)))
    attn = tokens(torch.matmul(ad, v))
    dv = torch.matmul(ad.transpose(-1, -2), do)
    da = torch.matmul(do, v.transpose(-1, -2))
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dq = torch.matmul(rnd(ds), k) * scale
    dk = torch.matmul(rnd(ds).transpose(-1, -2), q) * scale
    dqkv = torch.cat([tokens(dq), tokens(dk), tokens(dv)], dim=-1)
    x2d = xn.reshape(-1, c)
    dxn = torch.matmul(rnd(dqkv), wqkv.float().T).reshape(bw, n, c)
    dx = _ln_backward(dxn, xhat, rstd, ln1_w) + dh.float()
    return (dx.to(dt), (dxn * xhat).sum((0, 1)), dxn.sum((0, 1)),
            torch.matmul(x2d.T, rnd(dqkv)), dqkv.sum(0), ds.sum(0),
            torch.matmul(rnd(attn).T, rnd(dhf)), dhf.sum(0))


def swin_block_bwd_reference(x, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w,
                             ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float):
    """Plain PyTorch form of K4b, with the TPU kernel's rounding points.

    Returns ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj, dln2_w,
    dln2_b, dw1, db1, dw2, db2)``: dx in the io dtype, the rest fp32 sums over
    all windows. It recomputes the forward from x and differs from K2 + K3 +
    K4 where ``_make_bwd_kernel`` does: LN2's statistics come from the fp32 h
    (K3 reads K2's bf16 h), and dh stays fp32 into dbproj and dx's residual
    (K3 rounds it for K4); only do's and dWproj's operands are bf16(dh). b2
    does not enter the gradients; it is taken for the JAX argument list.
    The kernel's three phases compose to it: :func:`swin_block_h_reference`,
    then :func:`swin_block_bwd_mlp_reference` on that fp32 h, then
    :func:`swin_block_bwd_attn_reference` on the fp32 dh.
    """
    dt = x.dtype
    bw, n, c = x.shape
    hd = c // num_heads
    rnd = _rounder(dt)

    def heads(t):  # (Bw * N, C) -> (Bw, heads, N, hd)
        return t.reshape(bw, n, num_heads, hd).transpose(1, 2)

    def tokens(t):  # (Bw, heads, N, hd) -> (Bw * N, C)
        return t.transpose(1, 2).reshape(-1, c)

    # the forward, recomputed: h and its LayerNorm in fp32
    xhat1, rstd1 = _ln_parts(x)
    xn = rnd(xhat1 * ln1_w.float() + ln1_b.float())
    q, k, v = _qkv_heads(xn, wqkv, bqkv, num_heads, rnd)
    qs = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    a = _softmax_f32(torch.matmul(qs, k.transpose(-1, -2)) + bias.float())
    ad = rnd(a)
    attn = rnd(tokens(torch.matmul(ad, v)))
    h = x.float().reshape(-1, c) + torch.matmul(attn, wproj.float()) + bproj.float()
    xhat2, rstd2 = _ln_parts(h)
    hn = rnd(xhat2 * ln2_w.float() + ln2_b.float())
    u = torch.matmul(hn, w1.float()) + b1.float()
    g = rnd(_gelu(u, dt))

    # the MLP and LN2 backward; dh stays fp32
    dm = dout.float().reshape(-1, c)
    du = torch.matmul(rnd(dm), w2.float().T) * _gelu_grad(u, dt)
    dhn = torch.matmul(rnd(du), w1.float().T)
    dh = _ln_backward(dhn, xhat2, rstd2, ln2_w) + dm

    # proj, attention and LN1 backward
    do = rnd(heads(torch.matmul(rnd(dh), wproj.float().T)))
    dv = torch.matmul(ad.transpose(-1, -2), do)
    da = torch.matmul(do, v.transpose(-1, -2))
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dq = torch.matmul(rnd(ds), k) * scale
    dk = torch.matmul(rnd(ds).transpose(-1, -2), q) * scale
    dqkv = torch.cat([tokens(dq), tokens(dk), tokens(dv)], dim=-1)
    dxn = torch.matmul(rnd(dqkv), wqkv.float().T).reshape(bw, n, c)
    dx = _ln_backward(dxn, xhat1, rstd1, ln1_w) + dh.reshape(bw, n, c)
    return (dx.to(dt), (dxn * xhat1).sum((0, 1)), dxn.sum((0, 1)),
            torch.matmul(xn.reshape(-1, c).T, rnd(dqkv)), dqkv.sum(0), ds.sum(0),
            torch.matmul(attn.T, rnd(dh)), dh.sum(0), (dhn * xhat2).sum(0), dhn.sum(0),
            torch.matmul(hn.T, rnd(du)), du.sum(0), torch.matmul(g.T, rnd(dm)), dm.sum(0))


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("swin_block")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_block_pack_bf16.argtypes = [vp] * 4 + [i32] * 3 + [vp, vp]
    lib.swin_block_bf16.argtypes = [vp] * 12 + [i32] * 4 + [ctypes.c_float, i32, vp]
    lib.swin_block_fwd_h_bf16.argtypes = [vp] * 17 + [i32] * 4 + [ctypes.c_float, vp]
    for fn in (lib.swin_block_pack_bf16, lib.swin_block_bf16, lib.swin_block_fwd_h_bf16,
               lib.swin_block_windows):
        fn.restype = ctypes.c_int
    for fn in (lib.swin_block_pack_elems, lib.swin_block_smem_bytes, lib.swin_block_windows):
        fn.argtypes = [i32] * 3
    lib.swin_block_pack_elems.restype = ctypes.c_size_t
    lib.swin_block_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _train_library() -> ctypes.CDLL:
    lib = load_library("swin_block_train")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_bwd_mlp_bf16.argtypes = [vp] * 13 + [i32] * 3 + [vp]
    lib.swin_bwd_attn_bf16.argtypes = [vp] * 14 + [i32] * 4 + [ctypes.c_float, vp]
    lib.swin_bwd_attn_pack_bf16.argtypes = [vp, vp, i32, i32, vp, vp]
    lib.swin_wgrad_bf16.argtypes = [vp, vp] + [i32] * 5 + [vp, vp]
    lib.swin_colsum_f32.argtypes = [vp, i32, i32, vp, vp]
    lib.swin_colsum_gather_f32.argtypes = [vp, i32, i32, vp, i32, vp, vp]
    lib.hab_bwd_mlp_bf16.argtypes = [vp] * 15 + [i32] * 4 + [vp]
    lib.hab_bwd_attn_bf16.argtypes = [vp] * 17 + [i32] * 6 + [ctypes.c_float, vp]
    for fn in (lib.swin_bwd_mlp_bf16, lib.swin_bwd_attn_bf16, lib.swin_bwd_attn_pack_bf16,
               lib.swin_wgrad_bf16, lib.swin_colsum_f32, lib.swin_colsum_gather_f32,
               lib.hab_bwd_mlp_bf16, lib.hab_bwd_attn_bf16, lib.swin_bwd_attn_windows):
        fn.restype = ctypes.c_int
    lib.swin_bwd_mlp_smem_bytes.argtypes = [i32, i32]
    lib.swin_bwd_attn_windows.argtypes = [i32, i32]
    lib.swin_bwd_attn_smem_bytes.argtypes = [i32, i32]
    lib.swin_bwd_attn_pack_bytes.argtypes = [i32, i32]
    lib.swin_bwd_attn_pack_bytes.restype = ctypes.c_size_t
    lib.swin_bwd_mlp_smem_bytes.restype = ctypes.c_size_t
    lib.swin_bwd_mlp_pack_bytes.argtypes = [i32, i32]
    lib.swin_bwd_mlp_pack_bytes.restype = ctypes.c_size_t
    lib.swin_wgrad_smem_bytes.argtypes = []
    lib.swin_wgrad_smem_bytes.restype = ctypes.c_size_t
    lib.swin_bwd_attn_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library("swin_block_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_bwd_block_bf16.argtypes = [vp] * 28 + [i32] * 5 + [ctypes.c_float, vp]
    lib.swin_bwd_block_bf16.restype = ctypes.c_int
    lib.swin_bwd_block_smem_bytes.argtypes = [i32] * 3
    lib.swin_bwd_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_windows(name: str, *windows: torch.Tensor) -> tuple[int, int, int]:
    bw, n, c = windows[0].shape
    for w in windows:
        if w.dtype != torch.bfloat16:
            raise TypeError(f"{name} on CUDA takes bfloat16 windows, got {w.dtype}")
        if tuple(w.shape) != (bw, n, c):
            raise ValueError(f"{name}: windows of shapes {[tuple(v.shape) for v in windows]}")
    if n != 64:
        raise ValueError(f"{name} on CUDA takes 8x8 windows (N=64), got N={n}")
    return bw, n, c


def _check_heads(name: str, c: int, num_heads: int) -> None:
    hd = c // num_heads
    # a head pair's q/k/v columns and the weight rows are copied as 8-byte vectors
    if c % num_heads or hd > 32 or hd % 2 or (num_heads % 2 and hd % 4) or c > 256 or c % 4:
        raise ValueError(f"{name}: unsupported width C={c} with {num_heads} heads")


def _check_operands(name: str, device, weights: dict, want: dict, vectors: dict,
                    sizes: dict, others=()) -> None:
    for key, w in weights.items():
        if tuple(w.shape) != want[key] or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} wants bfloat16 {want[key]}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    for key, v in vectors.items():
        if tuple(v.shape) != (sizes[key],):
            raise ValueError(f"{name}: {key} wants ({sizes[key]},), got {tuple(v.shape)}")
    for t in (*weights.values(), *vectors.values(), *others):
        if t.device != device:
            raise ValueError(f"{name}: every operand must be on the windows' device")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous fp32, itself when it is already."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _ptrs(*tensors) -> list[int]:
    return [t.data_ptr() for t in tensors]


def _checked_block_operands(name, x, vectors, weights, bias, num_heads, smem_bytes, others=()):
    """Checks one block's operands for a window kernel and returns them ready
    to launch: x and the weights contiguous, the vectors and the bias table
    fp32. ``smem_bytes(c, hidden)`` is the kernel's shared-memory need."""
    bw, n, c = _check_windows(name, x)
    hidden = weights["w1"].shape[1]
    _check_heads(name, c, num_heads)
    if hidden % 4:
        raise ValueError(f"{name}: unsupported hidden width {hidden}")
    want = {"wqkv": (c, 3 * c), "wproj": (c, c), "w1": (c, hidden), "w2": (hidden, c)}
    sizes = {"ln1_w": c, "ln1_b": c, "bqkv": 3 * c, "bproj": c, "ln2_w": c, "ln2_b": c,
             "b1": hidden, "b2": c}
    _check_operands(name, x.device, weights, want, vectors, sizes, (bias, *others))
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"{name}: bias wants {(num_heads, n, n)}, got {tuple(bias.shape)}")
    if smem_bytes(c, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c}, hidden={hidden} need more than 227 KB shared memory")
    x = x.contiguous()
    w = {k: v.contiguous() for k, v in weights.items()}
    if any(t.data_ptr() % 8 for t in w.values()) or x.data_ptr() % 16:
        raise ValueError(f"{name}: windows must be 16-byte, weights 8-byte aligned")
    f32 = {k: v.float().contiguous() for k, v in vectors.items()}
    return x, w, f32, bias.float().contiguous()


def _check_packed(name: str, packed: torch.Tensor, device, elems: int) -> torch.Tensor:
    if (packed.dtype != torch.bfloat16 or packed.device != device or packed.dim() != 1
            or packed.numel() != elems or not packed.is_contiguous() or packed.data_ptr() % 16):
        raise ValueError(f"{name}: packed wants a contiguous 16-byte aligned bfloat16 ({elems},) "
                         f"on the windows' device, got {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    return packed


def _pack_on_card(name: str, pack, elems: int, wqkv, wproj, w1, w2, num_heads: int):
    """The four weights packed by the C entry ``pack`` into a new bf16
    tensor of ``elems`` (two launches on the current stream)."""
    c, hidden = w1.shape
    want = {"wqkv": (c, 3 * c), "wproj": (c, c), "w1": (c, hidden), "w2": (hidden, c)}
    weights = dict(wqkv=wqkv, wproj=wproj, w1=w1, w2=w2)
    _check_operands(name, wqkv.device, weights, want, {}, {})
    _check_heads(name, c, num_heads)
    w = [t.contiguous() for t in weights.values()]
    out = torch.empty(elems, dtype=torch.bfloat16, device=wqkv.device)
    with torch.cuda.device(wqkv.device):
        _check(pack(*_ptrs(*w), c, num_heads, hidden, out.data_ptr(), _stream(wqkv.device)),
               pack.__name__)
    return out


def pack_swin_block_weights(wqkv, wproj, w1, w2, *, num_heads: int) -> torch.Tensor:
    """K1's and K2's weights packed for the wgmma kernel: a flat bf16 tensor,
    :func:`attn_pack_reference`'s tiles then :func:`mlp_pack_reference`'s.

    On CUDA the two packing kernels build it (``attn_pack_kernel``,
    ``mlp_pack_kernel``); on the CPU the plain forms do. A caller that runs
    frozen weights often packs once and passes the result to
    :func:`fused_swin_block` as ``packed``: about 0.9 MB a block at the
    flagship widths (C = 180, 6 heads, hidden 720), 32 MB for SwinIR's 36.
    """
    if not _on_cuda("pack_swin_block_weights", wqkv):
        return torch.cat([attn_pack_reference(wqkv, wproj, num_heads),
                          mlp_pack_reference(w1, w2)])
    lib = _kernel_library()
    c, hidden = w1.shape
    return _pack_on_card("pack_swin_block_weights", lib.swin_block_pack_bf16,
                         lib.swin_block_pack_elems(c, num_heads, hidden), wqkv, wproj, w1, w2,
                         num_heads)


def _launch_forward(x, vectors, weights, bias, num_heads, scale, store_h, packed=None,
                    windows=0):
    """Launches K2 (``store_h``: packing the weights first) or K1 (on
    ``packed``, or on weights it packs first). ``windows``: K1's windows a
    block, 1 or 2 (0: as many as fit)."""
    name = "swin_block_fwd_h" if store_h else "fused_swin_block"
    lib = _kernel_library()
    x, w, f32, bias = _checked_block_operands(
        name, x, vectors, weights, bias, num_heads,
        lambda c, hidden: lib.swin_block_smem_bytes(c, num_heads, hidden))
    bw, _, c = x.shape
    hidden = w["w1"].shape[1]
    elems = lib.swin_block_pack_elems(c, num_heads, hidden)
    out = torch.empty_like(x)
    vec = [f32[k].data_ptr() for k in ("ln1_w", "ln1_b")]
    with torch.cuda.device(x.device):
        if store_h:  # h, and the scratch K2 packs its weights into
            h = torch.empty_like(x)
            wpack = torch.empty(elems, dtype=torch.bfloat16, device=x.device)
            _check(lib.swin_block_fwd_h_bf16(
                x.data_ptr(), *vec, w["wqkv"].data_ptr(), f32["bqkv"].data_ptr(),
                bias.data_ptr(), w["wproj"].data_ptr(), f32["bproj"].data_ptr(),
                f32["ln2_w"].data_ptr(), f32["ln2_b"].data_ptr(), w["w1"].data_ptr(),
                f32["b1"].data_ptr(), w["w2"].data_ptr(), f32["b2"].data_ptr(), out.data_ptr(),
                h.data_ptr(), wpack.data_ptr(), bw, c, num_heads, hidden, float(scale),
                _stream(x.device)), "swin_block_fwd_h_bf16")
            return out, h
        if packed is None:
            packed = _pack_on_card(name, lib.swin_block_pack_bf16, elems, w["wqkv"],
                                   w["wproj"], w["w1"], w["w2"], num_heads)
        packed = _check_packed(name, packed, x.device, elems)
        _check(lib.swin_block_bf16(
            x.data_ptr(), *vec, f32["bqkv"].data_ptr(), bias.data_ptr(), f32["bproj"].data_ptr(),
            f32["ln2_w"].data_ptr(), f32["ln2_b"].data_ptr(), f32["b1"].data_ptr(),
            f32["b2"].data_ptr(), packed.data_ptr(), out.data_ptr(), bw, c, num_heads, hidden,
            float(scale), windows, _stream(x.device)), "swin_block_bf16")
    return out


def _block_dicts(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2):
    vectors = dict(ln1_w=ln1_w, ln1_b=ln1_b, bqkv=bqkv, bproj=bproj, ln2_w=ln2_w, ln2_b=ln2_b,
                   b1=b1, b2=b2)
    return vectors, dict(wqkv=wqkv, wproj=wproj, w1=w1, w2=w2)


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (take the plain version), True for CUDA, else raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return True


def fused_swin_block(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float, packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1: one Swin block over ``(Bw, N, C)`` windows -> ``(Bw, N, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_swin_block.launches``) or raise; CPU tensors take
    :func:`swin_block_reference`. ``packed``: the weights already through
    :func:`pack_swin_block_weights` (the kernel reads them from there; the
    others are still checked); without it each call packs them first.
    """
    args = (x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("fused_swin_block", x_windows):
        return swin_block_reference(*args, num_heads=num_heads, scale=scale)
    vectors, weights = _block_dicts(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                                    w1, b1, w2, b2)
    out = _launch_forward(x_windows, vectors, weights, bias, num_heads, scale, store_h=False,
                          packed=packed)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def swin_block_fwd_h(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(out, h)``; ``out`` is K1's function, h = x + proj(attn) in the
    io dtype.

    CUDA tensors launch the kernel (counted in ``swin_block_fwd_h.launches``)
    or raise; CPU tensors take :func:`swin_block_fwd_h_reference`. It runs
    K1's wgmma kernel (``csrc/swin_fwd_wg.cuh``) with the store of h, and
    packs the live weights on every call.
    """
    args = (x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("swin_block_fwd_h", x_windows):
        return swin_block_fwd_h_reference(*args, num_heads=num_heads, scale=scale)
    vectors, weights = _block_dicts(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                                    w1, b1, w2, b2)
    out = _launch_forward(x_windows, vectors, weights, bias, num_heads, scale, store_h=True)
    swin_block_fwd_h.launches += 1
    return out


swin_block_fwd_h.launches = 0


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _colsum_into(lib, x: int, r: int, n: int, out: int, keep: torch.Tensor | None,
                 stream: int) -> None:
    """Launches the ordered column sums of the (r, n) fp32 rows at pointer x
    into out; ``keep`` (int32 column indices): only those columns, in its
    order."""
    if keep is None:
        _check(lib.swin_colsum_f32(x, r, n, out, stream), "swin_colsum_f32")
    else:
        _check(lib.swin_colsum_gather_f32(x, r, n, keep.data_ptr(), keep.numel(), out, stream),
               "swin_colsum_gather_f32")


def _colsum(lib, x: torch.Tensor) -> torch.Tensor:
    """Column sums of a (R, n) fp32 tensor in a fixed order (one launch)."""
    r, n = x.shape
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    _colsum_into(lib, x.data_ptr(), r, n, out.data_ptr(), None, _stream(x.device))
    return out


def _wgrad_slices(t: int, m: int, n: int, sms: int) -> tuple[int, int]:
    """(tokens a slice, slices) of the weight-gradient product over t tokens:
    whole 64-token slabs, about one thread block (a 192 x 192 output tile)
    per SM."""
    tiles = -(-m // 192) * -(-n // 192)
    splits = max(1, min(-(-t // 64), -(-sms // tiles)))
    rps = -(-t // (splits * 64)) * 64
    return rps, -(-t // rps)


def _wgrad_into(lib, a: int, b: int, t: int, m: int, n: int, part: int, out: int,
                keep: torch.Tensor | None, sms: int, stream: int) -> None:
    """Launches a^T . b (fp32) for bf16 token-major operands at pointers a (t,
    m) and b (t, n): the slices' partial products into ``part``
    (:func:`_wgrad_slices` rows of m * n fp32), then their sums in slice
    order into ``out`` (m * n, or ``keep``'s entries of the flattened
    product)."""
    rps, splits = _wgrad_slices(t, m, n, sms)
    _check(lib.swin_wgrad_bf16(a, b, t, m, n, rps, splits, part, stream), "swin_wgrad_bf16")
    _colsum_into(lib, part, splits, m * n, out, keep, stream)


def _wgrad(lib, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T . b (fp32, (M, N)) for a (T, M) and b (T, N) bf16 token-major
    operands, the tokens split as :func:`_wgrad_slices` says."""
    t, m = a.shape
    n = b.shape[1]
    sms = _sm_count(a.device.index)
    part = torch.empty(_wgrad_slices(t, m, n, sms)[1], m * n, dtype=torch.float32,
                       device=a.device)
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    _wgrad_into(lib, a.data_ptr(), b.data_ptr(), t, m, n, part.data_ptr(), out.data_ptr(), None,
                sms, _stream(a.device))
    return out


def swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1, w2):
    """K3: ``(dh, dln2_w, dln2_b, dw1, db1, dw2, db2)`` from the saved h.

    CUDA tensors launch the kernels (counted in ``swin_block_bwd_mlp.launches``)
    or raise; CPU tensors take :func:`swin_block_bwd_mlp_reference`.
    """
    if not _on_cuda("swin_block_bwd_mlp", h):
        return swin_block_bwd_mlp_reference(h, dout, ln2_w, ln2_b, w1, b1, w2)
    name = "swin_block_bwd_mlp"
    bw, n, c = _check_windows(name, h, dout)
    hidden = w1.shape[1]
    if c > 256 or c % 4 or hidden % 4:
        raise ValueError(f"{name}: unsupported widths C={c}, hidden={hidden}")
    _check_operands(name, h.device, dict(w1=w1, w2=w2), {"w1": (c, hidden), "w2": (hidden, c)},
                    dict(ln2_w=ln2_w, ln2_b=ln2_b, b1=b1), {"ln2_w": c, "ln2_b": c, "b1": hidden},
                    (dout,))
    lib = _train_library()
    if lib.swin_bwd_mlp_smem_bytes(c, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c}, hidden={hidden} need more than 227 KB shared memory")
    h, dout, w1, w2 = (t.contiguous() for t in (h, dout, w1, w2))
    ln2_w, ln2_b, b1 = (t.float().contiguous() for t in (ln2_w, ln2_b, b1))
    if h.data_ptr() % 16 or w1.data_ptr() % 8 or w2.data_ptr() % 8:
        raise ValueError(f"{name}: windows must be 16-byte, weights 8-byte aligned")
    t = bw * n
    dh = torch.empty_like(h)
    hn = torch.empty(t, c, dtype=torch.bfloat16, device=h.device)
    g, du = (torch.empty(t, hidden, dtype=torch.bfloat16, device=h.device) for _ in range(2))
    vec = torch.empty(bw, hidden + 3 * c, dtype=torch.float32, device=h.device)
    wpack = torch.empty(lib.swin_bwd_mlp_pack_bytes(c, hidden) // 2, dtype=torch.bfloat16,
                        device=h.device)
    with torch.cuda.device(h.device):
        _check(lib.swin_bwd_mlp_bf16(*_ptrs(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du,
                                            vec, wpack), bw, c, hidden, _stream(h.device)),
               "swin_bwd_mlp_bf16")
        dw1 = _wgrad(lib, hn, du)
        dw2 = _wgrad(lib, g, dout.reshape(t, c))
        db1, db2, dln2_w, dln2_b = _colsum(lib, vec).split([hidden, c, c, c])
    swin_block_bwd_mlp.launches += 1
    return dh, dln2_w, dln2_b, dw1, db1, dw2, db2


swin_block_bwd_mlp.launches = 0


def attn_head_width(c: int, num_heads: int) -> int:
    """The columns each head takes in K4/K9c's window kernel: 16 for a head
    of at most 16, else 32 (the per-head products' k16 steps)."""
    return 16 if c // num_heads <= 16 else 32


def attn_pack_reference(wqkv: torch.Tensor, wproj: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain form of the attention window kernel's weight packing (bf16, flat).

    Per head h four tiles of ck x hp (ck: C rounded up to 64, hp:
    :func:`attn_head_width`): wproj[h, :]^T, then the head's columns of wq,
    wk and wv, element (c, j) at position (c // 8) hp*8 + (j // 8) 64 +
    (c % 8) 8 + j % 8, zero past C and past the head's columns."""
    c = wqkv.shape[0]
    hd = c // num_heads
    hp = attn_head_width(c, num_heads)
    ck = -(-c // 64) * 64
    heads = torch.zeros(num_heads, 4, ck, hp, dtype=wqkv.dtype, device=wqkv.device)
    w = wqkv.reshape(c, 3, num_heads, hd).permute(2, 1, 0, 3)   # (heads, 3, c, hd)
    heads[:, 0, :c, :hd] = wproj.reshape(num_heads, hd, c).transpose(1, 2)
    heads[:, 1:, :c, :hd] = w
    # (c // 8, c % 8, j // 8, j % 8) -> (c // 8, j // 8, c % 8, j % 8)
    tiles = heads.reshape(num_heads, 4, ck // 8, 8, hp // 8, 8).transpose(3, 4)
    return tiles.reshape(-1).contiguous()


def mlp_pack_reference(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain form of the MLP weight packing (``mlp_pack_kernel``; bf16, flat).

    Per 64-wide hidden chunk j two tiles of ck x 64 (ck: C rounded up to
    64): w1[:, j] then w2[j, :]^T, element (c, jj) at position (c // 8) 512
    + (jj // 8) 64 + (c % 8) 8 + jj % 8, zero past C and past hidden."""
    c, hidden = w1.shape
    ck, nj = -(-c // 64) * 64, -(-hidden // 64)
    chunks = torch.zeros(nj, 2, ck, 64, dtype=w1.dtype, device=w1.device)
    for which, w in enumerate((w1, w2.T)):  # both (c, hidden)
        chunks[:, which, :c] = F.pad(w, (0, nj * 64 - hidden)).reshape(c, nj, 64).transpose(0, 1)
    # (c // 8, c % 8, jj // 8, jj % 8) -> (c // 8, jj // 8, c % 8, jj % 8)
    tiles = chunks.reshape(nj, 2, ck // 8, 8, 8, 8).transpose(3, 4)
    return tiles.reshape(-1).contiguous()


@functools.cache
def _attn_sizes(c: int, num_heads: int) -> tuple[int, int, int]:
    """The attention window kernel at width c: (windows a block, packed
    weight elements, dynamic shared memory bytes)."""
    lib = _train_library()
    return (lib.swin_bwd_attn_windows(c, num_heads),
            lib.swin_bwd_attn_pack_bytes(c, num_heads) // 2,
            lib.swin_bwd_attn_smem_bytes(c, num_heads))


@functools.cache
def _attn_keep(c: int, num_heads: int, c_real: int, hd_real: int, n_proj: int,
               device: torch.device) -> tuple:
    """int32 column maps from the attention window kernel's layouts (each
    head at hp columns of dw = heads * hp; for K9c also the channels padded
    from c_real to c) to the real widths, for the gathered column sums:
    dWqkv's (c_real x 3 c_real of the (c, 3 dw) product), dWproj's (c_real x
    c_real of the (dw, n_proj) product) and the partial sums' (dbqkv | dbproj
    | dln1 w | b | dbias of a row of 3 dw + 3c + heads*64*64)."""
    hp = attn_head_width(c, num_heads)
    dw = num_heads * hp
    att_cols = (torch.arange(num_heads)[:, None] * hp + torch.arange(hd_real)).reshape(-1)
    qkv_cols = (torch.arange(3)[:, None] * dw + att_cols).reshape(-1)
    chans = torch.arange(c_real)
    qkv = (chans[:, None] * 3 * dw + qkv_cols).reshape(-1)
    proj = (att_cols[:, None] * n_proj + chans).reshape(-1)
    part = torch.cat([qkv_cols, 3 * dw + chans, 3 * dw + c + chans, 3 * dw + 2 * c + chans,
                      3 * dw + 3 * c + torch.arange(num_heads * 64 * 64)])
    return tuple(t.to(device=device, dtype=torch.int32) for t in (qkv, proj, part))


def _pointers(buf: torch.Tensor, sizes: list[int]) -> list[int]:
    """Addresses of consecutive pieces of ``sizes`` elements in ``buf``."""
    return [buf.data_ptr() + buf.element_size() * o
            for o in itertools.accumulate([0] + sizes[:-1])]


def _attn_window_grads(lib, launch, x, dh, num_heads: int, c: int, hd_real: int, dhs: bool):
    """Runs the attention window kernel at its width ``c`` (windows of
    ``x.shape[-1]`` real channels, heads of ``hd_real``) and what follows it:
    ``launch(dx, xn, att, dqkv, dhs, part, wpack, wpw, stream)`` (pointers;
    the packing and the window kernel), the two weight-gradient products and
    one ordered column sum over the warpgroups' partial sums, each sum
    gathering the real columns. The intermediates share two scratch
    allocations and the fp32 results one. Returns ``(dx, dln1_w, dln1_b,
    dwqkv, dbqkv, dbias, dwproj, dbproj)`` at the real widths."""
    bw, n, cio = x.shape
    dw = num_heads * attn_head_width(c, num_heads)
    t, dev = bw * n, x.device
    stream, sms = _stream(dev), _sm_count(dev.index)
    nw, packed, _ = _attn_sizes(c, num_heads)
    wpw = -(-bw // (nw * sms))
    rows, width = -(-bw // wpw), 3 * dw + 3 * c + num_heads * n * n
    n_proj = c if dhs else cio
    keep = _attn_keep(c, num_heads, cio, hd_real, n_proj, dev)
    # bf16 scratch: xn | att | dqkv | dhs | wpack; fp32 scratch: part | the
    # two products' slices; fp32 results: dwqkv | dwproj | the row sums
    bf_sizes = [t * c, t * dw, 3 * t * dw, t * c if dhs else 0, packed]
    f_sizes = [rows * width, _wgrad_slices(t, c, 3 * dw, sms)[1] * c * 3 * dw,
               _wgrad_slices(t, dw, n_proj, sms)[1] * dw * n_proj]
    out_sizes = [k.numel() for k in keep]
    dx = torch.empty_like(x)
    scratch16 = torch.empty(sum(bf_sizes), dtype=torch.bfloat16, device=dev)
    scratch32 = torch.empty(sum(f_sizes), dtype=torch.float32, device=dev)
    out = torch.empty(sum(out_sizes), dtype=torch.float32, device=dev)
    xn, att, dqkv, dhs_p, wpack = _pointers(scratch16, bf_sizes)
    part, pq, pp = _pointers(scratch32, f_sizes)
    oq, op, opart = _pointers(out, out_sizes)
    launch(dx.data_ptr(), xn, att, dqkv, dhs_p if dhs else None, part, wpack, wpw, stream)
    _wgrad_into(lib, xn, dqkv, t, c, 3 * dw, pq, oq, keep[0], sms, stream)
    _wgrad_into(lib, att, dhs_p if dhs else dh.data_ptr(), t, dw, n_proj, pp, op, keep[1], sms,
                stream)
    _colsum_into(lib, part, rows, width, opart, keep[2], stream)
    dwqkv, dwproj, dbqkv, dbproj, dln1_w, dln1_b, dbias = out.split(
        [cio * 3 * cio, cio * cio, 3 * cio, cio, cio, cio, num_heads * n * n])
    return (dx, dln1_w, dln1_b, dwqkv.view(cio, 3 * cio), dbqkv, dbias.view(num_heads, n, n),
            dwproj.view(cio, cio), dbproj)


def swin_block_bwd_attn(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, *, num_heads: int,
                        scale: float):
    """K4: ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj)``.

    CUDA tensors launch the kernels (counted in ``swin_block_bwd_attn.launches``)
    or raise; CPU tensors take :func:`swin_block_bwd_attn_reference`.
    """
    if not _on_cuda("swin_block_bwd_attn", x):
        return swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                                             num_heads=num_heads, scale=scale)
    name = "swin_block_bwd_attn"
    bw, n, c = _check_windows(name, x, dh)
    _check_heads(name, c, num_heads)
    _check_operands(name, x.device, dict(wqkv=wqkv, wproj=wproj),
                    {"wqkv": (c, 3 * c), "wproj": (c, c)},
                    dict(ln1_w=ln1_w, ln1_b=ln1_b, bqkv=bqkv),
                    {"ln1_w": c, "ln1_b": c, "bqkv": 3 * c}, (dh, bias))
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"{name}: bias wants {(num_heads, n, n)}, got {tuple(bias.shape)}")
    lib = _train_library()
    if _attn_sizes(c, num_heads)[2] > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")
    x, dh, wqkv, wproj = (t.contiguous() for t in (x, dh, wqkv, wproj))
    ln1_w, ln1_b, bqkv, bias = (_f32(t) for t in (ln1_w, ln1_b, bqkv, bias))

    def launch(dx, xn, att, dqkv, _dhs, part, wpack, wpw, stream):
        _check(lib.swin_bwd_attn_bf16(*_ptrs(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj), dx,
                                      xn, att, dqkv, part, wpack, bw, c, num_heads, wpw,
                                      float(scale), stream),
               "swin_bwd_attn_bf16")

    with torch.cuda.device(x.device):
        out = _attn_window_grads(lib, launch, x, dh, num_heads, c, c // num_heads, dhs=False)
    swin_block_bwd_attn.launches += 1
    return out


swin_block_bwd_attn.launches = 0


def swin_block_bwd(x, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1,
                   w2, b2, *, num_heads: int, scale: float):
    """K4b: the block's 14 gradients from x and dout (the order of
    :func:`swin_block_bwd_reference`), the forward recomputed.

    CUDA tensors launch the kernels (counted in ``swin_block_bwd.launches``)
    or raise; CPU tensors take :func:`swin_block_bwd_reference`.
    """
    args = (x, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
    if not _on_cuda("swin_block_bwd", x):
        return swin_block_bwd_reference(*args, num_heads=num_heads, scale=scale)
    name = "swin_block_bwd"
    _check_windows(name, x, dout)
    vectors, weights = _block_dicts(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                                    w1, b1, w2, b2)
    lib, train = _bwd_library(), _train_library()
    x, w, f32, bias = _checked_block_operands(
        name, x, vectors, weights, bias, num_heads,
        lambda c, hidden: lib.swin_bwd_block_smem_bytes(c, num_heads, hidden), (dout,))
    dout = dout.contiguous()
    bw, n, c = x.shape
    hidden = w["w1"].shape[1]
    t, dev = bw * n, x.device
    # the MLP phase's: the fp32 h and dh; bf16(dh), hn, g, du and w1 | w2
    # packed; the per-window sums db1 | db2 | dln2s | dln2b | dbproj
    h32, dh32 = torch.empty(2, t * c, dtype=torch.float32, device=dev)
    mlp_pack = train.swin_bwd_mlp_pack_bytes(c, hidden) // 2
    dhb, hn, g, du, wmlp = torch.empty(
        2 * t * c + 2 * t * hidden + mlp_pack, dtype=torch.bfloat16, device=dev).split(
        [t * c, t * c, t * hidden, t * hidden, mlp_pack])
    vec = torch.empty(bw, hidden + 4 * c, dtype=torch.float32, device=dev)
    head = _ptrs(x, dout, f32["ln1_w"], f32["ln1_b"], w["wqkv"], f32["bqkv"], bias, w["wproj"],
                 f32["bproj"], f32["ln2_w"], f32["ln2_b"], w["w1"], f32["b1"], w["w2"])
    tail = _ptrs(h32, dh32, dhb, hn, g, du, vec, wmlp)

    def launch(dx, xn, att, dqkv, _dhs, part, wattn, wpw, stream):
        # the three phases; the attention phase's outputs and its packed
        # tiles (which the recompute streams too) in the shared scratch
        _check(lib.swin_bwd_block_bf16(*head, dx, xn, att, dqkv, part, wattn, *tail, bw, c,
                                       num_heads, hidden, wpw, float(scale), stream),
               "swin_bwd_block_bf16")

    with torch.cuda.device(dev):
        # dWproj's operand is bf16(dh), as K4's; dbproj comes from the MLP
        # phase's fp32 dh, not from the attention phase's partial sums
        dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, _ = _attn_window_grads(
            train, launch, x, dhb, num_heads, c, c // num_heads, dhs=False)
        dw1 = _wgrad(train, hn.view(t, c), du.view(t, hidden))
        dw2 = _wgrad(train, g.view(t, hidden), dout.reshape(t, c))
        db1, db2, dln2_w, dln2_b, dbproj = _colsum(train, vec).split([hidden, c, c, c, c])
    swin_block_bwd.launches += 1
    return (dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj, dln2_w, dln2_b, dw1, db1,
            dw2, db2)


swin_block_bwd.launches = 0


class FusedSwinBlockFn(torch.autograd.Function):
    """One Swin block with K2 forward and K3 + K4 backward (the JAX
    ``fused_swin_block_ad``). Each gradient comes back in its input's dtype,
    so a bf16 weight's fp32 sum is rounded to bf16 first, as ``_ad_bwd`` does."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1,
                w2, b2, num_heads, scale):
        params = (ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
        out, h = swin_block_fwd_h(x, *params, num_heads=num_heads, scale=scale)
        ctx.save_for_backward(x, h, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, ln2_w, ln2_b,
                              w1, b1, w2)
        ctx.dtypes = [p.dtype for p in params]
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        x, h, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, ln2_w, ln2_b, w1, b1, w2 = ctx.saved_tensors
        dh, dln2_w, dln2_b, dw1, db1, dw2, db2 = swin_block_bwd_mlp(
            h, dout.contiguous(), ln2_w, ln2_b, w1, b1, w2)
        dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj = swin_block_bwd_attn(
            x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
            num_heads=ctx.num_heads, scale=ctx.scale)
        grads = (dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj, dln2_w, dln2_b,
                 dw1, db1, dw2, db2)
        return (dx, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None)


class FusedSwinBlockRecomputeFn(torch.autograd.Function):
    """One Swin block with K1 forward and K4b backward (the JAX
    ``fused_swin_block_bwd`` as the block's VJP): the forward keeps x and
    the operands, not h, and the backward recomputes the forward. Each
    gradient comes back in its input's dtype, as in :class:`FusedSwinBlockFn`."""

    @staticmethod
    def forward(ctx, x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1,
                w2, b2, num_heads, scale):
        params = (ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
        out = fused_swin_block(x, *params, num_heads=num_heads, scale=scale)
        ctx.save_for_backward(x, *params)
        ctx.dtypes = [p.dtype for p in params]
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        x, *params = ctx.saved_tensors
        dx, *grads = swin_block_bwd(x, dout.contiguous(), *params, num_heads=ctx.num_heads,
                                    scale=ctx.scale)
        return (dx, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)), None, None)


def _gather_rows(x2d: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    # rows move as the widest words (up to 8 bytes) their width allows:
    # at C = 180 in bf16 the gather handles 4x fewer elements
    word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        math.gcd(8, x2d.shape[1] * x2d.element_size())]
    return x2d.view(word)[index].view(x2d.dtype)


@functools.cache
def token_order(b: int, h: int, w: int, ws: int, shift: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Roll by -shift then ws x ws window partition, as one permutation of the
    b*h*w token rows (window slot i holds row fwd[i]), and its inverse."""
    idx = torch.arange(b * h * w, device=device).reshape(b, h, w, 1)
    fwd = window_partition(torch.roll(idx, (-shift, -shift), dims=(1, 2)), ws).reshape(-1)
    return fwd, torch.argsort(fwd)


class _GatherRows(torch.autograd.Function):
    """Row permutation whose backward is the same word-view gather with the
    inverse permutation (exact: it only moves data)."""

    @staticmethod
    def forward(ctx, x2d, index, inverse):
        ctx.save_for_backward(inverse)
        return _gather_rows(x2d, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        return _gather_rows(grad.contiguous(), inverse), None, None


def _block_operands(blk, ws: int, dtype: torch.dtype) -> tuple:
    """The 13 fused-block operands of one SwinIR block: weights (in, out) in
    ``dtype``, LayerNorm parameters, biases and the gathered bias fp32."""
    attn, mlp = blk.attn, blk.mlp
    return (
        blk.norm1.weight.float(), blk.norm1.bias.float(),
        attn.qkv.weight.T.to(dtype), attn.qkv.bias.float(),
        relative_position_bias(attn.relative_position_bias_table, ws).float(),
        attn.proj.weight.T.to(dtype), attn.proj.bias.float(),
        blk.norm2.weight.float(), blk.norm2.bias.float(),
        mlp.fc1.weight.T.to(dtype), mlp.fc1.bias.float(),
        mlp.fc2.weight.T.to(dtype), mlp.fc2.bias.float(),
    )


def make_fused_swinir(model, *, dtype: torch.dtype = torch.bfloat16,
                      differentiable: bool = False, backward: str = "split"):
    """SwinIR forward with every block through the fused block kernels.

    Twin of the JAX ``make_fused_swinir``: takes and returns NHWC, requires H
    and W to be window multiples (no reflect pad, no small-input rule), and
    computes in ``dtype`` (bf16 by default) with LayerNorms in fp32.

    ``differentiable=False`` (inference): the weights of ``model`` are cast,
    laid out and, on the card, packed for K1 once, here (the packed tiles
    take about 32 MB at the flagship widths), every block runs K1 under
    ``torch.no_grad``, and later changes to ``model`` are not seen. ``differentiable=True``
    (training): the operands are built from the live parameters on every call,
    inside autograd, so the gradients flow back through the casts and the
    bias gather into ``model``'s fp32 parameters; with grad enabled each
    block runs :class:`FusedSwinBlockFn` (K2, then K3 and K4 in the
    backward), under ``torch.no_grad`` K1, as the JAX custom VJP's primal does.
    ``backward="recompute"`` runs :class:`FusedSwinBlockRecomputeFn` instead
    (K1, then K4b): h is not kept between the forward and the backward.
    """
    fns = {"split": FusedSwinBlockFn, "recompute": FusedSwinBlockRecomputeFn}
    if backward not in fns:
        raise ValueError(f"backward is 'split' or 'recompute', got {backward!r}")
    block_fn = fns[backward]
    ws = model.window_size
    n = ws * ws
    blocks = [blk for layer in model.layers for blk in layer]
    meta = [(blk.attn.num_heads, 0 if j % 2 == 0 else ws // 2)
            for layer in model.layers for j, blk in enumerate(layer)]
    convs = [model.conv_first, model.conv_after_body, model.conv_before_upsample[0],
             *model.upsample[::2], model.conv_last]
    factors = [shuffle.upscale_factor for shuffle in model.upsample[1::2]]

    def operands():
        return ([_block_operands(blk, ws, dtype) for blk in blocks],
                (model.norm.weight.float(), model.norm.bias.float()),
                [(m.weight.to(dtype), m.bias.to(dtype)) for m in convs])

    packed = [None] * len(blocks)  # K1's weights packed once, for the frozen forward
    if not differentiable:
        with torch.no_grad():
            frozen = operands()
            frozen = ([tuple(t.contiguous() for t in args) for args in frozen[0]], frozen[1],
                      frozen[2])
            if frozen[0] and frozen[0][0][2].is_cuda:
                packed = [pack_swin_block_weights(args[2], args[5], args[9], args[11],
                                                  num_heads=heads)
                          for args, (heads, _) in zip(frozen[0], meta)]

    def conv3(wb, x):
        return F.conv2d(x.permute(0, 3, 1, 2), wb[0], wb[1], padding=1).permute(0, 2, 3, 1)

    def block(args, heads, shift, x, packed=None):
        # the rolls and the window partition/reverse as one gather each way
        b, h, w, c = x.shape
        fwd, inv = token_order(b, h, w, ws, shift, x.device)
        scale = (c // heads) ** -0.5
        if torch.is_grad_enabled():
            xw = _GatherRows.apply(x.reshape(-1, c), fwd, inv).reshape(-1, n, c)
            out = block_fn.apply(xw, *args, heads, scale)
            return _GatherRows.apply(out.reshape(-1, c), inv, fwd).reshape(b, h, w, c)
        xw = _gather_rows(x.reshape(-1, c), fwd).reshape(-1, n, c)
        out = fused_swin_block(xw, *args, num_heads=heads, scale=scale, packed=packed)
        return _gather_rows(out.reshape(-1, c), inv).reshape(b, h, w, c)

    def run(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % ws or w % ws:
            raise ValueError(f"fused SwinIR needs H and W multiples of {ws}, got {h}x{w}")
        block_args, norm, conv_wb = frozen if not differentiable else operands()
        first, after_body, before_up, *up, last = conv_wb
        x = x.to(dtype)
        x_first = conv3(first, x)
        res = x_first
        for args, (heads, shift), pack in zip(block_args, meta, packed):
            res = block(args, heads, shift, res, pack)
        res = _ln_f32(res, *norm).to(dtype)
        res = conv3(after_body, res) + x_first
        out = F.leaky_relu(conv3(before_up, res), 0.01)
        for wb, r in zip(up, factors):
            out = pixel_shuffle(conv3(wb, out), r)
        return conv3(last, out)

    if differentiable:
        return run
    return torch.no_grad()(run)
