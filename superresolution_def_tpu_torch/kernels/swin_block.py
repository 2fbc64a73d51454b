"""Fused Swin transformer block: forward and backward as hand-written Hopper kernels.

Port of ``superresolution_def_tpu/kernels/swin_block.py``:

- K1 :func:`fused_swin_block` (``fused_swin_block``), the inference block;
- K2 :func:`swin_block_fwd_h` (``fused_swin_block_fwd_h``), the same block that
  also returns h = x + proj(attn) for the backward;
- K3 :func:`swin_block_bwd_mlp` (``_bwd_mlp``), the LN2 + MLP backward from h;
- K4 :func:`swin_block_bwd_attn` (``_bwd_attn``), the attention + LN1 backward;
- K4b :func:`swin_block_bwd` (``fused_swin_block_bwd``), the whole block's
  backward from x and dout alone, the forward recomputed.

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
    bw, n, c = x_windows.shape
    rnd = _rounder(dt)
    x = x_windows.float()
    q, k, v = _qkv_heads(rnd(_ln_f32(x, ln1_w, ln1_b)), wqkv, bqkv, num_heads, rnd)
    q = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    p = _softmax_f32(torch.matmul(q, k.transpose(-1, -2)) + bias.float())
    o = torch.matmul(rnd(p), v).permute(0, 2, 1, 3).reshape(bw, n, c)
    h = x + (torch.matmul(rnd(o), wproj.float()) + bproj.float())
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

    Returns ``(dh, dln2_w, dln2_b, dw1, db1, dw2, db2)``: dh in the io dtype,
    the rest fp32 sums over all windows. ``dp``: the MLP branch's scale per
    window ``(Bw,)``; the cotangent entering the branch is ``dp * dout`` while
    dh's residual term is ``dout`` itself.
    """
    dt = h.dtype
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
    return (dh.to(dt), (dhn * xhat).sum((0, 1)), dhn.sum((0, 1)), dw1, du.sum(0), dw2,
            dm.sum(0))


def swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, *,
                                  num_heads: int, scale: float, mask=None, dp=None):
    """Plain PyTorch form of K4 (the TPU kernel's per-head branch), and of
    K9c with ``mask`` and ``dp``.

    Returns ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj)``: dx
    in the io dtype, the rest fp32 sums over all windows. ``mask``: the
    ``(nW, N, N)`` shift mask, window w adding ``mask[w mod nW]`` to its
    scores; ``dp``: the attention branch's scale per window ``(Bw,)``, which
    scales the cotangent entering the branch but not dx's residual term.
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
    for fn, nout in ((lib.swin_block_bf16, 1), (lib.swin_block_fwd_h_bf16, 2)):
        fn.argtypes = [ctypes.c_void_p] * (14 + nout) + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.swin_block_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.swin_block_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _train_library() -> ctypes.CDLL:
    lib = load_library("swin_block_train")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_bwd_mlp_bf16.argtypes = [vp] * 12 + [i32] * 3 + [vp]
    lib.swin_bwd_attn_bf16.argtypes = [vp] * 14 + [i32] * 3 + [ctypes.c_float, vp]
    lib.swin_wgrad_bf16.argtypes = [vp, vp] + [i32] * 5 + [vp, vp]
    lib.swin_colsum_f32.argtypes = [vp, i32, i32, i32, vp, vp]
    lib.hab_bwd_mlp_bf16.argtypes = [vp] * 14 + [i32] * 4 + [vp]
    lib.hab_bwd_attn_bf16.argtypes = [vp] * 17 + [i32] * 5 + [ctypes.c_float, vp]
    for fn in (lib.swin_bwd_mlp_bf16, lib.swin_bwd_attn_bf16, lib.swin_wgrad_bf16,
               lib.swin_colsum_f32, lib.hab_bwd_mlp_bf16, lib.hab_bwd_attn_bf16):
        fn.restype = ctypes.c_int
    lib.swin_bwd_mlp_smem_bytes.argtypes = [i32, i32]
    lib.swin_bwd_attn_smem_bytes.argtypes = [i32]
    lib.swin_bwd_mlp_smem_bytes.restype = ctypes.c_size_t
    lib.swin_bwd_attn_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = load_library("swin_block_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_bwd_block_bf16.argtypes = [vp] * 25 + [i32] * 4 + [ctypes.c_float, vp]
    lib.swin_bwd_block_bf16.restype = ctypes.c_int
    lib.swin_bwd_block_smem_bytes.argtypes = [i32, i32]
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


def _launch_forward(x, vectors, weights, bias, num_heads, scale, store_h):
    name = "swin_block_fwd_h" if store_h else "fused_swin_block"
    lib = _kernel_library()
    x, w, f32, bias = _checked_block_operands(
        name, x, vectors, weights, bias, num_heads,
        lambda c, hidden: lib.swin_block_smem_bytes(c, num_heads, hidden))
    bw, _, c = x.shape
    out = torch.empty_like(x)
    h = torch.empty_like(x) if store_h else None
    args = [
        x.data_ptr(), f32["ln1_w"].data_ptr(), f32["ln1_b"].data_ptr(),
        w["wqkv"].data_ptr(), f32["bqkv"].data_ptr(), bias.data_ptr(),
        w["wproj"].data_ptr(), f32["bproj"].data_ptr(),
        f32["ln2_w"].data_ptr(), f32["ln2_b"].data_ptr(),
        w["w1"].data_ptr(), f32["b1"].data_ptr(), w["w2"].data_ptr(), f32["b2"].data_ptr(),
        out.data_ptr(), *([h.data_ptr()] if store_h else []),
        bw, c, num_heads, w["w1"].shape[1], float(scale),
    ]
    with torch.cuda.device(x.device):
        fn = lib.swin_block_fwd_h_bf16 if store_h else lib.swin_block_bf16
        _check(fn(*args, _stream(x.device)), fn.__name__)
    return (out, h) if store_h else out


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
    *, num_heads: int, scale: float,
) -> torch.Tensor:
    """K1: one Swin block over ``(Bw, N, C)`` windows -> ``(Bw, N, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_swin_block.launches``) or raise; CPU tensors take
    :func:`swin_block_reference`.
    """
    args = (x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("fused_swin_block", x_windows):
        return swin_block_reference(*args, num_heads=num_heads, scale=scale)
    vectors, weights = _block_dicts(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b,
                                    w1, b1, w2, b2)
    out = _launch_forward(x_windows, vectors, weights, bias, num_heads, scale, store_h=False)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def swin_block_fwd_h(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(out, h)``; ``out`` is K1's, h = x + proj(attn) in the io dtype.

    CUDA tensors launch the kernel (counted in ``swin_block_fwd_h.launches``)
    or raise; CPU tensors take :func:`swin_block_fwd_h_reference`.
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


# the weight-gradient products split their tokens so that about this many
# thread blocks run per SM
_WGRAD_BLOCKS_PER_SM = 4


def _colsum(lib, x: torch.Tensor) -> torch.Tensor:
    """Column sums of a (R, n) fp32 tensor in a fixed order: slices of 64
    rows first, then the slice sums."""
    stream = _stream(x.device)
    while True:
        r, n = x.shape
        rps = 64 if r > 64 else r
        out = torch.empty((r + rps - 1) // rps, n, dtype=torch.float32, device=x.device)
        _check(lib.swin_colsum_f32(x.data_ptr(), r, n, rps, out.data_ptr(), stream),
               "swin_colsum_f32")
        x = out
        if x.shape[0] == 1:
            return x[0]


def _wgrad(lib, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T . b (fp32) for a (T, M) and b (T, N) bf16 token-major operands."""
    t, m = a.shape
    n = b.shape[1]
    tiles = -(-m // 64) * -(-n // 64)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = max(1, min(t // 64, -(-_WGRAD_BLOCKS_PER_SM * sms // tiles)))
    rps = -(-t // (splits * 64)) * 64
    splits = -(-t // rps)
    part = torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
    _check(lib.swin_wgrad_bf16(a.data_ptr(), b.data_ptr(), t, m, n, rps, splits,
                               part.data_ptr(), _stream(a.device)), "swin_wgrad_bf16")
    return _colsum(lib, part.reshape(splits, m * n)).reshape(m, n)


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
    with torch.cuda.device(h.device):
        _check(lib.swin_bwd_mlp_bf16(*_ptrs(h, dout, ln2_w, ln2_b, w1, b1, w2, dh, hn, g, du,
                                            vec), bw, c, hidden, _stream(h.device)),
               "swin_bwd_mlp_bf16")
        dw1 = _wgrad(lib, hn, du)
        dw2 = _wgrad(lib, g, dout.reshape(t, c))
        db1, db2, dln2_w, dln2_b = _colsum(lib, vec).split([hidden, c, c, c])
    swin_block_bwd_mlp.launches += 1
    return dh, dln2_w, dln2_b, dw1, db1, dw2, db2


swin_block_bwd_mlp.launches = 0


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
    if lib.swin_bwd_attn_smem_bytes(c) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")
    x, dh, wqkv, wproj = (t.contiguous() for t in (x, dh, wqkv, wproj))
    ln1_w, ln1_b, bqkv, bias = (t.float().contiguous() for t in (ln1_w, ln1_b, bqkv, bias))
    if wqkv.data_ptr() % 8 or wproj.data_ptr() % 8:
        raise ValueError(f"{name}: weights must be 8-byte aligned")
    t = bw * n
    dx = torch.empty_like(x)
    xn, att = (torch.empty(t, c, dtype=torch.bfloat16, device=x.device) for _ in range(2))
    dqkv = torch.empty(t, 3 * c, dtype=torch.bfloat16, device=x.device)
    vec = torch.empty(bw, 6 * c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(bw, num_heads * n * n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(lib.swin_bwd_attn_bf16(*_ptrs(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, dx,
                                             xn, att, dqkv, vec, dbias),
                                      bw, c, num_heads, float(scale), _stream(x.device)),
               "swin_bwd_attn_bf16")
        dwqkv = _wgrad(lib, xn, dqkv)
        dwproj = _wgrad(lib, att, dh.reshape(t, c))
        dbqkv, dbproj, dln1_w, dln1_b = _colsum(lib, vec).split([3 * c, c, c, c])
        dbias = _colsum(lib, dbias).reshape(num_heads, n, n)
    swin_block_bwd_attn.launches += 1
    return dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj


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
    x, w, f32, bias = _checked_block_operands(name, x, vectors, weights, bias, num_heads,
                                              lib.swin_bwd_block_smem_bytes, (dout,))
    dout = dout.contiguous()
    bw, n, c = x.shape
    hidden = w["w1"].shape[1]
    t = bw * n
    dx = torch.empty_like(x)
    xn, att, hn, dhb = (torch.empty(t, c, dtype=torch.bfloat16, device=x.device)
                        for _ in range(4))
    dqkv = torch.empty(t, 3 * c, dtype=torch.bfloat16, device=x.device)
    g, du = (torch.empty(t, hidden, dtype=torch.bfloat16, device=x.device) for _ in range(2))
    dh = torch.empty(t, c, dtype=torch.float32, device=x.device)
    vec = torch.empty(bw, 9 * c + hidden, dtype=torch.float32, device=x.device)
    dbias = torch.empty(bw, num_heads * n * n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _check(lib.swin_bwd_block_bf16(
            *_ptrs(x, dout, f32["ln1_w"], f32["ln1_b"], w["wqkv"], f32["bqkv"], bias, w["wproj"],
                   f32["bproj"], f32["ln2_w"], f32["ln2_b"], w["w1"], f32["b1"], w["w2"], dx, xn,
                   att, dqkv, hn, g, du, dhb, dh, vec, dbias),
            bw, c, num_heads, hidden, float(scale), _stream(x.device)), "swin_bwd_block_bf16")
        dwqkv = _wgrad(train, xn, dqkv)
        dwproj = _wgrad(train, att, dhb)
        dw1 = _wgrad(train, hn, du)
        dw2 = _wgrad(train, g, dout.reshape(t, c))
        dbqkv, dbproj, dln1_w, dln1_b, db1, db2, dln2_w, dln2_b = _colsum(train, vec).split(
            [3 * c, c, c, c, hidden, c, c, c])
        dbias = _colsum(train, dbias).reshape(num_heads, n, n)
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

    ``differentiable=False`` (inference): the weights of ``model`` are cast and
    laid out once, here, every block runs K1 under ``torch.no_grad``, and
    later changes to ``model`` are not seen. ``differentiable=True``
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

    if not differentiable:
        with torch.no_grad():
            frozen = operands()
        frozen = ([tuple(t.contiguous() for t in args) for args in frozen[0]], frozen[1],
                  frozen[2])

    def conv3(wb, x):
        return F.conv2d(x.permute(0, 3, 1, 2), wb[0], wb[1], padding=1).permute(0, 2, 3, 1)

    def block(args, heads, shift, x):
        # the rolls and the window partition/reverse as one gather each way
        b, h, w, c = x.shape
        fwd, inv = token_order(b, h, w, ws, shift, x.device)
        scale = (c // heads) ** -0.5
        if torch.is_grad_enabled():
            xw = _GatherRows.apply(x.reshape(-1, c), fwd, inv).reshape(-1, n, c)
            out = block_fn.apply(xw, *args, heads, scale)
            return _GatherRows.apply(out.reshape(-1, c), inv, fwd).reshape(b, h, w, c)
        xw = _gather_rows(x.reshape(-1, c), fwd).reshape(-1, n, c)
        out = fused_swin_block(xw, *args, num_heads=heads, scale=scale)
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
        for args, (heads, shift) in zip(block_args, meta):
            res = block(args, heads, shift, res)
        res = _ln_f32(res, *norm).to(dtype)
        res = conv3(after_body, res) + x_first
        out = F.leaky_relu(conv3(before_up, res), 0.01)
        for wb, r in zip(up, factors):
            out = pixel_shuffle(conv3(wb, out), r)
        return conv3(last, out)

    if differentiable:
        return run
    return torch.no_grad()(run)
