"""K11: the window-attention core, XLA-style or through a Hopper kernel.

Port of ``superresolution_def_tpu/kernels/window_attention.py``.
:func:`window_attention` has the JAX signature: pre-projected q ``(Bw,
heads, Nq, d)``, k and v ``(Bw, heads, Nk, d)``, a ``(heads, Nq, Nk)`` bias,
an optional ``(nW, Nq, Nk)`` additive mask that window b takes as
``mask[b % nW]``, and the query scale. ``impl`` picks the implementation:

- ``"xla"``: :func:`attention` on ``q * scale``: the einsum formulation,
  whose scores and bias sum stay in q's dtype before the fp32 softmax; the
  path every module ran before ``attn_impl`` existed;
- ``"pallas"``: the JAX package's opt-in Pallas kernels, here
  :func:`window_attention_nomask` (K11a, and K11c, which computes the same
  function on another TPU grid) and :func:`window_attention_masked` (K11b).
  On a CUDA tensor each launches ``csrc/window_attention.cu`` (bf16 on
  wgmma, fp32 on the CUDA cores; Nq = 64, d <= 32, even Nk <= 144) or
  raises; on a CPU tensor it runs :func:`window_attention_reference`,
  which keeps the Pallas kernels' rounding points.

The bf16 kernel gathers each (window, head) by 4-byte copies straight from
the strided views into ``hp`` = 16 or 32 slots; :func:`gather_plan` says
which slots and which operands :func:`repack_heads` copies first (an odd
row stride, say). The modules' views (rows of 3C, C or 2C) go in as they
are.

The Pallas path is forward-only, as in the JAX package, whose gradient
through it fails: ``"pallas"`` raises when autograd would record it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import load_library
from .swin_block import _check, _on_cuda, _softmax_f32, _stream

IMPLS = ("xla", "pallas")
MAX_KEYS = 144  # the kernel's key tiles: 9 x 16
MAX_HEAD_DIM = 32


def attention(q, k, v, bias, mask=None):
    """Softmax attention of (Bw, heads, Nq, d) queries, already scaled, with
    an additive (heads, Nq, Nk) bias and an optional (nW, Nq, Nk) mask tiled
    over the batch of windows; softmax in fp32, the rest in q's dtype."""
    attn = q @ k.transpose(-1, -2) + bias.to(q.dtype)
    if mask is not None:
        bw, h, n, m = attn.shape
        nw = mask.shape[0]
        attn = (attn.reshape(bw // nw, nw, h, n, m) + mask.to(q.dtype)[None, :, None]).reshape(
            bw, h, n, m)
    return torch.softmax(attn.float(), dim=-1).to(q.dtype) @ v


def window_attention_reference(q, k, v, bias, mask=None, *, scale: float) -> torch.Tensor:
    """Plain PyTorch form of K11 with the Pallas kernels' rounding points:
    q * scale in q's dtype (the scale rounded to it, as JAX's weak-typed
    scalar is); q.k^T summed in fp32, bias and mask added in fp32, fp32
    softmax; probabilities rounded to v's dtype; P.V summed in fp32, then
    rounded to q's dtype."""
    bw, h, n, _ = q.shape
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, h, n, -1) + mask.float()[None, :, None]).reshape(s.shape)
    p = _softmax_f32(s).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


class GatherPlan(NamedTuple):
    """How the bf16 kernel gathers q, k and v: ``hp`` slots a head (16 or
    32), and which of the three :func:`repack_heads` copies first."""

    hp: int
    repack: tuple[bool, bool, bool]


def head_parity(t: torch.Tensor) -> tuple[int, int, int]:
    """The parity of a head's first element address, in elements: at head 0
    of window 0, then its change from window to window and from head to head
    (0 where that dimension has one entry). Head (b, h) starts at an odd
    element, and lands at slots 1 .. d, when ``p[0] + b p[1] + h p[2]`` is
    odd."""
    return _parity(t, t.shape, t.stride())


def _parity(t, sh, st):
    return ((t.data_ptr() // t.element_size()) & 1, st[0] & 1 if sh[0] > 1 else 0,
            st[1] & 1 if sh[1] > 1 else 0)


def gather_plan(q, k, v) -> GatherPlan:
    """The bf16 kernel's gather of ``(Bw, heads, rows, d)`` q, k and v.

    It copies slot pairs by 4-byte ``cp.async``, so an operand goes in as it
    is when its columns are contiguous and its row stride is even; a head
    whose first element is odd then lands at slots 1 .. d, so it takes d + 1
    slots of at most 32. q and k must put every head at the same slots (the
    scores pair q's slot j with k's). Any other operand is repacked (q and k
    both when only their parities disagree). ``hp`` is 16 when every head
    fits 16 slots, else 32."""
    hd = q.shape[3]
    par, repack = [], []
    for t in (q, k, v):
        sh, st = t.shape, t.stride()
        p = _parity(t, sh, st)
        rep = (hd > 1 and st[3] != 1) or st[2] & 1 or hd + max(p) > 32
        par.append((0, 0, 0) if rep else p)  # a repacked head starts even
        repack.append(bool(rep))
    if par[0] != par[1]:
        repack[0] = repack[1] = True
        par[0] = par[1] = (0, 0, 0)
    odd = max(max(p) for p in par)
    return GatherPlan(16 if hd + odd <= 16 else 32, tuple(repack))


def repack_heads(t: torch.Tensor) -> torch.Tensor:
    """t copied on its device into a ``(Bw, heads, rows, d + d % 2)`` buffer,
    returned as the ``[..., :d]`` view: rows 4-byte aligned, every head's first
    element even."""
    bw, heads, rows, d = t.shape
    buf = torch.empty(bw, heads, rows, d + d % 2, dtype=t.dtype, device=t.device)
    buf[..., :d].copy_(t)
    return buf[..., :d]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("window_attention")
    lib.window_attention_run.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.window_attention_run.restype = ctypes.c_int
    return lib


def _launch(name, q, k, v, bias, mask, scale):
    """Checks the operands and launches the kernel: (out, operands repacked)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} on CUDA takes bfloat16 or float32, got {q.dtype}")
    bw, heads, nq, hd = q.shape
    nk = k.shape[2]
    for t in (k, v):
        if t.dtype != q.dtype or tuple(t.shape) != (bw, heads, nk, hd):
            raise ValueError(f"{name}: k and v want {q.dtype} ({bw}, {heads}, Nk, {hd}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if nq != 64 or hd > MAX_HEAD_DIM or nk > MAX_KEYS or nk % 2:
        raise ValueError(f"{name} on CUDA takes Nq=64, d<={MAX_HEAD_DIM} and an even "
                         f"Nk<={MAX_KEYS}, got Nq={nq}, d={hd}, Nk={nk}")
    if tuple(bias.shape) != (heads, nq, nk):
        raise ValueError(f"{name}: bias wants ({heads}, {nq}, {nk}), got {tuple(bias.shape)}")
    nw = 0
    if mask is not None:
        nw = mask.shape[0]
        if mask.ndim != 3 or tuple(mask.shape[1:]) != (nq, nk) or bw % nw:
            raise ValueError(f"{name}: mask wants (nW, {nq}, {nk}) with nW dividing {bw}, got "
                             f"{tuple(mask.shape)}")
    dev = q.device
    for t in (k, v, bias) + (() if mask is None else (mask,)):
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on q's device")
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    hp, repacked = 0, 0
    if q.dtype == torch.bfloat16:
        hp, repack = gather_plan(q, k, v)
        q, k, v = (repack_heads(t) if r else t for t, r in zip((q, k, v), repack))
        repacked = sum(repack)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        _check(_library().window_attention_run(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ctypes.addressof(strides),
            bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            bw, heads, nq, nk, hd, nw, scale, int(q.dtype == torch.bfloat16), hp,
            _stream(q.device)), "window_attention_run")
    return out, repacked


def window_attention_nomask(q, k, v, bias, *, scale: float) -> torch.Tensor:
    """K11a/K11c: ``softmax(q * scale . k^T + bias) . v`` without a mask.

    CUDA tensors launch the kernel's mask-less instantiation (counted in
    ``window_attention_nomask.launches``; the operands :func:`gather_plan`
    repacks first in ``.repacks``) or raise; CPU tensors take
    :func:`window_attention_reference`. q, k and v may be strided views."""
    if not _on_cuda("window_attention_nomask", q):
        return window_attention_reference(q, k, v, bias, None, scale=scale)
    out, repacked = _launch("window_attention_nomask", q, k, v, bias, None, scale)
    window_attention_nomask.launches += 1
    window_attention_nomask.repacks += repacked
    return out


window_attention_nomask.launches = 0
window_attention_nomask.repacks = 0  # operands copied by repack_heads before a launch


def window_attention_masked(q, k, v, bias, mask, *, scale: float) -> torch.Tensor:
    """K11b: as :func:`window_attention_nomask` plus the ``(nW, Nq, Nk)``
    mask, window b taking ``mask[b % nW]`` (counted in
    ``window_attention_masked.launches``)."""
    if not _on_cuda("window_attention_masked", q):
        return window_attention_reference(q, k, v, bias, mask, scale=scale)
    out, repacked = _launch("window_attention_masked", q, k, v, bias, mask, scale)
    window_attention_masked.launches += 1
    window_attention_masked.repacks += repacked
    return out


window_attention_masked.launches = 0
window_attention_masked.repacks = 0


def window_attention(q, k, v, bias, mask=None, *, scale: float,
                     impl: str = "xla") -> torch.Tensor:
    """Multi-head window attention, ``(Bw, heads, Nq, d)`` out (see the
    module docstring). ``"pallas"`` raises under autograd: the JAX package
    has no gradient for it."""
    if impl == "xla":
        return attention(q * scale, k, v, bias, mask)
    if impl != "pallas":
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    operands = (q, k, v, bias) + (() if mask is None else (mask,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError("window_attention(impl='pallas') is forward-only (the JAX package's "
                           "Pallas attention has no gradient either): run it under "
                           "torch.no_grad() or use impl='xla'")
    if mask is None:
        return window_attention_nomask(q, k, v, bias, scale=scale)
    return window_attention_masked(q, k, v, bias, mask, scale=scale)
