"""K8: the backward of the hybrid's residual dense block, and the differentiable trunk.

Port of ``superresolution_def_tpu/kernels/fused_rdb_cm_bwd.py``:
:func:`fused_rdb_cm_bwd` (``fused_rdb_cm_bwd``) is the VJP of one
channels-major dense block: from x and dy ``(B, F, H*W)`` it gives dx, the
five HWIO weight gradients and the five bias gradients (fp32). On a CUDA
tensor it launches ``csrc/rdb_cm_bwd.cu`` (bf16; F/G = 48/24, 64/32 or 16/8,
any H and W) or raises; on a CPU tensor it runs :func:`rdb_cm_bwd_reference`.
The kernel reads x, x1..x4 as K7 stashed them in the forward
(:func:`~.fused_rdb_cm.fused_rdb_cm` with ``stash``) instead of recomputing
x1..x4 from an 8-row halo as the TPU kernel does.

:class:`DenseBlockFn` is the ``autograd.Function`` whose forward is K7 and
whose backward is K8; :func:`fused_rrdb_trunk_cm_ad` chains the RRDB trunk
through it (the JAX ``fused_rrdb_trunk_cm_ad``). Both kernels' weight layouts
are packed once per change of a block's parameters (once per optimizer
step), not per call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ._build import load_library
from .fused_rdb_cm import (KERNEL_WIDTHS, dense_block_sources, fused_rdb_cm,
                           pack_rdb_cm_weights)
from .swin_block import _check, _on_cuda, _rounder, _stream


def rdb_cm_bwd_reference(xf: torch.Tensor, dy: torch.Tensor, kernels, biases, *, h: int,
                         w: int):
    """Plain PyTorch form of K8 with the TPU kernel's rounding points:
    x1..x4 as the forward rounds them; the gradient stack [m1 m2 m3 m4 d5]
    in fp32 (d5 = 0.2 dy, m_k = lrelu'(x_k) * dx_k), rounded to the io dtype
    only where it enters a product (the transposed convs, the weight
    gradients); db the sums of the fp32 stack; dx = the transposed conv +
    dy in fp32, then rounded. Returns ``(dx, dkernels HWIO fp32, dbiases fp32)``."""
    rnd = _rounder(xf.dtype)
    b, f, _ = xf.shape
    g = kernels[0].shape[-1]
    srcs, _ = dense_block_sources(xf, kernels, biases, h=h, w=w)
    weights = [rnd(k.float()).permute(3, 2, 0, 1) for k in kernels]  # OIHW
    acc = torch.zeros(b, f + 4 * g, h, w, device=xf.device)
    stack = [None] * 4 + [dy.reshape(b, f, h, w).float() * 0.2]
    for j in range(4, -1, -1):  # conv j+1 sends its gradient to the sources it reads
        acc[:, : f + j * g] += F.conv_transpose2d(rnd(stack[j]), weights[j], padding=1)
        if j:  # x_j's gradient is complete: no conv before j+1 reads it
            xj = srcs[j]
            stack[j - 1] = torch.where(xj >= 0, 1.0, 0.2) * acc[:, f + (j - 1) * g: f + j * g]
    dx = (acc[:, :f] + dy.reshape(b, f, h, w).float()).to(xf.dtype).reshape(b, f, h * w)
    cat = torch.cat(srcs, 1)
    dkernels = [torch.nn.grad.conv2d_weight(cat[:, : f + j * g], weights[j].shape,
                                            rnd(stack[j]), padding=1).permute(2, 3, 1, 0)
                for j in range(5)]
    return dx, dkernels, [m.sum((0, 2, 3)) for m in stack]


@functools.cache
def bwd_fragment_index(f: int, g: int) -> tuple[np.ndarray, tuple[int, ...]]:
    """Index into the five HWIO weights, flattened and concatenated conv1..
    conv5, of each bf16 of K8's packed weights, and the word (2 x bf16)
    offset of each part: ``offsets[0]`` the dx kernel's k steps,
    ``offsets[1..4]`` the stack kernel's fragments of m1..m4.

    dx's part (the transposed conv of the whole stack [m1 m2 m3 m4 d5] into
    x): per 16 stack channels (a wgmma k step), per tap t, the F x 16 matrix
    in the interleaved K-major layout, ``[F/8][2][8][8]`` = (8 output
    channels, 8 stack channels) core matrices; entry (output n, stack
    channel c) is ``W_j[8 - t][n][o]`` for the conv j whose gradient stack
    channel c is (output o of it).

    m_K's part (K = 1..4: the transposed conv into level K reads levels
    K+1..5, the gradients of convs K+1..5): taps t, then levels, then
    16-channel chunks of the level (an 8-channel chunk last), then the G/8
    n8-tiles, then the 32 lanes: lane (g = l / 4, t = l % 4) of an
    m16n8k16 B fragment holds rows 2t, 2t+1, 2t+8, 2t+9 of column g
    (m16n8k8: rows 2t, 2t+1).
    Entry (row n, column c) at tap t of level l is conv l's weight
    ``W_l[8 - t][c_K + c][n]``: the taps flipped, in and out swapped.
    """
    lane = np.arange(32)
    gq, tig = lane // 4, lane % 4
    k16 = np.stack([2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9], -1)  # (32, 4)
    k8 = np.stack([2 * tig, 2 * tig + 1], -1)                             # (32, 2)
    cin = [f + i * g for i in range(5)]
    cout = [g] * 4 + [f]
    base = np.cumsum([0] + [9 * cin[i] * cout[i] for i in range(5)])
    # dx: (k step, tap, n8, c8, n % 8, c % 8)
    n = (np.arange(f // 8).reshape(1, 1, -1, 1, 1, 1) * 8
         + np.arange(8).reshape(1, 1, 1, 1, 8, 1))
    c = (np.arange((f + 4 * g) // 16).reshape(-1, 1, 1, 1, 1, 1) * 16
         + np.arange(2).reshape(1, 1, 1, 2, 1, 1) * 8 + np.arange(8).reshape(1, 1, 1, 1, 1, 8))
    tap = np.arange(9).reshape(1, -1, 1, 1, 1, 1)
    conv = np.where(c < 4 * g, c // g, 4)
    o = np.where(c < 4 * g, c % g, c - 4 * g)
    cin_a, cout_a = np.asarray(cin)[conv], np.asarray(cout)[conv]
    dx_idx = base[conv] + ((8 - tap) * cin_a + n) * cout_a + o
    index, offsets, total = [dx_idx.reshape(-1)], [0], dx_idx.size
    for k in range(1, 5):
        c0 = f + (k - 1) * g  # source k's first input channel
        col = c0 + np.arange(g // 8)[:, None, None] * 8 + gq[None, :, None]
        parts = []
        for tap in range(9):
            for i in range(k, 5):  # conv i+1, level i+1
                k0 = 0
                while k0 < cout[i]:
                    kk = k16 if k0 + 16 <= cout[i] else k8
                    nn = k0 + kk[None]
                    parts.append((base[i] + ((8 - tap) * cin[i] + col) * cout[i] + nn)
                                 .reshape(-1))
                    k0 += 16 if kk is k16 else 8
        idx = np.concatenate(parts)
        assert idx.size == 9 * (f + (4 - k) * g) * g
        index.append(idx)
        offsets.append(total // 2)
        total += idx.size
    return np.concatenate(index), tuple(offsets)


@functools.cache
def _device_index(f: int, g: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bwd_fragment_index(f, g)[0]).to(device)


def pack_rdb_bwd_weights(kernels, device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """The five HWIO weights in K8's packed order (bf16,
    :func:`bwd_fragment_index`) and each part's word offset."""
    f, g = kernels[0].shape[2], kernels[0].shape[3]
    device = torch.device(device)
    flat = torch.cat([k.to(device, torch.bfloat16).reshape(-1) for k in kernels])
    return flat[_device_index(f, g, device)].contiguous(), bwd_fragment_index(f, g)[1]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("rdb_cm_bwd")
    lib.rdb_cm_bwd_scratch.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rdb_cm_bwd_scratch.restype = ctypes.c_int
    lib.rdb_cm_bwd_bf16.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rdb_cm_bwd_bf16.restype = ctypes.c_int
    lib.rdb_cm_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rdb_cm_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def fused_rdb_cm_bwd(xf: torch.Tensor, dy: torch.Tensor, kernels, biases, *, h: int, w: int,
                     stash: torch.Tensor | None = None, packed: tuple | None = None):
    """K8: the VJP of one dense block. ``xf``/``dy``: ``(B, F, H*W)``;
    ``kernels``/``biases`` as :func:`~.fused_rdb_cm.fused_rdb_cm` takes them.
    Returns ``(dx, dkernels, dbiases)``: dx in the io dtype, the HWIO weight
    and the bias gradients in fp32.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_rdb_cm_bwd.launches``) or raise; they need ``stash``, the
    ``(B, H*W, F + 4G)`` x, x1..x4 that K7 wrote in the forward. CPU tensors take
    :func:`rdb_cm_bwd_reference`. ``packed``: the weights already through
    :func:`pack_rdb_bwd_weights` on the activation's device.
    """
    name = "fused_rdb_cm_bwd"
    if not _on_cuda(name, xf):
        return rdb_cm_bwd_reference(xf, dy, kernels, biases, h=h, w=w)
    bsz, f, hw = xf.shape
    g = kernels[0].shape[-1]
    if xf.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes bfloat16 x and dy, got {xf.dtype}, {dy.dtype}")
    if hw != h * w or dy.shape != xf.shape:
        raise ValueError(f"{name}: x {tuple(xf.shape)} and dy {tuple(dy.shape)} are not "
                         f"({bsz}, {f}, {h}x{w})")
    if (f, g) not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: widths F={f}, G={g} are not compiled; the kernel takes "
                         f"(F, G) in {sorted(KERNEL_WIDTHS)}")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        cout = g if i < 4 else f
        if tuple(k.shape) != (3, 3, f + i * g, cout) or tuple(b.shape) != (cout,):
            raise ValueError(f"{name}: conv{i + 1} wants (3, 3, {f + i * g}, {cout}) and "
                             f"({cout},), got {tuple(k.shape)} and {tuple(b.shape)}")
        if k.device != xf.device or b.device != xf.device:
            raise ValueError(f"{name}: every operand must be on the activation's device")
    if stash is None:
        raise ValueError(f"{name} on CUDA reads x1..x4 as K7 stashed them: pass stash")
    if (stash.shape != (bsz, hw, f + 4 * g) or stash.dtype != torch.bfloat16
            or stash.device != xf.device or not stash.is_contiguous()):
        raise ValueError(f"{name}: stash must be a contiguous ({bsz}, {hw}, {f + 4 * g}) "
                         f"bfloat16 tensor on the activation's device")
    lib = _library()
    wfrag, offsets = packed or pack_rdb_bwd_weights(kernels, xf.device)
    sizes = (ctypes.c_longlong * 3)()
    _check(lib.rdb_cm_bwd_scratch(f, g, bsz, h, w, ctypes.addressof(sizes)), "rdb_cm_bwd_scratch")
    dyc = dy.contiguous()
    dev = dyc.device
    gstack = torch.empty(sizes[0], dtype=torch.bfloat16, device=dev)
    dbpart = torch.empty(sizes[1], dtype=torch.float32, device=dev)
    part = torch.empty(sizes[2], dtype=torch.float32, device=dev)
    dx = torch.empty_like(dyc)
    numel = [9 * (f + i * g) * (g if i < 4 else f) for i in range(5)]
    dw = torch.empty(sum(numel), dtype=torch.float32, device=dev)
    db = torch.empty(f + 4 * g, dtype=torch.float32, device=dev)
    woff = (ctypes.c_int * 5)(*offsets)
    with torch.cuda.device(dev):
        _check(lib.rdb_cm_bwd_bf16(dyc.data_ptr(), stash.data_ptr(),
                                   wfrag.data_ptr(), ctypes.addressof(woff), dx.data_ptr(),
                                   dw.data_ptr(), db.data_ptr(), gstack.data_ptr(),
                                   dbpart.data_ptr(), part.data_ptr(), bsz, f, g, h, w,
                                   _stream(dev)), "rdb_cm_bwd_bf16")
    fused_rdb_cm_bwd.launches += 1
    dkernels = [t.view(k.shape) for t, k in zip(dw.split(numel), kernels)]
    return dx, dkernels, list(db.split([g] * 4 + [f]))


fused_rdb_cm_bwd.launches = 0

# per dense block (keyed by its conv1 weight): the parameters' versions and
# the packed K7 and K8 weights made from them
_PACKS = WeakIdKeyDictionary()


def dense_block_packs(weights, biases) -> tuple:
    """K7's and K8's packed weights of a dense block on the card, remade only
    when a parameter has changed (its ``_version``: once per optimizer step,
    however many micro-batches use them)."""
    versions = tuple(t._version for t in (*weights, *biases))
    hit = _PACKS.get(weights[0])
    if hit is not None and hit[0] == versions:
        return hit[1]
    with torch.no_grad():
        kernels = [wt.detach().permute(2, 3, 1, 0) for wt in weights]
        device = kernels[0].device
        packs = (pack_rdb_cm_weights(kernels, [b.detach() for b in biases], device),
                 pack_rdb_bwd_weights(kernels, device))
    _PACKS[weights[0]] = (versions, packs)
    return packs


class DenseBlockFn(torch.autograd.Function):
    """One dense block with K7 as its forward and K8 as its backward (the
    JAX ``make_rdb_cm_ad``). Inputs: ``(B, F, H*W)`` x, then the five convs'
    OIHW weights and their biases, the fp32 master parameters (rounded to
    the io dtype inside), whose gradients come back in fp32. On the CPU the
    plain versions run."""

    @staticmethod
    def forward(ctx, xf, h, w, packs, *params):
        weights, biases = params[:5], params[5:]
        kernels = [wt.permute(2, 3, 1, 0) for wt in weights]
        ctx.stash = None
        if xf.is_cuda:
            bsz, f, hw = xf.shape
            ctx.stash = torch.empty(bsz, hw, f + 4 * kernels[0].shape[-1],
                                    dtype=torch.bfloat16, device=xf.device)
        out = fused_rdb_cm(xf, kernels, biases, h=h, w=w, packed=packs and packs[0],
                           stash=ctx.stash)
        ctx.save_for_backward(xf, *params)
        ctx.hw, ctx.packs = (h, w), packs
        return out

    @staticmethod
    def backward(ctx, dy):
        xf, *params = ctx.saved_tensors
        weights, biases = params[:5], params[5:]
        kernels = [wt.permute(2, 3, 1, 0) for wt in weights]
        h, w = ctx.hw
        dx, dks, dbs = fused_rdb_cm_bwd(xf, dy.contiguous(), kernels, biases, h=h, w=w,
                                        stash=ctx.stash, packed=ctx.packs and ctx.packs[1])
        ctx.stash = None
        return (dx, None, None, None, *[dk.permute(3, 2, 0, 1) for dk in dks], *dbs)


def dense_block_ad(xf: torch.Tensor, weights, biases, *, h: int, w: int) -> torch.Tensor:
    """One differentiable dense block (K7 forward, K8 backward). Under
    ``torch.no_grad`` it runs K7 alone, with no stash."""
    packs = dense_block_packs(weights, biases) if xf.is_cuda else None
    if not torch.is_grad_enabled():
        kernels = [wt.permute(2, 3, 1, 0) for wt in weights]
        return fused_rdb_cm(xf, kernels, biases, h=h, w=w, packed=packs and packs[0])
    return DenseBlockFn.apply(xf, h, w, packs, *weights, *biases)


def fused_rrdb_trunk_cm_ad(rrdbs, x: torch.Tensor) -> torch.Tensor:
    """The differentiable RRDB trunk channels-major. ``x``: ``(B, H, W, F)``
    NHWC in and out; ``rrdbs``: per RRDB three dense blocks, each
    ``(weights, biases)`` with the five convs' OIHW master weights. The trunk
    stays ``(B, F, H*W)`` between blocks, and each RRDB's residual
    ``u * 0.2 + t`` is taken in the io dtype, as the JAX trunk takes it."""
    b, h, w, f = x.shape
    t = x.permute(0, 3, 1, 2).reshape(b, f, h * w)
    for blocks in rrdbs:
        u = t
        for weights, biases in blocks:
            u = dense_block_ad(u, weights, biases, h=h, w=w)
        t = u * 0.2 + t
    return t.reshape(b, f, h, w).permute(0, 2, 3, 1)
