"""K7: the hybrid's residual dense block, channels-major, as a Hopper kernel.

Port of ``superresolution_def_tpu/kernels/fused_rdb_cm.py``:
:func:`fused_rdb_cm` (``fused_rdb_cm``) runs one dense block on a
``(B, F, H*W)`` activation with the reference's HWIO conv1..conv5 weights,
and :func:`fused_rrdb_trunk_cm` (``fused_rrdb_trunk_cm``) chains the whole
RRDB trunk in that layout. On a CUDA tensor :func:`fused_rdb_cm` launches
``csrc/rdb_cm.cu`` (bf16; F/G = 48/24, 64/32 or 16/8, any H and W) or
raises; on a CPU tensor it runs :func:`rdb_cm_reference`. Unlike the JAX
package, which falls back to an XLA dense block when W is not a multiple of
128, the kernel takes every width.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ._build import load_library
from .swin_block import _check, _on_cuda, _rounder, _stream

KERNEL_WIDTHS = {(48, 24), (64, 32), (16, 8)}  # (F, G) the kernel is compiled for


def rdb_cm_reference(xf: torch.Tensor, kernels, biases, *, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch form of K7: five ``F.conv2d`` calls on the concatenated
    sources, with the TPU kernel's rounding points (fp32 sums; x1..x4 =
    lrelu(sum + bias) rounded to the io dtype; out = (sum + b5) * 0.2 + x in
    fp32, then rounded). Weights are rounded to the io dtype first."""
    srcs, y = dense_block_sources(xf, kernels, biases, h=h, w=w)
    b, f, _ = xf.shape
    return (y * 0.2 + srcs[0]).to(xf.dtype).reshape(b, f, h * w)


def dense_block_sources(xf: torch.Tensor, kernels, biases, *, h: int, w: int):
    """x, x1..x4 as fp32 NCHW holding io-dtype values, and conv5's fp32
    ``sum + b5``: the forward of :func:`rdb_cm_reference` up to its output."""
    rnd = _rounder(xf.dtype)
    b, f, _ = xf.shape
    srcs = [xf.reshape(b, f, h, w).float()]
    for i in range(5):
        wt = rnd(kernels[i].float()).permute(3, 2, 0, 1)  # HWIO -> OIHW
        y = F.conv2d(torch.cat(srcs, 1), wt, padding=1) + biases[i].float()[None, :, None, None]
        if i < 4:
            srcs.append(rnd(F.leaky_relu(y, 0.2)))
    return srcs, y


@functools.cache
def fragment_index(f: int, g: int) -> tuple[tuple[np.ndarray, ...], tuple[int, ...]]:
    """Per conv, the flat HWIO index of each bf16 of its B fragments in the
    kernel's order, and each conv's word (2 x bf16) offset.

    Order: groups of G output channels (conv5 has F / G of them; the kernel
    stages one group at a time in shared memory), then taps (ky, kx), then
    sources x, x1, .., then 16-channel chunks (an 8-channel chunk last when a
    source's width is not a multiple of 16), then the group's n8-tiles, then
    the 32 lanes; lane (g = l / 4, t = l % 4) of an m16n8k16 fragment holds
    rows 2t, 2t+1, 2t+8, 2t+9 of column g (m16n8k8: rows 2t, 2t+1).
    """
    lane = np.arange(32)
    gq, tig = lane // 4, lane % 4
    k16 = np.stack([2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9], -1)  # (32, 4)
    k8 = np.stack([2 * tig, 2 * tig + 1], -1)                             # (32, 2)
    index, offsets, total = [], [], 0
    for i in range(5):
        cin, cout = f + i * g, (g if i < 4 else f)
        parts = []
        for grp in range(cout // g):
            n = (grp * g + np.arange(g // 8)[:, None, None] * 8) + gq[None, :, None]  # (NTU, 32, 1)
            for tap in range(9):
                for s in range(i + 1):
                    base, cs = (0, f) if s == 0 else (f + (s - 1) * g, g)
                    k0 = 0
                    while k0 < cs:
                        kk = k16 if k0 + 16 <= cs else k8
                        rows = base + k0 + kk[None]                       # (1, 32, kw)
                        parts.append(((tap * cin + rows) * cout + n).reshape(-1))
                        k0 += 16 if kk is k16 else 8
        idx = np.concatenate(parts)
        assert idx.size == 9 * cin * cout
        index.append(idx)
        offsets.append(total // 2)
        total += idx.size
    return tuple(index), tuple(offsets)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("rdb_cm")
    lib.rdb_cm_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rdb_cm_bf16.restype = ctypes.c_int
    return lib


@functools.cache
def _device_index(f: int, g: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(idx).to(device) for idx in fragment_index(f, g)[0])


def pack_rdb_weights(kernels, biases, device) -> tuple[torch.Tensor, tuple[int, ...], torch.Tensor]:
    """The five HWIO weights in the kernel's B-fragment order (bf16), each
    conv's word offset, and b1..b5 concatenated in fp32."""
    f, g = kernels[0].shape[2], kernels[0].shape[3]
    device = torch.device(device)
    frags = [k.to(device, torch.bfloat16).reshape(-1)[idx]
             for k, idx in zip(kernels, _device_index(f, g, device))]
    offsets = fragment_index(f, g)[1]
    bias = torch.cat([b.to(device, torch.float32).reshape(-1) for b in biases])
    return torch.cat(frags).contiguous(), offsets, bias.contiguous()


def fused_rdb_cm(xf: torch.Tensor, kernels, biases, *, h: int, w: int,
                 packed: tuple | None = None, stash: torch.Tensor | None = None) -> torch.Tensor:
    """K7: one dense block on ``(B, F, H*W)`` -> ``(B, F, H*W)``.

    ``kernels``/``biases``: the reference's HWIO conv1..conv5 weights
    ``(3, 3, F + (i-1)G, G)`` (conv5 ``-> F``) and their biases. CUDA tensors
    launch the Hopper kernel (counted in ``fused_rdb_cm.launches``) or raise;
    CPU tensors take :func:`rdb_cm_reference`. ``packed``: the weights
    already through :func:`pack_rdb_weights` on the activation's device.
    ``stash``: a ``(B, H*W, F + 4G)`` bf16 tensor that the kernel fills with
    x, x1..x4 pixel-major for the backward (K8); the CPU path leaves it
    untouched.
    """
    if not _on_cuda("fused_rdb_cm", xf):
        return rdb_cm_reference(xf, kernels, biases, h=h, w=w)
    name = "fused_rdb_cm"
    if xf.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes a bfloat16 activation, got {xf.dtype}")
    bsz, f, hw = xf.shape
    g = kernels[0].shape[-1]
    if hw != h * w:
        raise ValueError(f"{name}: activation of {hw} pixels is not {h}x{w}")
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
    if stash is not None and (stash.shape != (bsz, hw, f + 4 * g)
                              or stash.dtype != torch.bfloat16 or stash.device != xf.device
                              or not stash.is_contiguous()):
        raise ValueError(f"{name}: stash must be a contiguous ({bsz}, {hw}, {f + 4 * g}) "
                         f"bfloat16 tensor on the activation's device")
    lib = _library()
    wfrag, offsets, bias = packed or pack_rdb_weights(kernels, biases, xf.device)
    x = xf.contiguous()
    out = torch.empty_like(x)
    woff = (ctypes.c_int * 5)(*offsets)
    with torch.cuda.device(x.device):
        _check(lib.rdb_cm_bf16(x.data_ptr(), wfrag.data_ptr(), ctypes.addressof(woff),
                               bias.data_ptr(), out.data_ptr(),
                               None if stash is None else stash.data_ptr(), bsz, f, g, h, w,
                               _stream(x.device)), "rdb_cm_bf16")
    fused_rdb_cm.launches += 1
    return out


fused_rdb_cm.launches = 0


def fused_rrdb_trunk_cm(rrdbs, x: torch.Tensor) -> torch.Tensor:
    """The whole RRDB trunk channels-major. ``x``: ``(B, H, W, F)`` NHWC in
    and out; ``rrdbs``: per RRDB three dense blocks, each ``(kernels,
    biases, packed)`` with ``packed`` from :func:`pack_rdb_weights` or None.
    The trunk stays ``(B, F, H*W)`` between blocks (one transpose each way),
    and each RRDB's residual ``u * 0.2 + t`` is taken in the io dtype."""
    b, h, w, f = x.shape
    t = x.permute(0, 3, 1, 2).reshape(b, f, h * w)
    for blocks in rrdbs:
        u = t
        for kernels, biases, packed in blocks:
            u = fused_rdb_cm(u, kernels, biases, h=h, w=w, packed=packed)
        t = u * 0.2 + t
    return t.reshape(b, f, h, w).permute(0, 2, 3, 1)
