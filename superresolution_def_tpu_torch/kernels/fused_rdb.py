"""K12: the hybrid's residual dense block, channel-last, as a Hopper kernel.

Port of ``superresolution_def_tpu/kernels/fused_rdb.py``: :func:`fused_rdb`
(``fused_rdb``) runs one dense block on an NHWC ``(B, H, W, F)`` activation
with the reference's HWIO conv1..conv5 weights, and :func:`fused_rrdb_trunk`
(``fused_rrdb_trunk``) chains the whole RRDB trunk in that layout. On a CUDA
tensor :func:`fused_rdb` launches ``csrc/fused_rdb.cu`` (bf16; F/G = 48/24,
64/32 or 16/8, any H and W) or raises; on a CPU tensor it runs
:func:`rdb_nhwc_reference`. The JAX function's ``tile_h``, ``tile_w`` and
``tap_matmul`` switch among TPU formulations of the same function (VMEM
tile sizes, im2col or per-tap products); the Hopper kernel picks its own
tile and takes no such switch. K12 runs K7's conv kernels
(``csrc/rdb_conv.cuh``) on K7's packing
(:func:`~.fused_rdb_cm.pack_rdb_cm_weights`), reading x in place through a
tensor map of its own (:func:`nhwc_k_steps`): the two run the same products
in the same order, so they give the same bits, and differ only in where x
is read and out is written.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import load_library
from .fused_rdb_cm import KERNEL_WIDTHS, cm_k_starts, pack_rdb_cm_weights, rdb_cm_reference
from .swin_block import _check, _on_cuda, _stream


def rdb_nhwc_reference(x: torch.Tensor, kernels, biases) -> torch.Tensor:
    """Plain PyTorch form of K12: :func:`~.fused_rdb_cm.rdb_cm_reference`
    through a layout change, with the same rounding points as the TPU kernel
    (fp32 sums; x1..x4 = lrelu(sum + bias) rounded to the io dtype; out =
    (sum + b5) * 0.2 + x in fp32, then rounded)."""
    b, h, w, f = x.shape
    out = rdb_cm_reference(x.permute(0, 3, 1, 2).reshape(b, f, h * w), kernels, biases,
                           h=h, w=w)
    return out.reshape(b, f, h, w).permute(0, 2, 3, 1).contiguous()


def nhwc_k_steps(f: int, g: int) -> list[list[tuple[str, int]]]:
    """Per conv, where each of K12's 16-channel k steps reads its input
    channels: ``("x", c)`` from the activation's channel ``c`` on, or
    ``("scratch", c)`` from the scratch's channel ``c`` on (x1..x4, 4G
    channels; ``c`` may be -8, whose first 8 channels read as zeros). The
    steps are K7's (:func:`~.fused_rdb_cm.cm_k_starts` over the
    concatenated sources), so K7's packing serves both kernels; a step lies
    on the x map while it fits inside x's F channels. The kernel's
    ``step_group`` (``csrc/rdb_conv.cuh``) computes the same."""
    return [[("x", s) if s + 16 <= f else ("scratch", s - f)
             for s in cm_k_starts(f + i * g)] for i in range(5)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("fused_rdb")
    lib.rdb_nhwc_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.rdb_nhwc_bf16.restype = ctypes.c_int
    lib.rdb_nhwc_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rdb_nhwc_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(f: int, g: int) -> list[int]:
    """Dynamic shared memory of K12's five conv kernels at widths F/G."""
    out = (ctypes.c_longlong * 5)()
    _check(_library().rdb_nhwc_smem_bytes(f, g, ctypes.addressof(out)), "rdb_nhwc_smem_bytes")
    return list(out)


def fused_rdb(x: torch.Tensor, kernels, biases, *, packed: tuple | None = None) -> torch.Tensor:
    """K12: one dense block on ``(B, H, W, F)`` -> ``(B, H, W, F)``.

    ``kernels``/``biases``: the reference's HWIO conv1..conv5 weights
    ``(3, 3, F + (i-1)G, G)`` (conv5 ``-> F``) and their biases. CUDA tensors
    launch the Hopper kernel (counted in ``fused_rdb.launches``) or raise;
    CPU tensors take :func:`rdb_nhwc_reference`. ``packed``: the weights
    already through :func:`~.fused_rdb_cm.pack_rdb_cm_weights` on the
    activation's device. The kernel writes x1..x4 into a ``(B, H*W, 4G)``
    scratch that it allocates on every call.
    """
    if not _on_cuda("fused_rdb", x):
        return rdb_nhwc_reference(x, kernels, biases)
    name = "fused_rdb"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} on CUDA takes a bfloat16 activation, got {x.dtype}")
    bsz, h, w, f = x.shape
    g = kernels[0].shape[-1]
    if (f, g) not in KERNEL_WIDTHS:
        raise ValueError(f"{name}: widths F={f}, G={g} are not compiled; the kernel takes "
                         f"(F, G) in {sorted(KERNEL_WIDTHS)}")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        cout = g if i < 4 else f
        if tuple(k.shape) != (3, 3, f + i * g, cout) or tuple(b.shape) != (cout,):
            raise ValueError(f"{name}: conv{i + 1} wants (3, 3, {f + i * g}, {cout}) and "
                             f"({cout},), got {tuple(k.shape)} and {tuple(b.shape)}")
        if k.device != x.device or b.device != x.device:
            raise ValueError(f"{name}: every operand must be on the activation's device")
    lib = _library()
    wpack, offsets, bias = packed or pack_rdb_cm_weights(kernels, biases, x.device)
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x by TMA and in 16-byte runs
        x = x.clone()
    out = torch.empty_like(x)
    scratch = torch.empty(bsz, h * w, 4 * g, dtype=torch.bfloat16, device=x.device)
    woff = (ctypes.c_int * 5)(*offsets)
    with torch.cuda.device(x.device):
        _check(lib.rdb_nhwc_bf16(x.data_ptr(), wpack.data_ptr(), ctypes.addressof(woff),
                                 bias.data_ptr(), out.data_ptr(), scratch.data_ptr(), bsz, f, g,
                                 h, w, _stream(x.device)), "rdb_nhwc_bf16")
    fused_rdb.launches += 1
    return out


fused_rdb.launches = 0


def fused_rrdb_trunk(rrdbs, x: torch.Tensor, dense_block=fused_rdb) -> torch.Tensor:
    """The whole RRDB trunk channel-last (the JAX ``fused_rrdb_trunk``).
    ``x``: ``(B, H, W, F)`` in and out; ``rrdbs``: per RRDB three dense
    blocks, each ``(kernels, biases, packed)`` with ``packed`` from
    :func:`~.fused_rdb_cm.pack_rdb_cm_weights` or None. Each RRDB's residual
    ``u * 0.2 + t`` is taken in the io dtype. ``dense_block(u, kernels,
    biases, packed=...)`` runs one block: K12 unless a caller passes another
    NHWC form of it."""
    t = x
    for blocks in rrdbs:
        u = t
        for kernels, biases, packed in blocks:
            u = dense_block(u, kernels, biases, packed=packed)
        t = u * 0.2 + t
    return t
