"""K5: HAT's hybrid attention block (HAB) as a hand-written Hopper kernel.

Port of ``superresolution_def_tpu/kernels/swin_block.py::fused_hab_block``.
:func:`fused_hab_block` keeps the JAX argument layout (pre-rolled,
pre-partitioned ``(Bw, 64, C)`` windows of x and of the CAB branch conv_x,
weights ``(in, out)``, the relative-position bias gathered into
``(heads, 64, 64)`` fp32) with one change: the shift mask is the
``(nW, 64, 64)`` mask of one image, window w using ``mask[w mod nW]`` (the JAX
package tiles the same mask over the batch), or ``None`` for an unshifted
block. On a CUDA tensor it launches ``csrc/hab_block.cu`` (bf16, N = 64) or
raises; on a CPU tensor it runs :func:`hab_block_reference`.

HAT's C = 90 with six heads of 15 does not fit the kernel's 4-element
copies, so the wrapper zero-pads each head to an even width (a multiple of 4
when the head count is odd) and the weights' channel rows to match; the
windows keep their C columns and LayerNorm its statistics over them.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library
from .swin_block import (
    MAX_SMEM_BYTES,
    _check,
    _check_windows,
    _gelu,
    _ln_f32,
    _on_cuda,
    _qkv_heads,
    _rounder,
    _softmax_f32,
    _stream,
)


def hab_block_reference(
    x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
    ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float, conv_scale: float = 0.01,
) -> torch.Tensor:
    """Plain PyTorch form of K5, with the TPU kernel's rounding points.

    As :func:`~.swin_block.swin_block_reference` (products of operands rounded
    to the io dtype with fp32 sums, fp32 LayerNorm, softmax and residuals, LN2
    reading h rounded to the io dtype, tanh GELU for bf16), plus the mask
    added to every head's scores after the bias and
    h = x + proj + conv_scale * conv_x.
    """
    dt = x_windows.dtype
    bw, n, c = x_windows.shape
    rnd = _rounder(dt)
    x = x_windows.float()
    q, k, v = _qkv_heads(rnd(_ln_f32(x, ln1_w, ln1_b)), wqkv, bqkv, num_heads, rnd)
    q = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
    s = torch.matmul(q, k.transpose(-1, -2)) + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, num_heads, n, n) + mask.float()[None, :, None]).reshape(
            bw, num_heads, n, n)
    o = torch.matmul(rnd(_softmax_f32(s)), v).permute(0, 2, 1, 3).reshape(bw, n, c)
    h = x + (torch.matmul(rnd(o), wproj.float()) + bproj.float()) + conv_scale * convx_windows.float()
    m = _gelu(torch.matmul(rnd(_ln_f32(rnd(h), ln2_w, ln2_b)), w1.float()) + b1.float(), dt)
    m = torch.matmul(rnd(m), w2.float()) + b2.float()
    return (h + m).to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("hab_block")
    lib.hab_block_bf16.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.hab_block_bf16.restype = ctypes.c_int
    lib.hab_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hab_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def padded_head_dim(head_dim: int, num_heads: int) -> int:
    """The kernel's head width: even, and a multiple of 4 for an odd head count."""
    hdp = head_dim + head_dim % 2
    if num_heads % 2 and hdp % 4:
        hdp += 2
    return hdp


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    return F.pad(t, (0, size - t.shape[-1]))


def _pad_heads(t: torch.Tensor, heads: int, hd: int, hdp: int) -> torch.Tensor:
    """Pad each head's hd columns of the last axis (heads * hd) to hdp."""
    return _pad_last(t.reshape(*t.shape[:-1], heads, hd), hdp).reshape(*t.shape[:-1], heads * hdp)


def pad_hab_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     num_heads: int) -> tuple:
    """The twelve weight operands as the kernel takes them: each head's q/k/v
    columns zero-padded to :func:`padded_head_dim` and the channel rows and
    columns to heads x that width; vectors fp32, all contiguous. A caller
    that runs the same block often pads once and passes the result to
    :func:`fused_hab_block` as ``padded``."""
    c = wqkv.shape[0]
    hd = c // num_heads
    hdp = padded_head_dim(hd, num_heads)
    cp = num_heads * hdp
    f32 = torch.float32
    wqkv_p = _pad_heads(wqkv.reshape(c, 3, c), num_heads, hd, hdp).reshape(c, 3 * cp)
    bqkv_p = _pad_heads(bqkv.to(f32).reshape(3, c), num_heads, hd, hdp).reshape(-1)
    wproj_p = _pad_last(_pad_heads(wproj.T, num_heads, hd, hdp).T, cp)  # rows: attention channels
    vec = [_pad_last(v.to(f32), cp) for v in (ln1_w, ln1_b, bproj, ln2_w, ln2_b, b2)]
    out = (vec[0], vec[1], F.pad(wqkv_p, (0, 0, 0, cp - c)), bqkv_p, wproj_p, vec[2], vec[3],
           vec[4], F.pad(w1, (0, 0, 0, cp - c)), b1.to(f32), _pad_last(w2, cp), vec[5])
    return tuple(t.contiguous() for t in out)


def fused_hab_block(
    x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
    ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float, conv_scale: float = 0.01,
    padded: tuple | None = None,
) -> torch.Tensor:
    """K5: one HAB over ``(Bw, 64, C)`` windows -> ``(Bw, 64, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_hab_block.launches``) or raise; CPU tensors take
    :func:`hab_block_reference`. ``padded``: the weights already through
    :func:`pad_hab_operands` (the others are still checked).
    """
    args = (x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
            ln2_w, ln2_b, w1, b1, w2, b2)
    kw = dict(num_heads=num_heads, scale=scale, conv_scale=conv_scale)
    if not _on_cuda("fused_hab_block", x_windows):
        return hab_block_reference(*args, **kw)
    name = "fused_hab_block"
    bw, n, c = _check_windows(name, x_windows, convx_windows)
    hidden = w1.shape[1]
    hd = c // num_heads
    hdp = padded_head_dim(hd, num_heads)
    cp = num_heads * hdp
    if c % num_heads or c % 2 or hdp > 32 or cp > 256 or hidden % 4:
        raise ValueError(f"{name}: unsupported widths C={c}, {num_heads} heads, hidden={hidden}")
    want = {"wqkv": (c, 3 * c), "wproj": (c, c), "w1": (c, hidden), "w2": (hidden, c)}
    for key, w in dict(wqkv=wqkv, wproj=wproj, w1=w1, w2=w2).items():
        if tuple(w.shape) != want[key] or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} wants bfloat16 {want[key]}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    sizes = dict(ln1_w=c, ln1_b=c, bqkv=3 * c, bproj=c, ln2_w=c, ln2_b=c, b1=hidden, b2=c)
    vectors = dict(ln1_w=ln1_w, ln1_b=ln1_b, bqkv=bqkv, bproj=bproj, ln2_w=ln2_w, ln2_b=ln2_b,
                   b1=b1, b2=b2)
    for key, v in vectors.items():
        if tuple(v.shape) != (sizes[key],):
            raise ValueError(f"{name}: {key} wants ({sizes[key]},), got {tuple(v.shape)}")
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"{name}: bias wants {(num_heads, n, n)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"{name}: mask wants (nW, {n}, {n}) with Bw a multiple of nW, got "
                         f"{tuple(mask.shape)}")
    others = [bias, *vectors.values(), wqkv, wproj, w1, w2] + ([mask] if mask is not None else [])
    if any(t.device != x_windows.device for t in others):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    lib = _library()
    if lib.hab_block_smem_bytes(cp, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")

    if padded is None:
        padded = pad_hab_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1,
                                  w2, b2, num_heads=num_heads)
    x = x_windows.contiguous()
    convx = convx_windows.contiguous()
    bias = bias.float().contiguous()
    mask_t = mask.float().contiguous() if mask is not None else None
    if x.data_ptr() % 16 or convx.data_ptr() % 4:
        raise ValueError(f"{name}: windows must be 16-byte aligned")
    out = torch.empty_like(x)
    ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2 = padded
    ptrs = [x.data_ptr(), convx.data_ptr(), mask_t.data_ptr() if mask_t is not None else None,
            *(t.data_ptr() for t in (ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
                                     w1, b1, w2, b2)), out.data_ptr()]
    nw = mask.shape[0] if mask is not None else 1
    with torch.cuda.device(x.device):
        _check(lib.hab_block_bf16(*ptrs, bw, cp, c, num_heads, hidden, nw, float(scale),
                                  float(conv_scale), _stream(x.device)), "hab_block_bf16")
    fused_hab_block.launches += 1
    return out


fused_hab_block.launches = 0
