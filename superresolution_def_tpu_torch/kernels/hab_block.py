"""K5: HAT's hybrid attention block (HAB) as a hand-written Hopper kernel.

Port of ``superresolution_def_tpu/kernels/swin_block.py::fused_hab_block``.
:func:`fused_hab_block` keeps the JAX argument layout (pre-rolled,
pre-partitioned ``(Bw, 64, C)`` windows of x and of the CAB branch conv_x,
weights ``(in, out)``, the relative-position bias gathered into
``(heads, 64, 64)`` fp32) with one change: the shift mask is the
``(nW, 64, 64)`` mask of one image, window w using ``mask[w mod nW]`` (the JAX
package tiles the same mask over the batch), or ``None`` for an unshifted
block. On a CUDA tensor it launches ``csrc/hab_block.cu`` (bf16, N = 64:
the HAB instantiation of K1's wgmma kernel, ``csrc/swin_fwd_wg.cuh``) or
raises; on a CPU tensor it runs :func:`hab_block_reference`.

The wrapper zero-pads each head to an even width (a multiple of 4 when the
head count is odd; HAT's heads of 15 to 16) and the weights' channel rows to
match (90 to 96), and the kernel reads the padded weights packed into its
wgmma tiles (:func:`pack_hab_weights`); the windows keep their C columns and
LayerNorm its statistics over them.

The same source holds K9a, the training forward with h and drop-path
(:mod:`.hab_train`), the same kernel's third instantiation: :func:`launch_hab`
launches either, and :func:`hab_fwd_h_reference` is the plain version of
both.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library
from .swin_block import (
    MAX_SMEM_BYTES,
    _branch_scale,
    _check,
    _check_packed,
    _check_windows,
    _gelu,
    _ln_f32,
    _on_cuda,
    _pack_on_card,
    _qkv_heads,
    _rounder,
    _softmax_f32,
    _stream,
    pack_swin_block_weights,
)


def hab_fwd_h_reference(
    x_windows, convx_windows, mask, dp1, dp2, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
    ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float, conv_scale: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K9a (and, with no branch scales, of K5):
    ``(out, h)`` in the io dtype.

    As :func:`~.swin_block.swin_block_fwd_h_reference` (products of operands
    rounded to the io dtype with fp32 sums, fp32 LayerNorm, softmax and
    residuals, LN2 reading h rounded to the io dtype, tanh GELU for bf16),
    plus the mask added to every head's scores after the bias, window w
    taking ``mask[w mod nW]`` (``None``: unshifted), and
    h = x + dp1 * proj + conv_scale * conv_x, out = h + dp2 * mlp, with
    ``dp1``/``dp2`` one fp32 scale per window ``(Bw,)`` or ``None`` (1).
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
    h = (x + _branch_scale(dp1, bw) * (torch.matmul(rnd(o), wproj.float()) + bproj.float())
         + conv_scale * convx_windows.float())
    m = _gelu(torch.matmul(rnd(_ln_f32(rnd(h), ln2_w, ln2_b)), w1.float()) + b1.float(), dt)
    m = torch.matmul(rnd(m), w2.float()) + b2.float()
    return (h + _branch_scale(dp2, bw) * m).to(dt), h.to(dt)


def hab_block_reference(
    x_windows, convx_windows, mask, *weights, num_heads: int, scale: float,
    conv_scale: float = 0.01,
) -> torch.Tensor:
    """Plain PyTorch form of K5: the ``out`` of :func:`hab_fwd_h_reference`
    without drop-path."""
    return hab_fwd_h_reference(x_windows, convx_windows, mask, None, None, *weights,
                               num_heads=num_heads, scale=scale, conv_scale=conv_scale)[0]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("hab_block")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hab_block_pack_bf16.argtypes = [vp] * 4 + [i32] * 3 + [vp, vp]
    lib.hab_block_bf16.argtypes = [vp] * 14 + [i32] * 6 + [f32, f32, vp]
    lib.hab_block_fwd_h_bf16.argtypes = [vp] * 21 + [i32] * 6 + [f32, f32, vp]
    for fn in (lib.hab_block_pack_bf16, lib.hab_block_bf16, lib.hab_block_fwd_h_bf16,
               lib.hab_block_windows):
        fn.restype = ctypes.c_int
    lib.hab_block_pack_elems.argtypes = [i32] * 3
    lib.hab_block_smem_bytes.argtypes = [i32] * 4
    lib.hab_block_windows.argtypes = [i32] * 4
    for fn in (lib.hab_block_pack_elems, lib.hab_block_smem_bytes):
        fn.restype = ctypes.c_size_t
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


def pad_attn_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, *, num_heads: int) -> tuple:
    """LN1's vectors, wqkv, bqkv and wproj as the kernels take them: each
    head's q/k/v columns (and wproj's rows) zero-padded to
    :func:`padded_head_dim`, the channel rows (and wproj's columns) to heads
    x that width; vectors fp32, all contiguous."""
    c = wqkv.shape[0]
    hd = c // num_heads
    hdp = padded_head_dim(hd, num_heads)
    cp = num_heads * hdp
    f32 = torch.float32
    wqkv_p = _pad_heads(wqkv.reshape(c, 3, c), num_heads, hd, hdp).reshape(c, 3 * cp)
    bqkv_p = _pad_heads(bqkv.to(f32).reshape(3, c), num_heads, hd, hdp).reshape(-1)
    wproj_p = _pad_last(_pad_heads(wproj.T, num_heads, hd, hdp).T, cp)  # rows: attention channels
    out = (_pad_last(ln1_w.to(f32), cp), _pad_last(ln1_b.to(f32), cp),
           F.pad(wqkv_p, (0, 0, 0, cp - c)), bqkv_p, wproj_p)
    return tuple(t.contiguous() for t in out)


def pad_hab_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2, *,
                     num_heads: int) -> tuple:
    """The twelve weight operands as the kernel takes them: the attention's
    through :func:`pad_attn_operands`, the rest with the channels zero-padded
    to the same width; vectors fp32, all contiguous. A caller that runs the
    same block often pads once and passes the result to
    :func:`fused_hab_block` as ``padded``."""
    c = wqkv.shape[0]
    cp = num_heads * padded_head_dim(c // num_heads, num_heads)
    f32 = torch.float32
    vec = [_pad_last(v.to(f32), cp) for v in (bproj, ln2_w, ln2_b, b2)]
    out = (*pad_attn_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, num_heads=num_heads), vec[0],
           vec[1], vec[2], F.pad(w1, (0, 0, 0, cp - c)), b1.to(f32), _pad_last(w2, cp), vec[3])
    return tuple(t.contiguous() for t in out)


def pack_hab_weights(padded: tuple, *, num_heads: int) -> torch.Tensor:
    """K5's kernel weights: the padded wqkv, wproj, w1 and w2 of
    :func:`pad_hab_operands`'s tuple packed as
    :func:`~.swin_block.pack_swin_block_weights` packs K1's (the plain
    packings on the CPU). About 0.3 MB a block at HAT's widths (C = 90
    padded to 96, 6 heads, hidden 360), 7 MB for the hybrid's 24; a caller
    that runs frozen weights packs once and passes the result to
    :func:`fused_hab_block` as ``packed``."""
    wqkv, wproj, w1, w2 = padded[2], padded[4], padded[8], padded[10]
    if not _on_cuda("pack_hab_weights", wqkv):
        return pack_swin_block_weights(wqkv, wproj, w1, w2, num_heads=num_heads)
    lib = _library()
    c, hidden = w1.shape
    return _pack_on_card("pack_hab_weights", lib.hab_block_pack_bf16,
                         lib.hab_block_pack_elems(c, num_heads, hidden), wqkv, wproj, w1, w2,
                         num_heads)


def fused_hab_block(
    x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
    ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float, conv_scale: float = 0.01,
    padded: tuple | None = None, packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """K5: one HAB over ``(Bw, 64, C)`` windows -> ``(Bw, 64, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_hab_block.launches``) or raise; CPU tensors take
    :func:`hab_block_reference`. ``padded``: the weights already through
    :func:`pad_hab_operands`; ``packed``: those through
    :func:`pack_hab_weights` (the kernel reads the weights from there; the
    others are still checked). Without them each call pads and packs.
    """
    args = (x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
            ln2_w, ln2_b, w1, b1, w2, b2)
    kw = dict(num_heads=num_heads, scale=scale, conv_scale=conv_scale)
    if not _on_cuda("fused_hab_block", x_windows):
        return hab_block_reference(*args, **kw)
    out = launch_hab("fused_hab_block", *args, **kw, padded=padded, packed=packed)
    fused_hab_block.launches += 1
    return out


fused_hab_block.launches = 0


def launch_hab(name: str, x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
               bproj, ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float,
               conv_scale: float, padded: tuple | None, dp: tuple | None = None,
               packed: torch.Tensor | None = None):
    """Checks the operands and launches K5 (on ``packed``, or on the padded
    weights it packs first), or K9a when ``dp`` is the pair of branch scales
    ``(dp1, dp2)`` (each ``(Bw,)`` fp32 or ``None``; K9a packs the padded
    weights on every call, into scratch): returns ``out``, or ``(out, h)``
    for K9a. Both copy x and conv_x as whole 16-byte runs: a window tensor
    that is not 16-byte aligned raises, it is not copied."""
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
    _check_mask(name, mask, bw, n)
    scales = [t for t in (dp or ()) if t is not None]
    for t in scales:
        if tuple(t.shape) != (bw,):
            raise ValueError(f"{name}: a branch scale wants ({bw},), got {tuple(t.shape)}")
    others = [bias, *vectors.values(), wqkv, wproj, w1, w2, *scales] + (
        [mask] if mask is not None else [])
    if any(t.device != x_windows.device for t in others):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    lib = _library()
    if lib.hab_block_smem_bytes(cp, c, num_heads, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")

    if padded is None:
        padded = pad_hab_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1,
                                  w2, b2, num_heads=num_heads)
    x = x_windows.contiguous()
    convx = convx_windows.contiguous()
    bias = bias.float().contiguous()
    mask_t = mask.float().contiguous() if mask is not None else None
    if x.data_ptr() % 16 or convx.data_ptr() % 16:
        raise ValueError(f"{name}: windows must be 16-byte aligned")
    out = torch.empty_like(x)
    mask_ptr = mask_t.data_ptr() if mask_t is not None else None
    nw = mask.shape[0] if mask is not None else 1
    dims = (bw, cp, c, num_heads, hidden, nw, float(scale), float(conv_scale), _stream(x.device))
    elems = lib.hab_block_pack_elems(cp, num_heads, hidden)
    with torch.cuda.device(x.device):
        if dp is None:
            if packed is None:
                packed = _pack_on_card(name, lib.hab_block_pack_bf16, elems, padded[2],
                                       padded[4], padded[8], padded[10], num_heads)
            packed = _check_packed(name, packed, x.device, elems)
            vectors = [padded[i].data_ptr() for i in (0, 1, 3)] + [bias.data_ptr()] + [
                padded[i].data_ptr() for i in (5, 6, 7, 9, 11)]
            _check(lib.hab_block_bf16(x.data_ptr(), convx.data_ptr(), mask_ptr, *vectors,
                                      packed.data_ptr(), out.data_ptr(), *dims), "hab_block_bf16")
            return out
        ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2 = padded
        weights = [t.data_ptr() for t in (ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w,
                                          ln2_b, w1, b1, w2, b2)]
        h = torch.empty_like(x)
        wpack = torch.empty(elems, dtype=torch.bfloat16, device=x.device)
        dp1, dp2 = (t.float().contiguous() if t is not None else None for t in dp)
        _check(lib.hab_block_fwd_h_bf16(
            x.data_ptr(), convx.data_ptr(), mask_ptr,
            *(t.data_ptr() if t is not None else None for t in (dp1, dp2)), *weights,
            out.data_ptr(), h.data_ptr(), wpack.data_ptr(), *dims), "hab_block_fwd_h_bf16")
    return out, h


def _check_mask(name: str, mask, bw: int, n: int) -> None:
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"{name}: mask wants (nW, {n}, {n}) with Bw a multiple of nW, got "
                         f"{tuple(mask.shape)}")
