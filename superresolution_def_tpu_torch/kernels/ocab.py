"""K6: HAT's overlapping cross-attention block tail (OCAB) as a Hopper kernel.

Port of ``superresolution_def_tpu/kernels/ocab.py::fused_ocab_block``. LN1,
the qkv product and the window/overlap gathers stay in PyTorch (the JAX
package leaves them to XLA); :func:`fused_ocab_block` takes the windows as
the JAX kernel does: the shortcut x and q as ``(Bw, 64, C)``, the overlap
keys and values as ``(Bw, 144, C)``, and the relative-position bias gathered
with the OCA index into ``(heads, 64, 144)`` fp32. On a CUDA tensor it
launches ``csrc/ocab.cu`` (bf16) or raises; on a CPU tensor it runs
:func:`ocab_block_reference`.
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
    _gelu,
    _ln_f32,
    _on_cuda,
    _rounder,
    _softmax_f32,
    _stream,
)

MAX_KEYS = 144  # the kernel's key tiles: 9 x 16


def ocab_block_reference(x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj,
                         ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int,
                         scale: float) -> torch.Tensor:
    """Plain PyTorch form of K6, with the TPU kernel's rounding points: q
    scaled in the io dtype, fp32 scores + bias and softmax, probabilities,
    attention output, LN2 output and GELU output rounded to the io dtype,
    fp32 residuals, LN2 reading h rounded to the io dtype."""
    dt = x_windows.dtype
    bw, nq, c = x_windows.shape
    nk = k_windows.shape[1]
    hd = c // num_heads
    rnd = _rounder(dt)

    def heads(t, n):  # (Bw, n, C) -> (Bw, heads, n, hd) fp32
        return t.float().reshape(bw, n, num_heads, hd).transpose(1, 2)

    q = rnd(heads(q_windows, nq) * rnd(torch.tensor(scale, dtype=torch.float32)))
    s = torch.matmul(q, heads(k_windows, nk).transpose(-1, -2)) + bias.float()
    o = torch.matmul(rnd(_softmax_f32(s)), heads(v_windows, nk))
    o = o.transpose(1, 2).reshape(bw, nq, c)
    h = x_windows.float() + (torch.matmul(rnd(o), wproj.float()) + bproj.float())
    m = _gelu(torch.matmul(rnd(_ln_f32(rnd(h), ln2_w, ln2_b)), w1.float()) + b1.float(), dt)
    m = torch.matmul(rnd(m), w2.float()) + b2.float()
    return (h + m).to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("ocab")
    lib.ocab_block_bf16.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.ocab_block_bf16.restype = ctypes.c_int
    lib.ocab_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ocab_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def pad_ocab_operands(wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2) -> tuple:
    """The weight operands as the kernel takes them: channel rows and
    columns zero-padded to a multiple of 16, vectors fp32, all contiguous. A
    caller that runs the same block often pads once and passes the result to
    :func:`fused_ocab_block` as ``padded``."""
    pad = -(-wproj.shape[0] // 16) * 16 - wproj.shape[0]
    out = (F.pad(wproj, (0, pad, 0, pad)), F.pad(bproj.float(), (0, pad)),
           F.pad(ln2_w.float(), (0, pad)), F.pad(ln2_b.float(), (0, pad)),
           F.pad(w1, (0, 0, 0, pad)), b1.float(), F.pad(w2, (0, pad)), F.pad(b2.float(), (0, pad)))
    return tuple(t.contiguous() for t in out)


def fused_ocab_block(x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj,
                     ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float,
                     padded: tuple | None = None) -> torch.Tensor:
    """K6: the OCAB tail over ``(Bw, 64, C)`` query windows -> ``(Bw, 64, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_ocab_block.launches``) or raise; CPU tensors take
    :func:`ocab_block_reference`. ``padded``: the weights already through
    :func:`pad_ocab_operands` (the others are still checked).
    """
    args = (x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("fused_ocab_block", x_windows):
        return ocab_block_reference(*args, num_heads=num_heads, scale=scale)
    name = "fused_ocab_block"
    bw, nq, c = x_windows.shape
    nk = k_windows.shape[1]
    hidden = w1.shape[1]
    for t in (x_windows, q_windows, k_windows, v_windows):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} on CUDA takes bfloat16 windows, got {t.dtype}")
    if (tuple(q_windows.shape) != (bw, nq, c) or tuple(k_windows.shape) != (bw, nk, c)
            or tuple(v_windows.shape) != (bw, nk, c)):
        raise ValueError(f"{name}: windows of shapes {tuple(x_windows.shape)}, "
                         f"{tuple(q_windows.shape)}, {tuple(k_windows.shape)}, "
                         f"{tuple(v_windows.shape)}")
    if nq != 64 or nk > MAX_KEYS or nk % 2:
        raise ValueError(f"{name} on CUDA takes 64 queries (N=64) and an even key count "
                         f"up to {MAX_KEYS}, got {nq} and {nk}")
    cp = -(-c // 16) * 16
    if c % num_heads or c % 2 or c // num_heads > 32 or cp > 256 or hidden % 4:
        raise ValueError(f"{name}: unsupported widths C={c}, {num_heads} heads, hidden={hidden}")
    want = {"wproj": (c, c), "w1": (c, hidden), "w2": (hidden, c)}
    for key, w in dict(wproj=wproj, w1=w1, w2=w2).items():
        if tuple(w.shape) != want[key] or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} wants bfloat16 {want[key]}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    vectors = dict(bproj=bproj, ln2_w=ln2_w, ln2_b=ln2_b, b2=b2)
    for key, v in (*vectors.items(), ("b1", b1)):
        size = hidden if key == "b1" else c
        if tuple(v.shape) != (size,):
            raise ValueError(f"{name}: {key} wants ({size},), got {tuple(v.shape)}")
    if tuple(bias.shape) != (num_heads, nq, nk):
        raise ValueError(f"{name}: bias wants {(num_heads, nq, nk)}, got {tuple(bias.shape)}")
    others = (q_windows, k_windows, v_windows, bias, wproj, w1, w2, b1, *vectors.values())
    if any(t.device != x_windows.device for t in others):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    lib = _library()
    if lib.ocab_block_smem_bytes(cp, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")

    if padded is None:
        padded = pad_ocab_operands(wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
    x, q, k, v = (t.contiguous() for t in (x_windows, q_windows, k_windows, v_windows))
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _check(lib.ocab_block_bf16(
            x.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            *(t.data_ptr() for t in padded), out.data_ptr(), bw, nk, cp, c, num_heads, hidden,
            float(scale), _stream(x.device)), "ocab_block_bf16")
    fused_ocab_block.launches += 1
    return out


fused_ocab_block.launches = 0
