"""K6: HAT's overlapping cross-attention block tail (OCAB) as a Hopper kernel.

Port of ``superresolution_def_tpu/kernels/ocab.py::fused_ocab_block``. LN1,
the qkv product and the window/overlap gathers stay in PyTorch (the JAX
package leaves them to XLA); :func:`fused_ocab_block` takes the windows as
the JAX kernel does: the shortcut x and q as ``(Bw, 64, C)``, the overlap
keys and values as ``(Bw, 144, C)``, and the relative-position bias gathered
with the OCA index into ``(heads, 64, 144)`` fp32. On a CUDA tensor it
launches ``csrc/ocab.cu`` (bf16: the OCAB mode of K1's wgmma kernel,
``csrc/swin_fwd_wg.cuh``) or raises; on a CPU tensor it runs
:func:`ocab_block_reference`. The same source holds K10a, the tail that also
returns h for the backward (:mod:`.ocab_train`): :func:`launch_ocab`
launches either, and :func:`ocab_fwd_h_reference` is the plain version of
both.

The kernels read the weights zero-padded to a multiple of 16 channels
(:func:`pad_ocab_operands`, HAT's 90 to 96) and packed into their wgmma
tiles (:func:`pack_ocab_weights`): each head's wproj rows at the slots the
kernels' gather puts the head's q, k and v columns in. The windows keep
their C columns, and LayerNorm its statistics over them.
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
    _check_packed,
    _gelu,
    _ln_f32,
    _on_cuda,
    _ptrs,
    _rounder,
    _softmax_f32,
    _stream,
    attn_head_width,
    attn_pack_reference,
    mlp_pack_reference,
)

MAX_KEYS = 144  # the kernel's keys: nine k16 steps


def ocab_fwd_h_reference(x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj,
                         ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int,
                         scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch form of K10a: ``(out, h)`` in the io dtype, h = x + proj.
    The TPU kernel's rounding points: q scaled in the io dtype, fp32 scores +
    bias and softmax, probabilities, attention output, LN2 output and GELU
    output rounded to the io dtype, fp32 residuals, LN2 reading h rounded to
    the io dtype."""
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
    return (h + m).to(dt), h.to(dt)


def ocab_block_reference(*args, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch form of K6: the ``out`` of :func:`ocab_fwd_h_reference`."""
    return ocab_fwd_h_reference(*args, num_heads=num_heads, scale=scale)[0]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("ocab")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ocab_block_bf16.argtypes = [vp] * 12 + [i32] * 6 + [f32, vp]
    lib.ocab_block_fwd_h_bf16.argtypes = [vp] * 13 + [i32] * 6 + [f32, vp]
    lib.ocab_block_pack_bf16.argtypes = [vp] * 4 + [i32] * 5 + [vp, vp]
    for fn in (lib.ocab_block_bf16, lib.ocab_block_fwd_h_bf16, lib.ocab_block_pack_bf16,
               lib.ocab_block_shape):
        fn.restype = ctypes.c_int
    for fn in (lib.ocab_block_pack_elems, lib.ocab_block_smem_bytes, lib.ocab_block_shape):
        fn.argtypes = [i32] * 4
    lib.ocab_block_pack_elems.restype = ctypes.c_size_t
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


def slot_rows(channels: int, num_heads: int) -> torch.Tensor:
    """Where the kernels' gather puts each attention channel: head h's hd
    channels at slots ``h * hs + o .. + hd - 1`` of a ``heads * hs`` row,
    hs the head width rounded up to even and o = (h * hd) % 2 (every 4-byte
    copy of a pair of columns stays aligned, so a head that starts on an
    odd column lands one slot in). A long tensor of ``channels`` entries."""
    hd = channels // num_heads
    hs = hd + hd % 2
    h = torch.arange(num_heads).repeat_interleave(hd)
    return h * hs + (h * hd) % 2 + torch.arange(hd).repeat(num_heads)


def pack_ocab_weights(padded: tuple, *, num_heads: int, channels: int) -> torch.Tensor:
    """K6's and K10a's kernel weights: the padded wproj, w1 and w2 of
    :func:`pad_ocab_operands`'s tuple (of a block of ``channels`` = C),
    packed as :func:`~.hab_block.pack_hab_weights` packs K5's, with wproj's
    rows moved to :func:`slot_rows` and zero wq, wk, wv tiles that the
    kernels never stream (the plain packings on the CPU, ``attn_pack_kernel``
    and ``mlp_pack_kernel`` on the card). About 0.3 MB a block at HAT's
    widths (C = 90 padded to 96, 6 heads, hidden 360); a caller that runs
    frozen weights packs once and passes the result to
    :func:`fused_ocab_block` as ``packed``."""
    wproj, w1, w2 = padded[0], padded[4], padded[6]
    cp, hidden = w1.shape
    hd = channels // num_heads
    cs = num_heads * (hd + hd % 2)
    ncol = min(cs, cp)
    wslots = torch.zeros(cs, cs, dtype=wproj.dtype, device=wproj.device)
    wslots[slot_rows(channels, num_heads).to(wproj.device), :ncol] = wproj[:channels, :ncol]
    wzero = torch.zeros(cs, 3 * cs, dtype=wproj.dtype, device=wproj.device)
    if not _on_cuda("pack_ocab_weights", wproj):
        # the tiles cut to the kernels' ck rows (cp rounded up to 64), which
        # cs's may pass: the rows past C are zero
        hp = attn_head_width(cs, num_heads)
        attn = attn_pack_reference(wzero, wslots, num_heads).reshape(4 * num_heads, -1, 8 * hp)
        attn = attn[:, :-(-cp // 64) * 8]
        return torch.cat([attn.reshape(-1), mlp_pack_reference(w1, w2)])
    lib = _library()
    out = torch.empty(lib.ocab_block_pack_elems(cp, channels, num_heads, hidden),
                      dtype=torch.bfloat16, device=wproj.device)
    w = [t.contiguous() for t in (wslots, wzero, w1, w2)]
    with torch.cuda.device(wproj.device):
        _check(lib.ocab_block_pack_bf16(*_ptrs(*w), cs, cp, channels, num_heads, hidden,
                                        out.data_ptr(), _stream(wproj.device)),
               "ocab_block_pack_bf16")
    return out


def fused_ocab_block(x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj,
                     ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float,
                     padded: tuple | None = None,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """K6: the OCAB tail over ``(Bw, 64, C)`` query windows -> ``(Bw, 64, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_ocab_block.launches``) or raise; CPU tensors take
    :func:`ocab_block_reference`. ``padded``: the weights already through
    :func:`pad_ocab_operands`; ``packed``: those through
    :func:`pack_ocab_weights` (the kernel reads the weights from there; the
    others are still checked). Without them each call pads and packs.
    """
    args = (x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2)
    if not _on_cuda("fused_ocab_block", x_windows):
        return ocab_block_reference(*args, num_heads=num_heads, scale=scale)
    out = launch_ocab("fused_ocab_block", *args, num_heads=num_heads, scale=scale,
                      padded=padded, packed=packed, store_h=False)
    fused_ocab_block.launches += 1
    return out


fused_ocab_block.launches = 0


def check_ocab_windows(name: str, x_windows, q_windows, k_windows, v_windows):
    """``(Bw, nq, nk, C)`` of the windows the OCAB kernels take, or raise."""
    bw, nq, c = x_windows.shape
    nk = k_windows.shape[1]
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
    return bw, nq, nk, c


def launch_ocab(name: str, x_windows, q_windows, k_windows, v_windows, bias, wproj, bproj,
                ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float,
                padded: tuple | None, packed: torch.Tensor | None, store_h: bool):
    """Checks the operands and launches K6, or K10a with ``store_h``, on
    ``packed`` (or on the padded weights it packs first): returns ``out``, or
    ``(out, h)``. A window tensor that is not aligned as the kernel copies it
    (x 16 bytes, q, k and v 4) is copied to one that is."""
    bw, nq, nk, c = check_ocab_windows(name, x_windows, q_windows, k_windows, v_windows)
    hidden = w1.shape[1]
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
    if lib.ocab_block_smem_bytes(cp, c, num_heads, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} with {num_heads} heads needs more than 227 KB shared "
                         "memory")

    if padded is None:
        padded = pad_ocab_operands(wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
    if packed is None:
        packed = pack_ocab_weights(padded, num_heads=num_heads, channels=c)
    packed = _check_packed(name, packed, x_windows.device,
                           lib.ocab_block_pack_elems(cp, c, num_heads, hidden))
    x, q, k, v = (t.contiguous() for t in (x_windows, q_windows, k_windows, v_windows))
    x = x.clone() if x.data_ptr() % 16 else x
    q, k, v = (t.clone() if t.data_ptr() % 4 else t for t in (q, k, v))
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    h = [torch.empty_like(x)] if store_h else []
    vectors = (padded[i] for i in (1, 2, 3, 5, 7))  # bproj, ln2_w, ln2_b, b1, b2
    fn = lib.ocab_block_fwd_h_bf16 if store_h else lib.ocab_block_bf16
    with torch.cuda.device(x.device):
        _check(fn(*_ptrs(x, q, k, v, bias, *vectors, packed, out, *h), bw, nk, cp, c, num_heads,
                  hidden, float(scale), _stream(x.device)), fn.__name__)
    return (out, h[0]) if store_h else out
