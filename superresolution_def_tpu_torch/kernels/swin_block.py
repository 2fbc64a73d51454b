"""Fused Swin transformer block (inference): K1 as a hand-written Hopper kernel.

Port of ``superresolution_def_tpu/kernels/swin_block.py::fused_swin_block``.
:func:`fused_swin_block` keeps the JAX argument layout: pre-rolled,
pre-partitioned windows ``(Bw, N, C)``, weights ``(in, out)``, and the
relative-position bias gathered into ``(heads, N, N)`` fp32. On a CUDA tensor
it launches ``csrc/swin_block.cu`` (bf16 only, N = 64) or raises; on a CPU
tensor it runs :func:`swin_block_reference`, the same math in plain PyTorch.

:func:`make_fused_swinir` is the twin of the JAX ``make_fused_swinir``: the
SwinIR forward with every transformer block through the fused block, the
rolls and window partition/reverse as one torch gather each way around it,
and the conv head and tail left to PyTorch.
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


def _ln_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics (eps 1e-5)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + 1e-5) * weight.float() + bias.float()


def swin_block_reference(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float,
) -> torch.Tensor:
    """Plain PyTorch form of the fused block, with the kernel's rounding points.

    Products take their operands as stored (rounded to the io dtype) and sum
    in fp32; LayerNorm, softmax and both residuals stay fp32. bf16 io uses the
    tanh GELU and fp32 io the exact erf GELU, as the JAX kernel does.
    """
    dt = x_windows.dtype
    bw, n, c = x_windows.shape
    hd = c // num_heads

    def rnd(t):  # round to the io dtype, keep computing in fp32
        return t.to(dt).float()

    def mm(a, w):
        return torch.matmul(a, w.float())

    x = x_windows.float()
    xn = rnd(_ln_f32(x, ln1_w, ln1_b))
    qkv = rnd(mm(xn, wqkv) + bqkv.float())
    qkv = qkv.reshape(bw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = rnd(qkv[0] * rnd(torch.tensor(scale, dtype=torch.float32)))
    k, v = qkv[1], qkv[2]
    s = torch.matmul(q, k.transpose(-1, -2)) + bias.float()
    s = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = s / s.sum(dim=-1, keepdim=True)
    o = torch.matmul(rnd(p), v).permute(0, 2, 1, 3).reshape(bw, n, c)
    h = x + (mm(rnd(o), wproj) + bproj.float())
    hn = rnd(_ln_f32(rnd(h), ln2_w, ln2_b))
    m = F.gelu(mm(hn, w1) + b1.float(), approximate="tanh" if dt == torch.bfloat16 else "none")
    m = mm(rnd(m), w2) + b2.float()
    return (h + m).to(dt)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    lib = load_library("swin_block")
    lib.swin_block_bf16.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.swin_block_bf16.restype = ctypes.c_int
    lib.swin_block_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.swin_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch(x, vectors, weights, bias, num_heads, scale):
    bw, n, c = x.shape
    hidden = weights["w1"].shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_swin_block on CUDA takes bfloat16 windows, got {x.dtype}")
    if n != 64:
        raise ValueError(f"fused_swin_block on CUDA takes 8x8 windows (N=64), got N={n}")
    hd = c // num_heads
    # a head pair's q/k/v columns and the weight rows are copied as 8-byte vectors
    if (c % num_heads or hd > 32 or hd % 2 or (num_heads % 2 and hd % 4) or c > 256
            or c % 4 or hidden % 4):
        raise ValueError(f"unsupported widths C={c}, hidden={hidden} with {num_heads} heads")
    want = {
        "wqkv": (c, 3 * c), "wproj": (c, c), "w1": (c, hidden), "w2": (hidden, c),
    }
    for name, w in weights.items():
        if tuple(w.shape) != want[name] or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: want bfloat16 {want[name]}, got {w.dtype} {tuple(w.shape)}")
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"bias: want {(num_heads, n, n)}, got {tuple(bias.shape)}")
    sizes = {"ln1_w": c, "ln1_b": c, "bqkv": 3 * c, "bproj": c, "ln2_w": c, "ln2_b": c,
             "b1": hidden, "b2": c}
    for name, v in vectors.items():
        if v.shape != (sizes[name],):
            raise ValueError(f"{name}: want ({sizes[name]},), got {tuple(v.shape)}")
    tensors = [x, bias, *weights.values(), *vectors.values()]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_swin_block: every operand must be on the windows' device")

    lib = _kernel_library()
    if lib.swin_block_smem_bytes(c, num_heads, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"C={c} with {num_heads} heads needs more than 227 KB shared memory")
    x = x.contiguous()
    f32 = {k: v.float().contiguous() for k, v in vectors.items()}
    w = {k: v.contiguous() for k, v in weights.items()}
    if any(t.data_ptr() % 8 for t in w.values()) or x.data_ptr() % 16:
        raise ValueError("fused_swin_block: windows must be 16-byte, weights 8-byte aligned")
    bias = bias.float().contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.swin_block_bf16(
            x.data_ptr(), f32["ln1_w"].data_ptr(), f32["ln1_b"].data_ptr(),
            w["wqkv"].data_ptr(), f32["bqkv"].data_ptr(), bias.data_ptr(),
            w["wproj"].data_ptr(), f32["bproj"].data_ptr(),
            f32["ln2_w"].data_ptr(), f32["ln2_b"].data_ptr(),
            w["w1"].data_ptr(), f32["b1"].data_ptr(), w["w2"].data_ptr(), f32["b2"].data_ptr(),
            out.data_ptr(), bw, c, num_heads, hidden, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_bf16 launch failed with CUDA error {err}")
    fused_swin_block.launches += 1
    return out


def fused_swin_block(
    x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2,
    *, num_heads: int, scale: float,
) -> torch.Tensor:
    """One Swin block over ``(Bw, N, C)`` windows -> ``(Bw, N, C)``.

    CUDA tensors launch the Hopper kernel (counted in
    ``fused_swin_block.launches``) or raise; CPU tensors take
    :func:`swin_block_reference`.
    """
    if x_windows.device.type == "cpu":
        return swin_block_reference(
            x_windows, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
            w1, b1, w2, b2, num_heads=num_heads, scale=scale,
        )
    if x_windows.device.type != "cuda":
        raise ValueError(f"fused_swin_block runs on cpu or cuda, not {x_windows.device}")
    vectors = dict(ln1_w=ln1_w, ln1_b=ln1_b, bqkv=bqkv, bproj=bproj, ln2_w=ln2_w, ln2_b=ln2_b,
                   b1=b1, b2=b2)
    weights = dict(wqkv=wqkv, wproj=wproj, w1=w1, w2=w2)
    return _launch(x_windows, vectors, weights, bias, num_heads, scale)


fused_swin_block.launches = 0


def make_fused_swinir(model, *, dtype: torch.dtype = torch.bfloat16):
    """SwinIR forward with every block through :func:`fused_swin_block`.

    Twin of the JAX ``make_fused_swinir``: takes and returns NHWC, requires H
    and W to be window multiples (no reflect pad, no small-input rule), and
    computes in ``dtype`` (bf16 by default) with LayerNorms in fp32. The
    weights of ``model`` are cast and laid out once, here; later changes to
    ``model`` are not seen by the returned function.
    """
    ws = model.window_size
    n = ws * ws

    def as_f32(t):
        return t.detach().float().contiguous()

    def as_io(t):
        return t.detach().to(dtype).contiguous()

    def conv(m):
        return as_io(m.weight), as_io(m.bias)

    blocks = []
    for layer in model.layers:
        for j, blk in enumerate(layer):
            heads = blk.attn.num_heads
            args = (
                as_f32(blk.norm1.weight), as_f32(blk.norm1.bias),
                as_io(blk.attn.qkv.weight.T), as_f32(blk.attn.qkv.bias),
                as_f32(relative_position_bias(blk.attn.relative_position_bias_table, ws)),
                as_io(blk.attn.proj.weight.T), as_f32(blk.attn.proj.bias),
                as_f32(blk.norm2.weight), as_f32(blk.norm2.bias),
                as_io(blk.mlp.fc1.weight.T), as_f32(blk.mlp.fc1.bias),
                as_io(blk.mlp.fc2.weight.T), as_f32(blk.mlp.fc2.bias),
            )
            blocks.append((args, heads, 0 if j % 2 == 0 else ws // 2))
    norm = (as_f32(model.norm.weight), as_f32(model.norm.bias))
    conv_first = conv(model.conv_first)
    conv_after_body = conv(model.conv_after_body)
    conv_before_upsample = conv(model.conv_before_upsample[0])
    upsample = [(conv(m), shuffle.upscale_factor)
                for m, shuffle in zip(model.upsample[::2], model.upsample[1::2])]
    conv_last = conv(model.conv_last)

    def conv3(wb, x):
        return F.conv2d(x.permute(0, 3, 1, 2), wb[0], wb[1], padding=1).permute(0, 2, 3, 1)

    orders = {}

    def token_order(b, h, w, shift, device):
        """Roll by -shift then window partition, as one permutation of the
        b*h*w token rows (window slot i holds row fwd[i]), and its inverse."""
        key = (b, h, w, shift, device)
        if key not in orders:
            idx = torch.arange(b * h * w, device=device).reshape(b, h, w, 1)
            fwd = window_partition(torch.roll(idx, (-shift, -shift), dims=(1, 2)), ws).reshape(-1)
            orders[key] = fwd, torch.argsort(fwd)
        return orders[key]

    def gather_rows(x2d, index):
        # rows move as the widest words (up to 8 bytes) their width allows:
        # at C = 180 in bf16 the gather handles 4x fewer elements
        word = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            math.gcd(8, x2d.shape[1] * x2d.element_size())]
        return x2d.view(word)[index].view(x2d.dtype)

    def block(args, heads, shift, x):
        # the rolls and the window partition/reverse as one gather each way
        b, h, w, c = x.shape
        fwd, inv = token_order(b, h, w, shift, x.device)
        xw = gather_rows(x.reshape(-1, c), fwd).reshape(-1, n, c)
        out = fused_swin_block(xw, *args, num_heads=heads, scale=(c // heads) ** -0.5)
        return gather_rows(out.reshape(-1, c), inv).reshape(b, h, w, c)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % ws or w % ws:
            raise ValueError(f"fused SwinIR needs H and W multiples of {ws}, got {h}x{w}")
        x = x.to(dtype)
        x_first = conv3(conv_first, x)
        res = x_first
        for args, heads, shift in blocks:
            res = block(args, heads, shift, res)
        res = _ln_f32(res, *norm).to(dtype)
        res = conv3(conv_after_body, res) + x_first
        out = F.leaky_relu(conv3(conv_before_upsample, res), 0.01)
        for wb, r in upsample:
            out = pixel_shuffle(conv3(wb, out), r)
        return conv3(conv_last, out)

    return forward
