"""The fused Swin block with swappable stages (K13), for attributing K1's time.

Port of ``scripts/swin_stage_ablation.py::block`` (kernel body
``_make_kernel(mode)``), the JAX package's op-class ablation of its fused
block: the same block in nine modes (:data:`MODES`), each removing or
swapping one stage. On a CUDA tensor :func:`swin_stage_block` launches
``csrc/swin_stage_ablation.cu`` (K1's wgmma kernel, ``csrc/swin_fwd_wg.cuh``,
with the stage and the activation as compile-time modes of its body; bf16,
N = 64, C in 129..192 with head_dim 17..32) on K1's packed weights, or
raises; on a CPU tensor it runs :func:`swin_stage_block_reference`, which
follows ``_make_kernel`` step for step: LN2 reads h rounded to the io
dtype, and ``full``, ``allheads``, ``noattn``, ``attnonly`` and ``mlponly``
use the A&S erf GELU (K1 uses tanh in bf16). ``tools/swin_stage_ablation.py``
is the script's ``main()``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library
from .swin_block import (
    _check,
    _check_packed,
    _checked_block_operands,
    _ln_f32,
    _on_cuda,
    _qkv_heads,
    _rounder,
    _softmax_f32,
    _stream,
    attn_head_width,
    pack_swin_block_weights,
)

# the script's variants, in its order (the kernel's mode numbers)
MODES = ("full", "noattn", "attnonly", "mlponly", "allheads", "mlp_nogelu", "mlp_tanhgelu",
         "mlp_siggelu", "mlp_polygelu")


@functools.cache
def erf_coefficients() -> np.ndarray:
    """The 26 coefficients ``mlp_polygelu`` evaluates, lowest power first:
    the script's ``_fit_erf_poly``, an odd Chebyshev fit of erf of degree 25
    on [-4, 4] converted to the power basis in float32."""
    from scipy.special import erf

    u = np.linspace(-4.0, 4.0, 4001)
    cheb = np.polynomial.chebyshev.Chebyshev.fit(u, erf(u), 25, domain=[-4.0, 4.0])
    return cheb.convert(kind=np.polynomial.Polynomial).coef.astype(np.float32)


def _coefficients(mode: str, erf_coef) -> np.ndarray | None:
    """``mlp_polygelu``'s 26 float32 coefficients (the fit unless given);
    None in the modes that do not read them."""
    if mode != "mlp_polygelu":
        return None
    coef = erf_coefficients() if erf_coef is None else erf_coef
    coef = np.ascontiguousarray(coef, dtype=np.float32)
    if coef.shape != (26,):
        raise ValueError(f"erf_coef holds 26 coefficients, got shape {coef.shape}")
    return coef


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (the JAX kernels' ``_erf_approx``)."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
        -1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _erf_poly(u: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    acc = torch.full_like(u, float(coef[-1]))
    for c in coef[-2::-1]:
        acc = acc * u + float(c)
    return acc


def _activation(mode: str, u: torch.Tensor, coef: np.ndarray) -> torch.Tensor:
    """The MLP activation of ``mode`` on fp32 ``u`` (the script's ``_ACTIVATIONS``,
    ``_gelu_exact`` for the rest); ``coef``: ``mlp_polygelu``'s erf polynomial."""
    if mode == "mlp_nogelu":
        return u
    if mode == "mlp_tanhgelu":
        return 0.5 * u * (1.0 + torch.tanh(0.7978845608028654 * (u + 0.044715 * u * u * u)))
    if mode == "mlp_siggelu":
        return u / (1.0 + torch.exp(-1.702 * u))
    if mode == "mlp_polygelu":
        return u * 0.5 * (1.0 + _erf_poly(torch.clamp(u * 2.0**-0.5, -4.0, 4.0), coef))
    return u * 0.5 * (1.0 + _erf_as(u * 2.0**-0.5))


def swin_stage_block_reference(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b,
                               w1, b1, w2, b2, *, mode: str, num_heads: int, scale: float,
                               erf_coef: np.ndarray | None = None) -> torch.Tensor:
    """Plain PyTorch form of K13: one block over ``(Bw, N, C)`` windows in
    ``mode``, products on the operands as stored with fp32 sums, LayerNorm,
    softmax and the residuals in fp32, as ``_make_kernel(mode)``.
    ``erf_coef``: the 26 coefficients ``mlp_polygelu`` evaluates instead of
    :func:`erf_coefficients` (a control: zeros give ``u / 2``)."""
    if mode not in MODES:
        raise ValueError(f"mode is one of {MODES}, got {mode!r}")
    coef = _coefficients(mode, erf_coef)
    dt = x.dtype
    bw, n, c = x.shape
    rnd = _rounder(dt)
    xf = x.float()
    if mode == "mlponly":
        h = xf
    else:
        xn = rnd(_ln_f32(xf, ln1_w, ln1_b))
        if mode == "noattn":
            attn = rnd(torch.matmul(xn, wqkv.float()) + bqkv.float())[..., :c]
        else:  # full's attention; allheads batches the same products
            q, k, v = _qkv_heads(xn, wqkv, bqkv, num_heads, rnd)
            q = rnd(q * rnd(torch.tensor(scale, dtype=torch.float32)))
            p = _softmax_f32(torch.matmul(q, k.transpose(-1, -2)) + bias.float())
            attn = torch.matmul(rnd(p), v).permute(0, 2, 1, 3).reshape(bw, n, c)
        h = xf + (torch.matmul(rnd(attn), wproj.float()) + bproj.float())
    if mode == "attnonly":
        return h.to(dt)
    u = torch.matmul(rnd(_ln_f32(rnd(h), ln2_w, ln2_b)), w1.float()) + b1.float()
    m = torch.matmul(rnd(_activation(mode, u, coef)), w2.float()) + b2.float()
    return (h + m).to(dt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("swin_stage_ablation")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.swin_stage_block_bf16.argtypes = [vp] * 12 + [i32] * 4 + [ctypes.c_float, i32, vp, vp]
    lib.swin_stage_block_bf16.restype = ctypes.c_int
    lib.swin_stage_block_smem_bytes.argtypes = [i32] * 3
    lib.swin_stage_block_smem_bytes.restype = ctypes.c_size_t
    return lib


def packed_elems(c: int, num_heads: int, hidden: int) -> int:
    """Elements of K1's packed weights (:func:`~.swin_block.pack_swin_block_weights`)
    at these widths: per head four ck x hp attention tiles, per 64 hidden
    columns two ck x 64 MLP tiles (ck: C rounded up to 64)."""
    ck, nj = -(-c // 64) * 64, -(-hidden // 64)
    return ck * attn_head_width(c, num_heads) * 4 * num_heads + ck * 64 * 2 * nj


def swin_stage_block(x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2,
                     b2, *, mode: str, num_heads: int, scale: float,
                     erf_coef: np.ndarray | None = None,
                     packed: torch.Tensor | None = None) -> torch.Tensor:
    """K13: one block in ``mode`` over ``(Bw, N, C)`` windows -> ``(Bw, N, C)``.

    CUDA tensors launch the kernel (counted in ``swin_stage_block.launches``)
    or raise; CPU tensors take :func:`swin_stage_block_reference`.
    ``erf_coef`` as there. ``packed``: the weights already through
    :func:`~.swin_block.pack_swin_block_weights`, as
    :func:`~.swin_block.fused_swin_block` takes them (the kernel reads the
    weights from there; the others are still checked); without it each call
    packs them first. Its shape is checked on CPU tensors too.
    """
    args = (x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
    if mode not in MODES:
        raise ValueError(f"mode is one of {MODES}, got {mode!r}")
    coef = _coefficients(mode, erf_coef)
    name = "swin_stage_block"
    if not _on_cuda(name, x):
        if packed is not None:
            _check_packed(name, packed, x.device,
                          packed_elems(w1.shape[0], num_heads, w1.shape[1]))
        return swin_stage_block_reference(*args, mode=mode, num_heads=num_heads, scale=scale,
                                          erf_coef=coef)
    c = x.shape[-1]
    if not 128 < c <= 192 or not 16 < c // max(num_heads, 1) <= 32:
        raise ValueError(f"{name} on CUDA is built for C in 129..192 with head_dim 17..32, got "
                         f"C={c} with {num_heads} heads")
    lib = _library()
    x, w, f32, bias = _checked_block_operands(
        name, x, dict(ln1_w=ln1_w, ln1_b=ln1_b, bqkv=bqkv, bproj=bproj, ln2_w=ln2_w,
                      ln2_b=ln2_b, b1=b1, b2=b2), dict(wqkv=wqkv, wproj=wproj, w1=w1, w2=w2),
        bias, num_heads, lambda c_, h_: lib.swin_stage_block_smem_bytes(c_, num_heads, h_))
    bw, hidden = x.shape[0], w["w1"].shape[1]
    if packed is None:
        packed = pack_swin_block_weights(w["wqkv"], w["wproj"], w["w1"], w["w2"],
                                         num_heads=num_heads)
    packed = _check_packed(name, packed, x.device, packed_elems(c, num_heads, hidden))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _check(lib.swin_stage_block_bf16(
            x.data_ptr(), f32["ln1_w"].data_ptr(), f32["ln1_b"].data_ptr(),
            f32["bqkv"].data_ptr(), bias.data_ptr(), f32["bproj"].data_ptr(),
            f32["ln2_w"].data_ptr(), f32["ln2_b"].data_ptr(), f32["b1"].data_ptr(),
            f32["b2"].data_ptr(), packed.data_ptr(), out.data_ptr(), bw, c, num_heads, hidden,
            float(scale), MODES.index(mode), None if coef is None else coef.ctypes.data,
            _stream(x.device)), "swin_stage_block_bf16")
    swin_stage_block.launches += 1
    return out


swin_stage_block.launches = 0
