"""K9a-c: HAT's hybrid attention block (HAB) for training, forward and backward.

Port of ``superresolution_def_tpu/kernels/hab_train.py``:

- K9a :func:`hab_fwd_h` (``_hab_fwd_h``): K5's block with K2's store of
  h = x + dp1 * proj(attn(LN1 x, mask)) + conv_scale * conv_x, and
  out = h + dp2 * MLP(LN2 h);
- K9b :func:`hab_bwd_mlp` (``_hab_bwd_mlp``): the LN2 + MLP backward from the
  saved h, its branch scaled by dp2 (the OCAB tail runs it with no scale);
- K9c :func:`hab_bwd_attn` (``_hab_bwd_attn``): the masked attention + LN1
  backward, its branch scaled by dp1.

They keep the JAX argument layout (pre-rolled, pre-partitioned ``(Bw, 64, C)``
windows, weights ``(in, out)``, the bias gathered into ``(heads, 64, 64)``
fp32) with two changes, as K5 has them: the shift mask is the ``(nW, 64, 64)``
mask of one image, window w taking ``mask[w mod nW]`` (``None``: unshifted),
and the drop-path scales dp1, dp2 are one fp32 value per window ``(Bw,)``
(``None``: 1), where the JAX kernels take ``(Bw, 1, C)`` windows of that value.
On a CUDA tensor each launches its kernel (K9a ``csrc/hab_block.cu``, K9b and
K9c ``csrc/swin_block_train.cu``; bf16, N = 64) or raises; on a CPU tensor it
runs its plain version (``hab_*_reference``). Weight, bias and LayerNorm
gradients come back as fp32 sums over all windows.

HAT's widths (C = 90, six heads of 15) are padded for the kernels as K5 pads
them (:func:`~.hab_block.pad_hab_operands`: each head to 16 columns, the
channels to 96, with zeros); the windows keep their 90 columns and the
LayerNorms their statistics over them, and the wrappers cut the padding off
every weight gradient.

:class:`HabCoreFn` ties them into one autograd node (the JAX ``hab_core_ad``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .hab_block import (
    _check_mask,
    hab_fwd_h_reference,
    launch_hab,
    pad_attn_operands,
    padded_head_dim,
)
from .swin_block import (
    MAX_SMEM_BYTES,
    _attn_sizes,
    _attn_window_grads,
    _check,
    _check_windows,
    _colsum,
    _f32,
    _on_cuda,
    _ptrs,
    _stream,
    _train_library,
    _wgrad,
    swin_block_bwd_attn_reference,
    swin_block_bwd_mlp_reference,
)


def hab_bwd_mlp_reference(h, dout, dp2, ln2_w, ln2_b, w1, b1, w2):
    """Plain PyTorch form of K9b: ``(dh, dln2_w, dln2_b, dw1, db1, dw2, db2)``,
    K3's with the MLP branch scaled by ``dp2``."""
    return swin_block_bwd_mlp_reference(h, dout, ln2_w, ln2_b, w1, b1, w2, dp=dp2)


def hab_bwd_attn_reference(x, dh, mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, *,
                           num_heads: int, scale: float):
    """Plain PyTorch form of K9c: ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias,
    dwproj, dbproj)``, K4's with the mask in the softmax recompute and the
    attention branch scaled by ``dp1``."""
    return swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                                         num_heads=num_heads, scale=scale, mask=mask, dp=dp1)


def hab_fwd_h(x_windows, convx_windows, mask, dp1, dp2, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
              bproj, ln2_w, ln2_b, w1, b1, w2, b2, *, num_heads: int, scale: float,
              conv_scale: float = 0.01, padded: tuple | None = None):
    """K9a: ``(out, h)`` of one HAB over ``(Bw, 64, C)`` windows.

    CUDA tensors launch the kernel (counted in ``hab_fwd_h.launches``) or
    raise; CPU tensors take :func:`hab_fwd_h_reference`. ``padded``: the
    weights already through :func:`~.hab_block.pad_hab_operands`.
    """
    args = (x_windows, convx_windows, mask, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
            ln2_w, ln2_b, w1, b1, w2, b2)
    kw = dict(num_heads=num_heads, scale=scale, conv_scale=conv_scale)
    if not _on_cuda("hab_fwd_h", x_windows):
        return hab_fwd_h_reference(*args[:3], dp1, dp2, *args[3:], **kw)
    out = launch_hab("hab_fwd_h", *args, **kw, padded=padded, dp=(dp1, dp2))
    hab_fwd_h.launches += 1
    return out


hab_fwd_h.launches = 0


def _f32_or_none(t):
    return t.float().contiguous() if t is not None else None


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _check_scale(name: str, dp, bw: int, device) -> None:
    if dp is not None and (tuple(dp.shape) != (bw,) or dp.device != device):
        raise ValueError(f"{name}: a branch scale wants ({bw},) on the windows' device, got "
                         f"{tuple(dp.shape)} on {dp.device}")


def pad_mlp_operands(ln2_w, ln2_b, w1, b1, w2, width: int) -> tuple:
    """K9b's weights with the channels zero-padded to ``width``: LN2's
    vectors (fp32), w1's rows and w2's columns; b1 fp32."""
    c = w1.shape[0]
    pad = width - c
    f32 = torch.float32
    out = (F.pad(ln2_w.to(f32), (0, pad)), F.pad(ln2_b.to(f32), (0, pad)),
           F.pad(w1, (0, 0, 0, pad)), b1.to(f32), F.pad(w2, (0, pad)))
    return tuple(t.contiguous() for t in out)


def hab_bwd_mlp(h, dout, dp2, ln2_w, ln2_b, w1, b1, w2, *, padded: tuple | None = None):
    """K9b: ``(dh, dln2_w, dln2_b, dw1, db1, dw2, db2)`` from the saved h.

    CUDA tensors launch the kernels (counted in ``hab_bwd_mlp.launches``) or
    raise; CPU tensors take :func:`hab_bwd_mlp_reference`. ``padded``: the
    weights through :func:`pad_mlp_operands` (or the same five operands of
    :func:`~.hab_block.pad_hab_operands` or :func:`~.ocab.pad_ocab_operands`).
    """
    if not _on_cuda("hab_bwd_mlp", h):
        return hab_bwd_mlp_reference(h, dout, dp2, ln2_w, ln2_b, w1, b1, w2)
    name = "hab_bwd_mlp"
    bw, n, c = _check_windows(name, h, dout)
    hidden = w1.shape[1]
    if c % 2 or hidden % 4:
        raise ValueError(f"{name}: unsupported widths C={c}, hidden={hidden}")
    for key, w, want in (("w1", w1, (c, hidden)), ("w2", w2, (hidden, c))):
        if tuple(w.shape) != want or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} wants bfloat16 {want}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    for key, v, size in (("ln2_w", ln2_w, c), ("ln2_b", ln2_b, c), ("b1", b1, hidden)):
        if tuple(v.shape) != (size,):
            raise ValueError(f"{name}: {key} wants ({size},), got {tuple(v.shape)}")
    if any(t.device != h.device for t in (dout, ln2_w, ln2_b, w1, b1, w2)):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    _check_scale(name, dp2, bw, h.device)
    if padded is None:
        padded = pad_mlp_operands(ln2_w, ln2_b, w1, b1, w2, -(-c // 4) * 4)
    ln2_wp, ln2_bp, w1p, b1p, w2p = padded
    cp = w1p.shape[0]
    if cp % 4 or cp > 256 or cp < c:
        raise ValueError(f"{name}: padded width {cp} for C={c}")
    lib = _train_library()
    if lib.swin_bwd_mlp_smem_bytes(cp, hidden) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c}, hidden={hidden} need more than 227 KB shared memory")
    h, dout = h.contiguous(), dout.contiguous()
    if h.data_ptr() % 16 or dout.data_ptr() % 4:
        raise ValueError(f"{name}: windows must be 16-byte aligned")
    t = bw * n
    dh = torch.empty_like(h)
    hn, dm = (torch.empty(t, cp, dtype=torch.bfloat16, device=h.device) for _ in range(2))
    g, du = (torch.empty(t, hidden, dtype=torch.bfloat16, device=h.device) for _ in range(2))
    vec = torch.empty(bw, hidden + 3 * cp, dtype=torch.float32, device=h.device)
    wpack = torch.empty(lib.swin_bwd_mlp_pack_bytes(cp, hidden) // 2, dtype=torch.bfloat16,
                        device=h.device)
    dp2 = _f32_or_none(dp2)
    with torch.cuda.device(h.device):
        _check(lib.hab_bwd_mlp_bf16(h.data_ptr(), dout.data_ptr(), _ptr(dp2),
                                    *_ptrs(ln2_wp, ln2_bp, w1p, b1p, w2p, dh, hn, g, du, dm, vec,
                                           wpack),
                                    bw, cp, c, hidden, _stream(h.device)), "hab_bwd_mlp_bf16")
        dw1 = _wgrad(lib, hn, du)[:c]
        dw2 = _wgrad(lib, g, dm)[:, :c]
        db1, db2, dln2_w, dln2_b = _colsum(lib, vec).split([hidden, cp, cp, cp])
    hab_bwd_mlp.launches += 1
    return dh, dln2_w[:c], dln2_b[:c], dw1, db1, dw2, db2[:c]


hab_bwd_mlp.launches = 0


def hab_bwd_attn(x, dh, mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, *, num_heads: int,
                 scale: float, padded: tuple | None = None):
    """K9c: ``(dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj)``.

    CUDA tensors launch the kernels (counted in ``hab_bwd_attn.launches``) or
    raise; CPU tensors take :func:`hab_bwd_attn_reference`. ``padded``: the
    weights through :func:`~.hab_block.pad_attn_operands` (or all twelve of
    :func:`~.hab_block.pad_hab_operands`, whose first five they are).
    """
    if not _on_cuda("hab_bwd_attn", x):
        return hab_bwd_attn_reference(x, dh, mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                                      num_heads=num_heads, scale=scale)
    name = "hab_bwd_attn"
    bw, n, c = _check_windows(name, x, dh)
    hd = c // num_heads
    hdp = padded_head_dim(hd, num_heads)
    cp = num_heads * hdp
    if c % num_heads or c % 2 or hdp > 32 or cp > 256:
        raise ValueError(f"{name}: unsupported width C={c} with {num_heads} heads")
    for key, w, want in (("wqkv", wqkv, (c, 3 * c)), ("wproj", wproj, (c, c))):
        if tuple(w.shape) != want or w.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {key} wants bfloat16 {want}, got {w.dtype} "
                             f"{tuple(w.shape)}")
    for key, v, size in (("ln1_w", ln1_w, c), ("ln1_b", ln1_b, c), ("bqkv", bqkv, 3 * c)):
        if tuple(v.shape) != (size,):
            raise ValueError(f"{name}: {key} wants ({size},), got {tuple(v.shape)}")
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"{name}: bias wants {(num_heads, n, n)}, got {tuple(bias.shape)}")
    _check_mask(name, mask, bw, n)
    others = (dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj) + ((mask,) if mask is not None else ())
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: every operand must be on the windows' device")
    _check_scale(name, dp1, bw, x.device)
    lib = _train_library()
    if _attn_sizes(cp, num_heads)[2] > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={c} needs more than 227 KB shared memory")
    if padded is None:
        padded = pad_attn_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, num_heads=num_heads)
    ln1_wp, ln1_bp, wqkvp, bqkvp, wprojp = padded[:5]
    x, dh = x.contiguous(), dh.contiguous()
    bias = _f32(bias)
    mask_t = None if mask is None else _f32(mask)
    dp1 = None if dp1 is None else _f32(dp1)
    nw = mask.shape[0] if mask is not None else 1

    def launch(dx, xn, att, dqkv, dhs, part, wpack, wpw, stream):
        _check(lib.hab_bwd_attn_bf16(
            x.data_ptr(), dh.data_ptr(), _ptr(dp1), _ptr(mask_t),
            *_ptrs(ln1_wp, ln1_bp, wqkvp, bqkvp, bias, wprojp), dx, xn, att, dqkv, dhs, part,
            wpack, bw, cp, c, num_heads, nw, wpw, float(scale), stream), "hab_bwd_attn_bf16")

    with torch.cuda.device(x.device):
        out = _attn_window_grads(lib, launch, x, dh, num_heads, cp, hd, dhs=True)
    hab_bwd_attn.launches += 1
    return out


hab_bwd_attn.launches = 0


class HabCoreFn(torch.autograd.Function):
    """One HAB window core with K9a forward and K9b + K9c backward (the JAX
    ``hab_core_ad``). Inputs as :func:`hab_fwd_h`'s, then ``num_heads``,
    ``scale``, ``conv_scale`` and ``padded`` (the weights through
    :func:`~.hab_block.pad_hab_operands`, or ``None``). The conv branch's
    gradient is ``conv_scale * dh``; the mask and the branch scales get none.
    Each gradient comes back in its input's dtype, as ``_hab_ad_bwd`` casts it."""

    @staticmethod
    def forward(ctx, x, convx, mask, dp1, dp2, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj,
                ln2_w, ln2_b, w1, b1, w2, b2, num_heads, scale, conv_scale, padded):
        params = (ln1_w, ln1_b, wqkv, bqkv, bias, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2)
        out, h = hab_fwd_h(x, convx, mask, dp1, dp2, *params, num_heads=num_heads,
                           scale=scale, conv_scale=conv_scale, padded=padded)
        ctx.save_for_backward(x, h, mask, dp1, dp2, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                              ln2_w, ln2_b, w1, b1, w2)
        ctx.dtypes = [p.dtype for p in params]
        ctx.convx_dtype = convx.dtype
        ctx.num_heads, ctx.scale, ctx.conv_scale, ctx.padded = num_heads, scale, conv_scale, padded
        return out

    @staticmethod
    def backward(ctx, dout):
        (x, h, mask, dp1, dp2, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, ln2_w, ln2_b, w1, b1,
         w2) = ctx.saved_tensors
        padded = ctx.padded
        dh, dln2_w, dln2_b, dw1, db1, dw2, db2 = hab_bwd_mlp(
            h, dout.contiguous(), dp2, ln2_w, ln2_b, w1, b1, w2,
            padded=padded and padded[6:11])
        dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj = hab_bwd_attn(
            x, dh, mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
            num_heads=ctx.num_heads, scale=ctx.scale, padded=padded)
        dconvx = (ctx.conv_scale * dh.float()).to(ctx.convx_dtype)
        grads = (dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj, dln2_w, dln2_b,
                 dw1, db1, dw2, db2)
        return (dx, dconvx, None, None, None, *(g.to(dt) for g, dt in zip(grads, ctx.dtypes)),
                None, None, None, None)
