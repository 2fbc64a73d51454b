"""Fused HAT / HybridHATRealESRGAN forwards (the JAX ``kernels/fused_hat.py``
and the fused generator of ``train/state.py::create_hat_train_state``).

:func:`make_fused_hat` runs every HAB through K5 (:func:`~.hab_block.fused_hab_block`)
and every OCAB tail through K6 (:func:`~.ocab.fused_ocab_block`);
:func:`make_fused_hybrid` adds the RRDB trunk through K7
(:func:`~.fused_rdb_cm.fused_rrdb_trunk_cm`). :func:`make_fused_hybrid_train`
is the differentiable hybrid for training: the HAT backbone as its
``nn.Module`` (with drop-path) and the trunk through K7 forward and K8
backward (:func:`~.fused_rdb_cm_bwd.fused_rrdb_trunk_cm_ad`). The CAB branch (3x3 convs,
GELU, channel attention), OCAB's LN1 and qkv product, the RHAG convs and the
heads stay PyTorch ops, as the JAX package leaves them to XLA. The rolls and
window partition/reverse around each HAB are one row gather each way
(:func:`~.swin_block._gather_rows`), and conv_x goes through the same
permutation as x: the sum x + attn + conv_scale * conv_x is formed in shifted
space and rolled back, which is the reference's sum since rolls are
permutations and the MLP and LN2 act per token.

The inference forwards cast, lay out and pad (or pack) the operands for the
kernels once, when the forward is made, and do not see later changes to the
model; :func:`make_fused_hybrid_train` reads the parameters at every call
and repacks a dense block's weights when they have changed. Computes in
``dtype`` (bf16 by default) with LayerNorms in fp32; H and W must be window
multiples.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..ops import (
    overlap_windows,
    pixel_shuffle,
    relative_position_bias,
    relative_position_bias_oca,
    resize_nearest,
    window_partition,
    window_reverse,
)
from ..models.hat import shift_mask
from .fused_rdb_cm import fused_rrdb_trunk_cm, pack_rdb_weights
from .fused_rdb_cm_bwd import fused_rrdb_trunk_cm_ad
from .hab_block import fused_hab_block, pad_hab_operands
from .ocab import fused_ocab_block, pad_ocab_operands
from .swin_block import _gather_rows, _gelu, _ln_f32, token_order


def _conv3(wb, x):
    """3x3 conv, padding 1, of an NHWC tensor through NCHW views."""
    return F.conv2d(x.permute(0, 3, 1, 2), wb[0], wb[1], padding=1).permute(0, 2, 3, 1)


def _ln(wb, x):
    return _ln_f32(x, *wb).to(x.dtype)


def _cab(ops, xn):
    """The CAB branch of an NHWC input: conv, GELU (tanh for bf16, as the JAX
    fused path), conv, channel attention."""
    conv1, conv2, fc1, fc2 = ops
    y = F.conv2d(xn.permute(0, 3, 1, 2), conv1[0], conv1[1], padding=1)
    y = F.conv2d(_gelu(y, xn.dtype).to(xn.dtype), conv2[0], conv2[1], padding=1)
    att = torch.relu(F.linear(y.mean((2, 3)), fc1[0], fc1[1]))
    att = torch.sigmoid(F.linear(att, fc2[0], fc2[1]))
    return (y * att[:, :, None, None]).permute(0, 2, 3, 1)


def make_fused_hat(model, *, dtype: torch.dtype = torch.bfloat16):
    """``forward(x)`` for a :class:`~..models.HAT` with its HABs through K5 and
    its OCAB tails through K6; NHWC in and out, under ``torch.no_grad``."""
    ws = model.window_size
    n = ws * ws
    owin = int(ws * model.overlap_ratio) + ws

    def wb(m):
        return m.weight.to(dtype), m.bias.to(dtype)

    def ln(m):
        return m.weight.float(), m.bias.float()

    def lin(m):  # (in, out) in dtype, bias fp32: the kernels' layout
        return m.weight.T.to(dtype).contiguous(), m.bias.float()

    def hab_ops(blk):
        a, mlp = blk.attn, blk.mlp
        cab = blk.conv_block.cab
        ca = cab[3].attention
        bias = relative_position_bias(a.relative_position_bias_table, ws).float().contiguous()
        weights = (*ln(blk.norm1), *lin(a.qkv), *lin(a.proj), *ln(blk.norm2), *lin(mlp.fc1),
                   *lin(mlp.fc2))
        kernel = (*weights[:4], bias, *weights[4:])
        padded = pad_hab_operands(*weights, num_heads=a.num_heads)
        cab_ops = (wb(cab[0]), wb(cab[2]),
                   (ca[1].weight[:, :, 0, 0].to(dtype), ca[1].bias.to(dtype)),
                   (ca[3].weight[:, :, 0, 0].to(dtype), ca[3].bias.to(dtype)))
        return ln(blk.norm1), cab_ops, kernel, padded, a.num_heads, blk.shift_size

    def ocab_ops(oc):
        bias = relative_position_bias_oca(oc.relative_position_bias_table, ws, oc.overlap_ratio)
        weights = (*lin(oc.proj), *ln(oc.norm2), *lin(oc.mlp.fc1), *lin(oc.mlp.fc2))
        return (ln(oc.norm1), wb(oc.qkv), oc.num_heads, (bias.float().contiguous(), *weights),
                pad_ocab_operands(*weights))

    with torch.no_grad():
        groups = [([hab_ops(blk) for blk in layer.residual_group.blocks],
                   ocab_ops(layer.residual_group.overlap_attn), wb(layer.conv))
                  for layer in model.layers]
        patch_norm = ln(model.patch_embed.norm) if model.patch_embed is not None else None
        norm = ln(model.norm)
        first, after_body, before_up, last = (
            wb(m) for m in (model.conv_first, model.conv_after_body,
                            model.conv_before_upsample[0], model.conv_last))
        up = [wb(m) for m in model.upsample[::2]]
    factors = [shuffle.upscale_factor for shuffle in model.upsample[1::2]]
    def hab(ops, x):
        norm1, cab_ops, kernel, padded, heads, shift = ops
        b, h, w, c = x.shape
        if min(h, w) <= ws:  # the reference's rule: one window runs unshifted
            shift = 0
        conv_x = _cab(cab_ops, _ln(norm1, x)).contiguous()
        fwd, inv = token_order(b, h, w, ws, shift, x.device)
        mask = shift_mask(h, w, ws, shift, x.device) if shift else None
        out = fused_hab_block(
            _gather_rows(x.reshape(-1, c), fwd).reshape(-1, n, c),
            _gather_rows(conv_x.reshape(-1, c), fwd).reshape(-1, n, c), mask, *kernel,
            num_heads=heads, scale=(c // heads) ** -0.5, conv_scale=model.conv_scale,
            padded=padded)
        return _gather_rows(out.reshape(-1, c), inv).reshape(b, h, w, c)

    def ocab(ops, x):
        norm1, qkv_wb, heads, kernel, padded = ops
        b, h, w, c = x.shape
        qkv = F.linear(_ln(norm1, x), *qkv_wb)
        kv = overlap_windows(qkv[..., c:], ws, owin)
        out = fused_ocab_block(
            window_partition(x, ws).reshape(-1, n, c),
            window_partition(qkv[..., :c], ws).reshape(-1, n, c),
            kv[..., :c].contiguous(), kv[..., c:].contiguous(), *kernel,
            num_heads=heads, scale=(c // heads) ** -0.5, padded=padded)
        return window_reverse(out.reshape(-1, ws, ws, c), ws, h, w)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % ws or w % ws:
            raise ValueError(f"fused HAT needs H and W multiples of {ws}, got {h}x{w}")
        x = x.to(dtype)
        mean = model.mean(x)
        x = (x - mean) * model.img_range
        feat = _conv3(first, x)
        res = _ln(patch_norm, feat) if patch_norm is not None else feat
        for blocks, ocab_args, conv in groups:
            gin = res
            for ops in blocks:
                res = hab(ops, res)
            res = _conv3(conv, ocab(ocab_args, res)) + gin
        feat = _conv3(after_body, _ln(norm, res)) + feat
        out = F.leaky_relu(_conv3(before_up, feat), 0.01)
        for wb_, r in zip(up, factors):
            out = pixel_shuffle(_conv3(wb_, out), r)
        return _conv3(last, out) / model.img_range + mean

    return forward


def make_fused_hybrid(model, *, dtype: torch.dtype = torch.bfloat16):
    """``forward(x)`` for a :class:`~..models.HybridHATRealESRGAN`: the fused
    HAT (K5, K6) and the RRDB trunk through K7, at every trunk width (the JAX
    package runs its kernel only when W is a multiple of 128). NHWC in and
    out, under ``torch.no_grad``."""
    hat_fwd = make_fused_hat(model.hat, dtype=dtype)

    def wb(m):
        return m.weight.to(dtype), m.bias.to(dtype)

    def dense_block(rdb):
        kernels = [c.weight.permute(2, 3, 1, 0).to(dtype).contiguous() for c in rdb.convs()]
        biases = [c.bias.float() for c in rdb.convs()]
        packed = (pack_rdb_weights(kernels, biases, kernels[0].device)
                  if kernels[0].is_cuda else None)
        return kernels, biases, packed

    with torch.no_grad():
        rrdbs = [[dense_block(rdb) for rdb in (rrdb.rdb1, rrdb.rdb2, rrdb.rdb3)]
                 for rrdb in model.rrdb_trunk]
        adapt, body, up, hr, last = (wb(m) for m in (model.conv_adapt, model.conv_body,
                                                     model.conv_up, model.conv_hr,
                                                     model.conv_last))

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        feat = F.leaky_relu(_conv3(adapt, hat_fwd(x.to(dtype))), 0.2)
        trunk = fused_rrdb_trunk_cm(rrdbs, feat)
        feat = feat + _conv3(body, trunk)
        feat = F.leaky_relu(_conv3(up, resize_nearest(feat, 2)), 0.2)
        return _conv3(last, F.leaky_relu(_conv3(hr, feat), 0.2))

    return forward


def make_fused_hybrid_train(model, *, dtype: torch.dtype = torch.bfloat16):
    """``forward(x, deterministic=True, generator=None)`` of a
    :class:`~..models.HybridHATRealESRGAN` for training, as the JAX fused
    ``core_fwd``: HAT through its ``nn.Module`` in ``dtype`` (parameters cast
    inside autograd, drop-path on when ``deterministic`` is False, drawn from
    ``generator``), ``lrelu(conv_adapt)``, the RRDB trunk through K7/K8 on the
    fp32 master weights (rounded inside; their gradients come back fp32),
    ``conv_body`` plus the residual, nearest x2 and ``conv_up``, ``conv_hr``,
    ``conv_last``. It runs the kernels at every trunk width; on CPU tensors
    their plain versions run."""
    hat = model.hat

    def wb(m):
        return m.weight.to(dtype), m.bias.to(dtype)

    def forward(x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        params = {k: v.to(dtype) for k, v in hat.named_parameters()}
        hat_out = functional_call(hat, params, (x.to(dtype), deterministic, generator))
        feat = F.leaky_relu(_conv3(wb(model.conv_adapt), hat_out), 0.2)
        rrdbs = [[([c.weight for c in rdb.convs()], [c.bias for c in rdb.convs()])
                  for rdb in (rrdb.rdb1, rrdb.rdb2, rrdb.rdb3)] for rrdb in model.rrdb_trunk]
        feat = feat + _conv3(wb(model.conv_body), fused_rrdb_trunk_cm_ad(rrdbs, feat))
        feat = F.leaky_relu(_conv3(wb(model.conv_up), resize_nearest(feat, 2)), 0.2)
        return _conv3(wb(model.conv_last), F.leaky_relu(_conv3(wb(model.conv_hr), feat), 0.2))

    return forward
