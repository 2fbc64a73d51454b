"""Spatially sharded HAT and HybridHATRealESRGAN forwards, inference (the JAX ``parallel/spatial_hat.py``).

The companion of :mod:`.spatial` for the second generator family: the
image's H axis is split over the ranks and every rank runs the whole
forward on its rows, communicating exactly where HAT's locality breaks:

- 3x3 convs (conv_first, the RHAG convs, conv_after_body, the upsampler,
  the hybrid's RRDB trunk and head): a one-row halo, zero at the global
  boundary;
- shifted windows: the cyclic ws/2-row roll by halo exchange, plus the
  reference's shift masks (hat_arch.py:921-940), built for the whole frame
  and sliced to the rank's window rows;
- the CAB's channel attention: its global average pool is the local pool
  all-reduced over the ranks (equal shard sizes);
- the OCAB: its owin x owin key/value windows take (owin - ws) / 2 rows
  from each neighbour (zero at the global boundary, as ``nn.Unfold``'s zero
  padding); the W padding stays local.

Drop-path is the identity (eval semantics). As in :mod:`.spatial`, one rank
runs no collective, the local math calls the port modules' own layers, and
the window attention goes through ``window_attention(impl=attn_impl)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import (
    pixel_shuffle,
    relative_position_bias_oca,
    resize_nearest,
    shift_mask,
    window_partition,
    window_reverse,
)
from ..kernels.window_attention import window_attention
from .mesh import Mesh
from .spatial import (
    _halo,
    gather_rows,
    halo_conv3,
    halo_conv3_nhwc,
    local_rows,
    shifted_window_attention,
)


def _channel_attention(ca, y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``ChannelAttention`` on an H-sharded NCHW shard: the global average
    pool is the local pool averaged over the ranks."""
    att = ca.attention
    pooled = att[0](y)
    if mesh.size > 1:
        pooled = pooled.clone()
        dist.all_reduce(pooled, group=mesh.group)
        pooled = pooled / mesh.size
    for layer in att[1:]:
        pooled = layer(pooled)
    return y * pooled


def _hab(blk, x, ss: int, mask, impl: str, mesh: Mesh):
    """One HAB on an H-sharded (B, Hl, W, C) shard."""
    ws = blk.window_size
    xn = blk.norm1(x)
    cab = blk.conv_block.cab
    y = F.gelu(halo_conv3(xn.permute(0, 3, 1, 2), cab[0], mesh))
    y = _channel_attention(cab[3], halo_conv3(y, cab[2], mesh), mesh)
    conv_x = y.permute(0, 2, 3, 1)
    attn_x = shifted_window_attention(blk.attn, xn, ws, ss, mask if ss else None, impl, mesh)
    x = x + attn_x + conv_x * blk.conv_scale
    return x + blk.mlp(blk.norm2(x))


def _ocab(oc, x, impl: str, mesh: Mesh):
    """The OCAB on an H-sharded shard: the overlap windows' key/value rows
    come from the neighbours."""
    b, hl, w, c = x.shape
    ws, owin, heads = oc.window_size, oc.overlap_win_size, oc.num_heads
    pad = (owin - ws) // 2
    d = c // heads
    qkv = oc.qkv(oc.norm1(x))
    q = window_partition(qkv[..., :c], ws).reshape(-1, ws * ws, c)
    kv = _halo(qkv[..., c:], pad, mesh, axis=1)  # (B, Hl + 2 pad, W, 2C)
    kvp = F.pad(kv, (0, 0, pad, pad))  # the W padding, local
    rows = torch.arange(hl // ws, device=x.device)[:, None] * ws + torch.arange(
        owin, device=x.device)[None, :]
    cols = torch.arange(w // ws, device=x.device)[:, None] * ws + torch.arange(
        owin, device=x.device)[None, :]
    kvw = kvp[:, rows][:, :, :, cols].permute(0, 1, 3, 2, 4, 5).reshape(-1, owin * owin, 2 * c)
    bw, nq, _ = q.shape
    nk = kvw.shape[1]
    qh = q.reshape(bw, nq, heads, d).transpose(1, 2)
    kh = kvw[..., :c].reshape(bw, nk, heads, d).transpose(1, 2)
    vh = kvw[..., c:].reshape(bw, nk, heads, d).transpose(1, 2)
    bias = relative_position_bias_oca(oc.relative_position_bias_table, ws, oc.overlap_ratio)
    out = window_attention(qh, kh, vh, bias, scale=d**-0.5, impl=impl)
    out = out.transpose(1, 2).reshape(-1, ws, ws, c)
    x = oc.proj(window_reverse(out, ws, hl, w)) + x
    return x + oc.mlp(oc.norm2(x))


def _hat_local(hat, impl: str, mesh: Mesh):
    """The local forward of a :class:`~..models.HAT` (pixelshuffle head) on
    an H-sharded NHWC shard of a frame of global size ``(h, w)``."""
    ws = hat.window_size

    def fwd(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        shift = min(h, w) > ws  # the module's one-window rule, on the whole frame
        masks = {}
        if shift:
            full = shift_mask(h, w, ws, ws // 2, x.device)
            nw = (x.shape[1] // ws) * (w // ws)  # this rank's windows, in window-row order
            masks = full[mesh.rank * nw:(mesh.rank + 1) * nw]
        mean = hat.mean(x)
        x = (x - mean) * hat.img_range
        feat = halo_conv3_nhwc(x, hat.conv_first, mesh)
        res = feat
        if hat.patch_embed is not None:
            res = hat.patch_embed.norm(res)
        for layer in hat.layers:
            gin = res
            for blk in layer.residual_group.blocks:
                ss = blk.shift_size if shift else 0
                res = _hab(blk, res, ss, masks if ss else None, impl, mesh)
            res = _ocab(layer.residual_group.overlap_attn, res, impl, mesh)
            res = halo_conv3_nhwc(res, layer.conv, mesh) + gin
        feat = halo_conv3_nhwc(hat.norm(res), hat.conv_after_body, mesh) + feat
        out = F.leaky_relu(halo_conv3_nhwc(feat, hat.conv_before_upsample[0], mesh), 0.01)
        for conv, shuffle in zip(hat.upsample[::2], hat.upsample[1::2]):
            out = pixel_shuffle(halo_conv3_nhwc(out, conv, mesh), shuffle.upscale_factor)
        return halo_conv3_nhwc(out, hat.conv_last, mesh) / hat.img_range + mean

    return fwd


def make_spatial_hat(mesh: Mesh, model, *, attn_impl: str = "xla"):
    """``fn(x)`` running the :class:`~..models.HAT` ``model`` H-sharded over
    ``mesh`` (eval): ``x`` (B, H, W, C) the whole frame on every rank, H %
    (ranks * ws) == 0, W % ws == 0; the whole output on every rank."""
    local = _hat_local(model, attn_impl, mesh)

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        return gather_rows(local(local_rows(x, mesh, model.window_size).to(mesh.device), h, w),
                           mesh)

    return fn


def make_spatial_hybrid(mesh: Mesh, model, *, attn_impl: str = "xla"):
    """H-sharded :class:`~..models.HybridHATRealESRGAN` forward (eval): the
    HAT x2 backbone, then the RRDB trunk and the x2 head with halo convs."""
    hat_local = _hat_local(model.hat, attn_impl, mesh)

    def rdb(blk, x):  # NCHW, as the module's dense block
        srcs = [x]
        for conv in blk.convs()[:4]:
            srcs.append(F.leaky_relu(halo_conv3(torch.cat(srcs, 1), conv, mesh), 0.2))
        return halo_conv3(torch.cat(srcs, 1), blk.conv5, mesh) * 0.2 + x

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = local_rows(x, mesh, model.hat.window_size).to(mesh.device)
        feat = F.leaky_relu(halo_conv3_nhwc(hat_local(x, h, w), model.conv_adapt, mesh), 0.2)
        trunk = feat.permute(0, 3, 1, 2)
        for rrdb in model.rrdb_trunk:
            trunk = rdb(rrdb.rdb3, rdb(rrdb.rdb2, rdb(rrdb.rdb1, trunk))) * 0.2 + trunk
        feat = feat + halo_conv3(trunk, model.conv_body, mesh).permute(0, 2, 3, 1)
        feat = F.leaky_relu(halo_conv3_nhwc(resize_nearest(feat, 2), model.conv_up, mesh), 0.2)
        out = halo_conv3_nhwc(F.leaky_relu(halo_conv3_nhwc(feat, model.conv_hr, mesh), 0.2),
                              model.conv_last, mesh)
        return gather_rows(out, mesh)

    return fn
