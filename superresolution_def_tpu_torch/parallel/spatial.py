"""Spatially sharded SwinIR forward: context parallelism over the ranks (the JAX ``parallel/spatial.py``).

Beyond tiling, the image's H axis is split over the ranks and every rank
runs the whole SwinIR forward on its run of rows, exchanging halos where
locality breaks:

- 3x3 convs take one row from each neighbour (``batch_isend_irecv`` on the
  ring), zero at the global boundary: the dense conv's zero padding;
- shifted windows (a cyclic roll by ws/2) take ws/2 rows from the
  neighbour: the global ``torch.roll`` (SwinIR shifts without a mask,
  architecture_swin.py:138, so the cyclic semantics carry over);
- LayerNorm, window attention, the MLP and the pixel shuffle are pointwise
  or window-local, hence rank-local.

A neighbour that is the rank itself (one rank) is a local copy, so a world
of one runs no collective and differs from the module only in how the 3x3
convs get their padding. The local math calls the port module's own
layers and weights; the window attention goes through
:func:`~..kernels.window_attention.window_attention` with ``attn_impl``
(``"pallas"``: K11 on the card). Inference only (``torch.no_grad``).
Requirements: H divisible by (ranks * ws), W by ws.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.window_attention import window_attention
from ..ops import pixel_shuffle, relative_position_bias, window_partition, window_reverse
from .mesh import Mesh


# --------------------------------------------------------------------------- #
# halo primitives (H is dim ``axis`` of the local shard)
# --------------------------------------------------------------------------- #
def _from_neighbour(send: torch.Tensor, mesh: Mesh, from_prev: bool) -> torch.Tensor:
    """Every rank sends ``send`` one way round the ring and returns what its
    neighbour sent: from the previous rank (``from_prev``) or the next one.
    The ring is cyclic; one rank is its own neighbour (a copy)."""
    if mesh.size == 1:
        return send.clone()
    send = send.contiguous()
    recv = torch.empty_like(send)
    prev, nxt = (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size
    dst, src = (nxt, prev) if from_prev else (prev, nxt)
    ops = [dist.P2POp(dist.isend, send, dst, group=mesh.group),
           dist.P2POp(dist.irecv, recv, src, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _halo(x: torch.Tensor, rows: int, mesh: Mesh, axis: int) -> torch.Tensor:
    """``x`` with ``rows`` rows of each neighbour above and below along
    ``axis``, zero at the global boundary."""
    n = x.shape[axis]
    top, bot = x.narrow(axis, n - rows, rows), x.narrow(axis, 0, rows)
    if mesh.size > 1:
        top = _from_neighbour(top, mesh, from_prev=True)
        bot = _from_neighbour(bot, mesh, from_prev=False)
    if mesh.rank == 0:
        top = torch.zeros_like(top)
    if mesh.rank == mesh.size - 1:
        bot = torch.zeros_like(bot)
    return torch.cat([top, x, bot], dim=axis)


def halo_conv3(x: torch.Tensor, conv: torch.nn.Conv2d, mesh: Mesh) -> torch.Tensor:
    """3x3 stride-1 ``conv`` with global zero padding on an NCHW shard."""
    return F.conv2d(_halo(x, 1, mesh, axis=2), conv.weight, conv.bias, padding=(0, 1))


def halo_conv3_nhwc(x: torch.Tensor, conv: torch.nn.Conv2d, mesh: Mesh) -> torch.Tensor:
    return halo_conv3(x.permute(0, 3, 1, 2), conv, mesh).permute(0, 2, 3, 1)


def roll_up(x: torch.Tensor, s: int, mesh: Mesh) -> torch.Tensor:
    """The global ``torch.roll(x, -s, 1)`` of an H-sharded NHWC tensor."""
    return torch.cat([x[:, s:], _from_neighbour(x[:, :s], mesh, from_prev=False)], dim=1)


def roll_down(x: torch.Tensor, s: int, mesh: Mesh) -> torch.Tensor:
    """The global ``torch.roll(x, +s, 1)``."""
    return torch.cat([_from_neighbour(x[:, -s:], mesh, from_prev=True), x[:, :-s]], dim=1)


def window_self_attention(attn, xw: torch.Tensor, mask, impl: str) -> torch.Tensor:
    """The forward of a ``WindowAttention``/``WindowAttentionRPI`` module on
    (Bw, N, C) windows, with ``impl`` for the attention core."""
    bw, n, c = xw.shape
    h = attn.num_heads
    d = c // h
    qkv = attn.qkv(xw).reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
    bias = relative_position_bias(attn.relative_position_bias_table, attn.window_size)
    out = window_attention(qkv[0], qkv[1], qkv[2], bias, mask, scale=d**-0.5, impl=impl)
    return attn.proj(out.transpose(1, 2).reshape(bw, n, c))


def shifted_window_attention(attn, x, ws: int, ss: int, mask, impl: str, mesh: Mesh):
    """(S)W-MSA of an H-sharded NHWC shard: roll by ``ss`` (0: none), the
    window attention with ``mask``, roll back."""
    _, hl, w, c = x.shape
    if ss:
        x = torch.roll(roll_up(x, ss, mesh), -ss, dims=2)  # W is unsharded: a local roll
    y = window_self_attention(attn, window_partition(x, ws).reshape(-1, ws * ws, c), mask, impl)
    y = window_reverse(y.reshape(-1, ws, ws, c), ws, hl, w)
    if ss:
        y = torch.roll(roll_down(y, ss, mesh), ss, dims=2)
    return y


def local_rows(x: torch.Tensor, mesh: Mesh, quantum: int) -> torch.Tensor:
    """This rank's run of H rows of the (B, H, W, C) frame ``x``; H must
    divide into ranks x ``quantum``, W into ``quantum``."""
    _, h, w, _ = x.shape
    if h % (mesh.size * quantum) or w % quantum:
        raise ValueError(f"H={h} must divide by ranks x ws = {mesh.size * quantum} and "
                         f"W={w} by ws = {quantum}")
    hl = h // mesh.size
    return x[:, mesh.rank * hl:(mesh.rank + 1) * hl]


def gather_rows(y: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """The ranks' shards of ``y`` along ``axis`` (default: H of NHWC),
    concatenated in rank order on every rank."""
    if mesh.group is None:
        return y
    parts = [torch.empty_like(y) for _ in range(mesh.size)]
    dist.all_gather(parts, y.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=axis)


# --------------------------------------------------------------------------- #
# the sharded forward
# --------------------------------------------------------------------------- #
def make_spatial_swinir(mesh: Mesh, model, *, attn_impl: str = "xla"):
    """``fn(x)`` running the :class:`~..models.SwinIR` ``model`` H-sharded
    over ``mesh``: ``x`` (B, H, W, C) is the whole frame on every rank (any
    device), H % (ranks * ws) == 0 and W % ws == 0; returns the whole
    (B, H * upscale, W * upscale, C) output on every rank, on the mesh's
    device."""
    ws = model.window_size

    def block(blk, x, ss):
        y = shifted_window_attention(blk.attn, blk.norm1(x), ws, ss, None, attn_impl, mesh)
        x = x + y
        return x + blk.mlp(blk.norm2(x))

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = local_rows(x, mesh, ws).to(mesh.device)
        # the module's rule: an input of one window runs unshifted
        shift = min(h, w) > ws
        x_first = halo_conv3_nhwc(x, model.conv_first, mesh)
        res = x_first
        for layer in model.layers:
            for blk in layer:
                res = block(blk, res, blk.shift_size if shift else 0)
        res = halo_conv3_nhwc(model.norm(res), model.conv_after_body, mesh) + x_first
        out = F.leaky_relu(halo_conv3_nhwc(res, model.conv_before_upsample[0], mesh), 0.01)
        for conv, shuffle in zip(model.upsample[::2], model.upsample[1::2]):
            out = pixel_shuffle(halo_conv3_nhwc(out, conv, mesh), shuffle.upscale_factor)
        return gather_rows(halo_conv3_nhwc(out, model.conv_last, mesh), mesh)

    return fn
