"""SwinIR super-resolution generator as a PyTorch ``nn.Module``.

Mirrors the JAX ``models/swinir.py`` and keeps its deviations from canonical
SwinIR:
  - shifted windows attend WITHOUT a boundary mask (the reference passes
    mask=None), so wrapped borders attend across the roll seam;
  - the input is reflect-padded to a window multiple and the output cropped
    to H*scale x W*scale;
  - blocks use the runtime (padded) resolution, not ``img_size``;
  - an input no larger than one window runs its blocks unshifted;
  - no drop-path, absolute position embedding or dropout; mlp_ratio 4.

``state_dict()`` keys are the reference torch keys (``conv_first.*``,
``layers.{i}.{j}.*``, ``norm.*``, ``conv_after_body.*``,
``conv_before_upsample.0.*``, ``upsample.{2s}.*``, ``conv_last.*``), so a
reference ``.pth`` loads as it is. ``forward`` takes and returns NHWC
``(B, H, W, in_chans)``, like the JAX model; convs run on NCHW views.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

from ..ops import (
    pixel_shuffle,
    reflect_pad_2d,
    relative_position_bias,
    window_partition,
    window_reverse,
)
from ..kernels.window_attention import window_attention
from .layers import Mlp, checkpoint_module, conv_nhwc, reset_torch_default_, trunc_normal_


class WindowAttention(nn.Module):
    """QKV projection, relative-position-bias window attention, proj.
    ``attn_impl``: the :func:`~..kernels.window_attention.window_attention`
    implementation, ``"xla"`` or ``"pallas"``."""

    def __init__(self, dim: int, window_size: int, num_heads: int, attn_impl: str = "xla"):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        bias = relative_position_bias(self.relative_position_bias_table, self.window_size)
        out = window_attention(qkv[0], qkv[1], qkv[2], bias, scale=d**-0.5, impl=self.attn_impl)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class SwinTransformerBlock(nn.Module):
    """W-MSA / SW-MSA block without a shift mask (reference deviation)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, attn_impl: str = "xla"):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, x_size: tuple[int, int]) -> torch.Tensor:
        hgt, wdt = x_size
        b, L, c = x.shape
        ws, ss = self.window_size, self.shift_size
        # reference rule: an input of one window runs unshifted (the padded
        # size is a window multiple, so the window itself never shrinks)
        if min(x_size) <= ws:
            ss = 0

        shortcut = x
        x = self.norm1(x).reshape(b, hgt, wdt, c)
        if ss:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        xw = window_partition(x, ws).reshape(-1, ws * ws, c)
        x = window_reverse(self.attn(xw).reshape(-1, ws, ws, c), ws, hgt, wdt)
        if ss:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = shortcut + x.reshape(b, L, c)
        return x + self.mlp(self.norm2(x))


class SwinIR(nn.Module):
    """x``upscale`` SR generator, NHWC in [0, 1].

    The flagship train config is img_size=128, in_chans=1, embed_dim=180,
    depths=(6,)*6, num_heads=(6,)*6, window_size=8, upscale=4 (mlp_ratio 4).
    Parameters are drawn from ``generator`` (a fresh one seeded 0 if None).
    ``attn_impl`` picks every block's window-attention implementation
    (``"xla"``, or ``"pallas"``: K11, forward-only). ``remat`` runs each
    :class:`SwinTransformerBlock` as a rematerialized region when grad is
    enabled (the JAX ``nn.remat``): the backward keeps the blocks' inputs
    and recomputes their interiors.
    """

    def __init__(
        self,
        *,
        img_size: int = 64,
        in_chans: int = 1,
        embed_dim: int = 96,
        depths: Sequence[int] = (6, 6, 6),
        num_heads: Sequence[int] = (6, 6, 6),
        window_size: int = 7,
        mlp_ratio: float = 4.0,
        upscale: int = 2,
        attn_impl: str = "xla",
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.remat = remat
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.mlp_ratio = mlp_ratio
        self.upscale = upscale

        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.layers = nn.ModuleList(
            nn.ModuleList(
                SwinTransformerBlock(
                    embed_dim, num_heads[i], window_size,
                    0 if j % 2 == 0 else window_size // 2, mlp_ratio, attn_impl,
                )
                for j in range(depth)
            )
            for i, depth in enumerate(depths)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, 64, 3, 1, 1), nn.LeakyReLU(0.01)
        )
        # convs at even indices, PixelShuffle at odd ones: the reference's
        # Sequential layout, so its upsample.{2s}.* keys line up
        if upscale == 3:
            stages = [(9 * 64, 3)]
        else:
            stages = [(4 * 64, 2)] * int(math.log2(upscale))
        self.upsample = nn.Sequential(
            *[m for out, r in stages for m in (nn.Conv2d(64, out, 3, 1, 1), nn.PixelShuffle(r))]
        )
        self.conv_last = nn.Conv2d(64, in_chans, 3, 1, 1)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_torch_default_(self, generator)
        for layer in self.layers:
            for blk in layer:
                trunc_normal_(blk.attn.relative_position_bias_table, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws = self.window_size
        pad_h = (ws - h % ws) % ws
        pad_w = (ws - w % ws) % ws
        x = reflect_pad_2d(x, pad_h, pad_w)
        hp, wp = h + pad_h, w + pad_w

        x_first = conv_nhwc(self.conv_first, x)
        res = x_first.reshape(b, hp * wp, self.embed_dim)
        for layer in self.layers:
            for blk in layer:
                res = (checkpoint_module(blk, res, (hp, wp)) if self.remat
                       else blk(res, (hp, wp)))
        res = self.norm(res).reshape(b, hp, wp, self.embed_dim)
        res = conv_nhwc(self.conv_after_body, res) + x_first

        out = conv_nhwc(self.conv_before_upsample, res)
        for conv, shuffle in zip(self.upsample[::2], self.upsample[1::2]):
            out = pixel_shuffle(conv_nhwc(conv, out), shuffle.upscale_factor)
        out = conv_nhwc(self.conv_last, out)
        return out[:, : h * self.upscale, : w * self.upscale, :]
