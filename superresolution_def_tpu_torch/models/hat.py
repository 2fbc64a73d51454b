"""HAT (Hybrid Attention Transformer) generator as PyTorch ``nn.Module``s.

Mirrors the JAX ``models/hat.py``: RHAG groups of HAB blocks (window
attention with a shift mask, plus the channel-attention conv branch CAB
scaled by ``conv_scale``) closed by an OCAB overlapping cross-attention block
and a 3x3 conv, then pixel-shuffle reconstruction. Drop-path (stochastic
depth, rates ``linspace(0, drop_path_rate, sum(depths))`` over the HABs) is
the identity unless ``forward`` is called with ``deterministic=False``; it
then draws each sample's keep from ``generator``. GELU is the exact erf
form, LayerNorm eps 1e-5, as in the flax model.

``state_dict()`` keys are the reference torch keys that the JAX
``torch_port.hat_from_torch`` reads (``conv_first.*``, ``patch_embed.norm.*``,
``layers.{i}.residual_group.blocks.{j}.conv_block.cab.3.attention.1.*``,
``layers.{i}.residual_group.overlap_attn.*``, ``layers.{i}.conv.*``,
``conv_before_upsample.0.*``, ``upsample.{2s}.*``, ``conv_last.*``).
``forward`` takes and returns NHWC; H and W must be window multiples.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops import (
    overlap_windows,
    pixel_shuffle,
    relative_position_bias,
    relative_position_bias_oca,
    shift_mask,
    window_partition,
    window_reverse,
)
from ..kernels.window_attention import window_attention
from .layers import Mlp, checkpoint_module, conv_nhwc, reset_torch_default_, trunc_normal_


# test hook: (block index, call 0/1, x) -> the keep-mask of that call
_DROP_MASKS: Callable | None = None


@contextlib.contextmanager
def injected_drop_masks(masks: Callable):
    """Within the block, every training-mode :class:`DropPath` takes its
    keep-mask from ``masks(block, call, x)`` (``block``: the HAB's index over
    the whole network; ``call``: 0 for the attention branch, 1 for the MLP's)
    instead of drawing it, so a test can feed the JAX draws."""
    global _DROP_MASKS
    _DROP_MASKS = masks
    try:
        yield
    finally:
        _DROP_MASKS = None


class DrawShard(NamedTuple):
    """A generator whose per-sample draws are for the global batch of
    ``world`` ranks: each draw is made for ``world`` times the local batch
    and the rank keeps its own run of rows, so the ranks draw what one
    process draws for the concatenated batch."""

    generator: torch.Generator | None
    rank: int
    world: int


def replay_drop_draws(generator: torch.Generator | DrawShard | None) -> Callable:
    """A ``context_fn`` for :func:`~.layers.checkpoint_module` over blocks
    with drop-path: called at the forward, it notes ``generator``'s state and
    the :func:`injected_drop_masks` hook, and its recompute context puts both
    back, so that the recompute draws the forward's keep-masks, then returns
    the generator to where the recompute found it. ``checkpoint``'s own
    ``preserve_rng_state`` covers the default generators only; ``None``
    draws from those."""
    gen = generator.generator if isinstance(generator, DrawShard) else generator

    def context_fn():
        state = gen.get_state() if gen is not None else None
        hook = _DROP_MASKS

        @contextlib.contextmanager
        def recompute():
            global _DROP_MASKS
            after, outer = (gen.get_state() if gen is not None else None), _DROP_MASKS
            if gen is not None:
                gen.set_state(state)
            _DROP_MASKS = hook
            try:
                yield
            finally:
                if gen is not None:
                    gen.set_state(after)
                _DROP_MASKS = outer

        return contextlib.nullcontext(), recompute()

    return context_fn


class DropPath(nn.Module):
    """Stochastic depth per sample (the JAX ``DropPath``, timm semantics):
    each sample is kept with ``floor(keep + U)``, U uniform in x's dtype, and
    scaled by ``1 / keep``. One module serves both branches of its HAB, two
    independent draws."""

    def __init__(self, rate: float, index: int):
        super().__init__()
        self.rate = rate
        self.index = index

    def keep_mask(self, x: torch.Tensor, generator: torch.Generator | DrawShard | None = None,
                  call: int = 0) -> torch.Tensor:
        """The 0/1 keep of each sample of ``x``, shaped ``(B, 1, ...)``: drawn
        from ``generator`` in x's dtype (one uniform per sample; a
        :class:`DrawShard` draws for the global batch and keeps the rank's
        rows), or taken from :func:`injected_drop_masks`. The fused HAT draws
        through here too, so one generator gives both paths the same masks."""
        if _DROP_MASKS is not None:
            return _DROP_MASKS(self.index, call, x)
        if not isinstance(generator, DrawShard):
            generator = DrawShard(generator, 0, 1)
        b = x.shape[0]
        u = torch.rand((b * generator.world,) + (1,) * (x.ndim - 1),
                       generator=generator.generator, dtype=x.dtype, device=x.device)
        return torch.floor(1.0 - self.rate + u[generator.rank * b:(generator.rank + 1) * b])

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None, call: int = 0) -> torch.Tensor:
        if self.rate == 0.0 or deterministic:
            return x
        return x / (1.0 - self.rate) * self.keep_mask(x, generator, call)


class ChannelAttention(nn.Module):
    """Squeeze-excite channel attention (the reference's ``attention`` Sequential)."""

    def __init__(self, num_feat: int, squeeze_factor: int):
        super().__init__()
        mid = max(1, num_feat // squeeze_factor)
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(num_feat, mid, 1), nn.ReLU(),
            nn.Conv2d(mid, num_feat, 1), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        return x * self.attention(x)


class CAB(nn.Module):
    """Conv attention branch: 3x3 compress -> GELU -> 3x3 expand -> CA."""

    def __init__(self, num_feat: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        mid = max(1, num_feat // compress_ratio)
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, mid, 3, 1, 1), nn.GELU(), nn.Conv2d(mid, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC
        return conv_nhwc(self.cab, x)


class WindowAttentionRPI(nn.Module):
    """Window MHSA with a relative-position bias and an optional shift mask."""

    def __init__(self, dim: int, window_size: int, num_heads: int, attn_impl: str = "xla"):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(bw, n, 3, h, d).permute(2, 0, 3, 1, 4)
        bias = relative_position_bias(self.relative_position_bias_table, self.window_size)
        out = window_attention(qkv[0], qkv[1], qkv[2], bias, mask, scale=d**-0.5,
                               impl=self.attn_impl)
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class HAB(nn.Module):
    """Hybrid attention block: (S)W-MSA + conv_scale * CAB, then the MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 compress_ratio: int, squeeze_factor: int, conv_scale: float, mlp_ratio: float,
                 drop_path: float = 0.0, index: int = 0, attn_impl: str = "xla"):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.attn = WindowAttentionRPI(dim, window_size, num_heads, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path, index)

    def forward(self, x: torch.Tensor, x_size: tuple[int, int], deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        hgt, wdt = x_size
        b, L, c = x.shape
        ws, ss = self.window_size, self.shift_size
        if min(x_size) <= ws:  # the reference's rule: one window runs unshifted
            ss = 0
        shortcut = x
        x = self.norm1(x).reshape(b, hgt, wdt, c)
        conv_x = self.conv_block(x).reshape(b, L, c)
        mask = None
        if ss:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            mask = shift_mask(hgt, wdt, ws, ss, x.device)
        attn = self.attn(window_partition(x, ws).reshape(-1, ws * ws, c), mask)
        x = window_reverse(attn.reshape(-1, ws, ws, c), ws, hgt, wdt)
        if ss:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = (shortcut + self.drop_path(x.reshape(b, L, c), deterministic, generator, 0)
             + conv_x * self.conv_scale)
        return x + self.drop_path(self.mlp(self.norm2(x)), deterministic, generator, 1)


class OCAB(nn.Module):
    """Overlapping cross-attention block: queries on ws x ws windows, keys and
    values on the owin x owin overlapping windows around them."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float, num_heads: int,
                 mlp_ratio: float, attn_impl: str = "xla"):
        super().__init__()
        self.window_size = window_size
        self.overlap_ratio = overlap_ratio
        self.attn_impl = attn_impl
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window_size + self.overlap_win_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, x_size: tuple[int, int]) -> torch.Tensor:
        hgt, wdt = x_size
        b, L, c = x.shape
        ws, heads = self.window_size, self.num_heads
        d = c // heads
        qkv = self.qkv(self.norm1(x)).reshape(b, hgt, wdt, 3 * c)
        q = window_partition(qkv[..., :c], ws).reshape(-1, ws * ws, c)
        kv = overlap_windows(qkv[..., c:], ws, self.overlap_win_size)
        bw, nq, _ = q.shape
        nk = kv.shape[1]
        qh = q.reshape(bw, nq, heads, d).transpose(1, 2)
        kh = kv[..., :c].reshape(bw, nk, heads, d).transpose(1, 2)
        vh = kv[..., c:].reshape(bw, nk, heads, d).transpose(1, 2)
        bias = relative_position_bias_oca(self.relative_position_bias_table, ws,
                                          self.overlap_ratio)
        out = window_attention(qh, kh, vh, bias, scale=d**-0.5, impl=self.attn_impl)
        out = out.transpose(1, 2).reshape(-1, ws, ws, c)
        x = self.proj(window_reverse(out, ws, hgt, wdt).reshape(b, L, c)) + x
        return x + self.mlp(self.norm2(x))


class ResidualGroup(nn.Module):
    """The HAB blocks and the closing OCAB of one RHAG (the reference's
    ``residual_group``)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 compress_ratio: int, squeeze_factor: int, conv_scale: float,
                 overlap_ratio: float, mlp_ratio: float, drop_paths: Sequence[float] = (),
                 first_index: int = 0, attn_impl: str = "xla"):
        super().__init__()
        drop_paths = tuple(drop_paths) or (0.0,) * depth
        self.blocks = nn.ModuleList(
            HAB(dim, num_heads, window_size, 0 if j % 2 == 0 else window_size // 2,
                compress_ratio, squeeze_factor, conv_scale, mlp_ratio, drop_paths[j],
                first_index + j, attn_impl)
            for j in range(depth)
        )
        self.overlap_attn = OCAB(dim, window_size, overlap_ratio, num_heads, mlp_ratio,
                                 attn_impl)

    def forward(self, x: torch.Tensor, x_size: tuple[int, int], deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, x_size, deterministic, generator)
        return self.overlap_attn(x, x_size)


class RHAG(nn.Module):
    """Residual hybrid attention group: residual group, 3x3 conv, residual."""

    def __init__(self, dim: int, **kw):
        super().__init__()
        self.residual_group = ResidualGroup(dim, **kw)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor, x_size: tuple[int, int], deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, L, c = x.shape
        res = self.residual_group(x, x_size, deterministic, generator).reshape(b, *x_size, c)
        return conv_nhwc(self.conv, res).reshape(b, L, c) + x


class PatchEmbedNorm(nn.Module):
    """Holds the reference's ``patch_embed.norm`` LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)


class HAT(nn.Module):
    """Hybrid Attention Transformer, NHWC in [0, 1].

    The hybrid's backbone is img_size=128, in_chans=1, embed_dim=90,
    depths=(6,)*4, num_heads=(6,)*4, window_size=8, upscale=2 (pixelshuffle),
    mlp_ratio 4, drop-path 0.1. Parameters are drawn from ``generator`` (a
    fresh one seeded 0 if None): convs and linears as torch's default init,
    the bias tables trunc-normal(0.02). ``attn_impl`` picks every HAB's and
    OCAB's window-attention implementation (``"xla"``, or ``"pallas"``: K11,
    forward-only). ``remat`` runs each :class:`RHAG` as a rematerialized
    region when grad is enabled (the JAX ``nn.remat``), its recompute taking
    the forward's drop-path masks (:func:`replay_drop_draws`).
    """

    def __init__(self, *, img_size: int = 64, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6), num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, compress_ratio: int = 3, squeeze_factor: int = 30,
                 conv_scale: float = 0.01, overlap_ratio: float = 0.5, mlp_ratio: float = 4.0,
                 patch_norm: bool = True, upscale: int = 2, img_range: float = 1.0,
                 num_feat: int = 64, drop_path_rate: float = 0.1,
                 attn_impl: str = "xla", remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.remat = remat
        self.img_size = img_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.depths = tuple(depths)
        self.num_heads = tuple(num_heads)
        self.window_size = window_size
        self.overlap_ratio = overlap_ratio
        self.conv_scale = conv_scale
        self.upscale = upscale
        self.img_range = img_range
        self.conv_first = nn.Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbedNorm(embed_dim) if patch_norm else None
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        starts = [sum(depths[:i]) for i in range(len(depths))]
        self.layers = nn.ModuleList(
            RHAG(embed_dim, depth=depth, num_heads=num_heads[i], window_size=window_size,
                 compress_ratio=compress_ratio, squeeze_factor=squeeze_factor,
                 conv_scale=conv_scale, overlap_ratio=overlap_ratio, mlp_ratio=mlp_ratio,
                 drop_paths=dpr[starts[i]:starts[i] + depth], first_index=starts[i],
                 attn_impl=attn_impl)
            for i, depth in enumerate(depths)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.conv_after_body = nn.Conv2d(embed_dim, embed_dim, 3, 1, 1)
        self.conv_before_upsample = nn.Sequential(
            nn.Conv2d(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(0.01))
        stages = [(9 * num_feat, 3)] if upscale == 3 else [(4 * num_feat, 2)] * int(
            math.log2(upscale))
        self.upsample = nn.Sequential(*[
            m for out, r in stages for m in (nn.Conv2d(num_feat, out, 3, 1, 1), nn.PixelShuffle(r))
        ])
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        reset_torch_default_(self, generator)
        for m in self.modules():
            if isinstance(m, (WindowAttentionRPI, OCAB)):
                trunc_normal_(m.relative_position_bias_table, generator)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's mean shift: the RGB means for 3 channels, else zero."""
        if self.in_chans == 3:
            return torch.tensor([0.4488, 0.4371, 0.4040], dtype=x.dtype, device=x.device)
        return torch.zeros(self.in_chans, dtype=x.dtype, device=x.device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        mean = self.mean(x)
        x = (x - mean) * self.img_range
        feat = conv_nhwc(self.conv_first, x)
        res = feat.reshape(b, h * w, self.embed_dim)
        if self.patch_embed is not None:
            res = self.patch_embed.norm(res)
        for layer in self.layers:
            if self.remat:
                res = checkpoint_module(layer, res, (h, w), deterministic, generator,
                                        context_fn=replay_drop_draws(generator))
            else:
                res = layer(res, (h, w), deterministic, generator)
        res = self.norm(res).reshape(b, h, w, self.embed_dim)
        feat = conv_nhwc(self.conv_after_body, res) + feat
        out = conv_nhwc(self.conv_before_upsample, feat)
        for conv, shuffle in zip(self.upsample[::2], self.upsample[1::2]):
            out = pixel_shuffle(conv_nhwc(conv, out), shuffle.upscale_factor)
        out = conv_nhwc(self.conv_last, out)
        return out / self.img_range + mean
