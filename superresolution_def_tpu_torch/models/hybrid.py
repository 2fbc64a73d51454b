"""HybridHATRealESRGAN as a PyTorch ``nn.Module`` (the JAX ``models/hybrid.py``).

HAT x2 backbone -> conv_adapt + LeakyReLU(0.2) -> num_rrdb x RRDB ->
conv_body + trunk residual -> nearest x2 + conv_up -> conv_hr -> conv_last:
x4 overall. The convs outside HAT are kaiming-normal (fan_in) with zero
bias, as the reference initialises them. ``state_dict()`` keys are the
reference's (``hat.*``, ``conv_adapt.*``, ``rrdb_trunk.{r}.rdb{b}.conv{c}.*``,
``conv_body.*``, ``conv_up.*``, ``conv_hr.*``, ``conv_last.*``). ``forward``
takes and returns NHWC; the RRDB trunk runs NCHW.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import resize_nearest
from .hat import HAT
from .layers import conv_nhwc


@torch.no_grad()
def kaiming_normal_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """N(0, 2 / fan_in) weights and a zero bias."""
    conv.weight.normal_(0.0, math.sqrt(2.0 / conv.weight[0].numel()), generator=generator)
    conv.bias.zero_()


class ResidualDenseBlock(nn.Module):
    """Five 3x3 convs on the growing concatenation, 0.2 residual scale (NCHW)."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        f, g = num_feat, num_grow_ch
        for i in range(5):
            setattr(self, f"conv{i + 1}", nn.Conv2d(f + i * g, g if i < 4 else f, 3, 1, 1))

    def convs(self) -> list[nn.Conv2d]:
        return [getattr(self, f"conv{i + 1}") for i in range(5)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        srcs = [x]
        for conv in self.convs()[:4]:
            srcs.append(F.leaky_relu(conv(torch.cat(srcs, 1)), 0.2))
        return self.conv5(torch.cat(srcs, 1)) * 0.2 + x


class RRDBBlock(nn.Module):
    """Three dense blocks, 0.2 residual scale (NCHW)."""

    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class HybridHATRealESRGAN(nn.Module):
    """x4 hybrid generator, NHWC in [0, 1]. The served config (BASELINE #2) is
    embed_dim=90, depths=(6,)*4, num_heads=(6,)*4, window_size=8, num_rrdb=12,
    num_feat=48, num_grow_ch=24, in_chans=1, and HAT's drop-path 0.1, which
    acts only in a ``deterministic=False`` forward. Parameters are drawn from
    ``generator`` (a fresh one seeded 0 if None). ``attn_impl``: the HAT
    backbone's window-attention implementation, ``remat``: its RHAGs as
    rematerialized regions (see :class:`~.hat.HAT`; the JAX hybrid remats
    nothing else)."""

    def __init__(self, *, img_size: int = 128, in_chans: int = 1, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6, num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 8, num_rrdb: int = 23, num_feat: int = 64,
                 num_grow_ch: int = 32, drop_path_rate: float = 0.1,
                 attn_impl: str = "xla", remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_rrdb = num_rrdb
        self.hat = HAT(img_size=img_size, in_chans=in_chans, embed_dim=embed_dim, depths=depths,
                       num_heads=num_heads, window_size=window_size, upscale=2, img_range=1.0,
                       drop_path_rate=drop_path_rate, attn_impl=attn_impl, remat=remat,
                       generator=generator)
        self.conv_adapt = nn.Conv2d(in_chans, num_feat, 3, 1, 1)
        self.rrdb_trunk = nn.ModuleList(RRDBBlock(num_feat, num_grow_ch)
                                        for _ in range(num_rrdb))
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, in_chans, 3, 1, 1)
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith("hat."):
                kaiming_normal_(m, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        feat = F.leaky_relu(conv_nhwc(self.conv_adapt, self.hat(x, deterministic, generator)),
                            0.2)
        trunk = feat.permute(0, 3, 1, 2)
        for rrdb in self.rrdb_trunk:
            trunk = rrdb(trunk)
        feat = feat + self.conv_body(trunk).permute(0, 2, 3, 1)
        feat = F.leaky_relu(conv_nhwc(self.conv_up, resize_nearest(feat, 2)), 0.2)
        return conv_nhwc(self.conv_last, F.leaky_relu(conv_nhwc(self.conv_hr, feat), 0.2))
