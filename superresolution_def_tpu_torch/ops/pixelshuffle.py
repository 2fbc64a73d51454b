"""PixelShuffle in NHWC with torch's (c, i, j) channel order.

``out[b, h*r + i, w*r + j, c] = in[b, h, w, (c*r + i)*r + j]``, the NHWC form
of ``torch.nn.PixelShuffle``, so the preceding conv keeps the reference's
weight layout (mirrors the JAX ``ops/pixelshuffle.py``).
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, upscale: int) -> torch.Tensor:
    """(B, H, W, C*r*r) -> (B, H*r, W*r, C)."""
    b, h, w, crr = x.shape
    r = upscale
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, downscale: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r*r). Inverse of :func:`pixel_shuffle`."""
    b, hr, wr, c = x.shape
    r = downscale
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, h, w, c * r * r)
