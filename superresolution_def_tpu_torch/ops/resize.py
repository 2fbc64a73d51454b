"""Bilinear interpolation with torch ``interpolate`` semantics, NHWC (the JAX ``ops/resize.py``).

Separable: a dense (out, in) weight matrix per axis, applied as two
products over H then W. The swin discriminator uses it with
``align_corners=True`` only when a skip's size differs from the upsampled one.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear_weights(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out, in) interpolation matrix for 1-D linear resize."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    if align_corners:
        if out_size == 1:
            src = np.zeros(1)
        else:
            src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size) + 0.5) * scale - 0.5
        src = np.clip(src, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C), torch bilinear semantics."""
    out_h, out_w = size
    _, h, w, _ = x.shape
    wh = torch.from_numpy(_linear_weights(out_h, h, align_corners)).to(x.device, x.dtype)
    ww = torch.from_numpy(_linear_weights(out_w, w, align_corners)).to(x.device, x.dtype)
    x = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("ow,bhwc->bhoc", ww, x)
