"""Reflect padding of NHWC images (mirrors the JAX ``ops/padding.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_2d(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Pad bottom by ``pad_h`` and right by ``pad_w`` with reflection.

    ``F.pad(x, (0, pad_w, 0, pad_h), mode='reflect')`` on the NCHW view, the
    rounding up to a window multiple of the reference SwinIR.
    """
    if pad_h == 0 and pad_w == 0:
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    return y.permute(0, 2, 3, 1)
