"""Window geometry for Swin attention, NHWC (mirrors the JAX ``ops/windows.py``)."""

from __future__ import annotations

import numpy as np
import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws, ws, C)."""
    b, h, w, c = x.shape
    ws = window_size
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int, w: int) -> torch.Tensor:
    """(B * H/ws * W/ws, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index_sa(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) int32 index into a ((2*ws-1)**2, heads) bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1).astype(np.int32)


def relative_position_bias(table: torch.Tensor, window_size: int) -> torch.Tensor:
    """Gather a ((2*ws-1)**2, heads) table into the (heads, N, N) bias."""
    n = window_size * window_size
    idx = torch.from_numpy(relative_position_index_sa(window_size)).to(table.device).long()
    return table[idx.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
