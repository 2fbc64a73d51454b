"""Window geometry for Swin attention, NHWC (mirrors the JAX ``ops/windows.py``)."""

from __future__ import annotations

import functools

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


def relative_position_index_oca(window_size: int, overlap_ratio: float) -> np.ndarray:
    """(ws*ws, wse*wse) int32 index of the overlapping cross-attention bias.

    Queries sit on the ws x ws grid, keys on the enlarged wse = ws +
    int(overlap_ratio * ws) grid; the table has (ws + wse - 1)**2 rows. The
    reference's shift constant ws - wse + 1 leaves negative indices, which
    torch resolves by wrapping around the table; the modulo makes that
    wraparound explicit (the map is a bijection onto the table's rows).
    """
    ws = window_size
    wse = ws + int(overlap_ratio * ws)
    ori = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    ext = np.stack(np.meshgrid(np.arange(wse), np.arange(wse), indexing="ij")).reshape(2, -1)
    rel = (ext[:, None, :] - ori[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - wse + 1
    rel[:, :, 1] += ws - wse + 1
    rel[:, :, 0] *= ws + wse - 1
    return np.mod(rel.sum(-1), (ws + wse - 1) ** 2).astype(np.int32)


def relative_position_bias_oca(table: torch.Tensor, window_size: int,
                               overlap_ratio: float) -> torch.Tensor:
    """Gather a ((ws+wse-1)**2, heads) table into the (heads, Nq, Nk) bias."""
    idx = relative_position_index_oca(window_size, overlap_ratio)
    nq, nk = idx.shape
    idx = torch.from_numpy(idx).to(table.device).long()
    return table[idx.reshape(-1)].reshape(nq, nk, -1).permute(2, 0, 1)


def shift_window_attn_mask(h: int, w: int, window_size: int, shift_size: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) float32 mask of shifted windows: 0 where query and
    key come from the same region before the roll, -100 elsewhere."""
    ws, ss = window_size, shift_size
    img = np.zeros((h, w), dtype=np.float32)
    cuts = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
    for i, (hs, wsl) in enumerate((a, b) for a in cuts for b in cuts):
        img[hs, wsl] = i
    m = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).astype(np.float32)


@functools.cache
def shift_mask(h: int, w: int, ws: int, ss: int, device: torch.device) -> torch.Tensor:
    """The (nW, ws*ws, ws*ws) fp32 shift mask of an h x w image, on ``device``."""
    return torch.from_numpy(shift_window_attn_mask(h, w, ws, ss)).to(device)


def overlap_windows(kv: torch.Tensor, window_size: int, overlap_window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, owin*owin, C): the overlapping owin x owin
    windows at stride ws, zero-padded at the border (``nn.Unfold`` with
    padding (owin - ws) / 2, as a gather in NHWC)."""
    b, h, w, c = kv.shape
    ws, owin = window_size, overlap_window
    pad = (owin - ws) // 2
    kvp = torch.nn.functional.pad(kv, (0, 0, pad, pad, pad, pad))
    rows = torch.arange(h // ws, device=kv.device)[:, None] * ws + torch.arange(
        owin, device=kv.device)[None, :]
    cols = torch.arange(w // ws, device=kv.device)[:, None] * ws + torch.arange(
        owin, device=kv.device)[None, :]
    p = kvp[:, rows][:, :, :, cols]  # (b, nh, owin, nw, owin, c)
    return p.permute(0, 1, 3, 2, 4, 5).reshape(-1, owin * owin, c)
