"""WCS reprojection — the `reproject_interp` equivalent as a gather on device tensors.

The reference calls reproject_interp per frame/patch on the CPU
(Dataset_step1:242, Dataset_step3:247-252). As in the JAX
``prep/reproject.py``, the coordinate transform (target grid -> world ->
source pixels) is numpy (cheap, exact, float64, stored as float32 grids) and
the bilinear resampling is one gather over every grid at once, here on
``device``. Out-of-footprint samples become NaN like reproject's footprint
behavior (or 0 with ``fill_nan=False``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .wcs import TanWCS


def bilinear_gather(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    fill: float = float("nan")) -> torch.Tensor:
    """Sample ``src`` (H, W) at float pixel coords ``px``, ``py`` (any equal
    shapes); ``fill`` outside the footprint. The JAX ``_bilinear_sample``'s
    corner order, weights, clipped corner indices and 1e-3 footprint margin."""
    h, w = src.shape
    flat = src.reshape(-1)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def at(yy, xx):
        return flat.take(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))

    out = (
        at(y0i, x0i) * (1 - fy) * (1 - fx)
        + at(y0i, x0i + 1) * (1 - fy) * fx
        + at(y0i + 1, x0i) * fy * (1 - fx)
        + at(y0i + 1, x0i + 1) * fy * fx
    )
    eps = 1e-3  # float32 grid rounding must not knock edge pixels outside
    inside = (px >= -eps) & (px <= w - 1 + eps) & (py >= -eps) & (py <= h - 1 + eps)
    return torch.where(inside, out, torch.tensor(fill, dtype=out.dtype, device=out.device))


def source_pixel_grid(src_wcs: TanWCS, dst_wcs: TanWCS, shape_out) -> tuple[np.ndarray, np.ndarray]:
    """For each dst pixel center, the float source pixel coords (numpy f64 -> f32)."""
    hh, ww = shape_out
    yy, xx = np.mgrid[0:hh, 0:ww]
    ra, dec = dst_wcs.pixel_to_world(xx, yy)
    px, py = src_wcs.world_to_pixel(ra, dec)
    return px.astype(np.float32), py.astype(np.float32)


def _sample(data, pxs, pys, fill_nan: bool, device: torch.device) -> np.ndarray:
    src = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(device)
    out = bilinear_gather(src, torch.from_numpy(pxs).to(device), torch.from_numpy(pys).to(device),
                          float("nan") if fill_nan else 0.0)
    return out.cpu().numpy()


def reproject_bilinear(
    data: np.ndarray,
    src_wcs: TanWCS,
    dst_wcs: TanWCS,
    shape_out,
    fill_nan: bool = True,
    *,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """reproject_interp(order='bilinear') equivalent for one frame."""
    device = resolve_device(device)
    px, py = source_pixel_grid(src_wcs, dst_wcs, shape_out)
    return _sample(data, px, py, fill_nan, device)


def reproject_batch(
    data: np.ndarray,
    src_wcs: TanWCS,
    dst_wcs_list: list[TanWCS],
    shape_out,
    fill_nan: bool = True,
    *,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Reproject ONE source frame onto MANY target WCS grids in one gather —
    the patch-extraction inner loop (Dataset_step3:247-252) batched over the
    whole patch grid instead of per-patch CPU calls."""
    device = resolve_device(device)
    grids = [source_pixel_grid(src_wcs, d, shape_out) for d in dst_wcs_list]
    pxs = np.stack([g[0] for g in grids])
    pys = np.stack([g[1] for g in grids])
    return _sample(data, pxs, pys, fill_nan, device)
