"""Step 2 — mosaic quality-check figure (Dataset_step2_mosaicHSTObs.py).

Pure diagnostic, no training data: stack up to 10 observatory frames by
nan-median as a master canvas (:53-66), reproject every Hubble tile onto
the observatory WCS and max-composite (:78-105), ZScale-like percentile
normalization (:107-112), 3-panel matplotlib figure incl. an RGB overlay
(G=Hubble, R/B=Obs) to `<target>_mosaic_check.png` (:137-172). The
reprojections run on ``device``; matplotlib is imported only to draw.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .fits import read_fits
from .wcs import TanWCS
from .reproject import reproject_bilinear

MAX_OBS_FRAMES = 10


def normalize_zscale(img: np.ndarray) -> np.ndarray:
    """Percentile stretch standing in for astropy ZScaleInterval."""
    finite = img[np.isfinite(img)]
    if finite.size == 0:
        return np.zeros_like(img)
    lo, hi = np.percentile(finite, [1.0, 99.0])
    return np.clip((img - lo) / (hi - lo + 1e-9), 0, 1)


def load_observatory_master(obs_dir: str | Path):
    files = sorted(Path(obs_dir).glob("reg_*.fits"))[:MAX_OBS_FRAMES]
    if not files:
        return None, None
    stack, wcs = [], None
    for f in files:
        img = read_fits(f)
        stack.append(img.data)
        if wcs is None:
            wcs = TanWCS.from_header(img.header)
    return np.nanmedian(np.stack(stack), axis=0), wcs


def create_hubble_mosaic(hubble_dir: str | Path, obs_wcs: TanWCS, shape,
                         device: torch.device | str = "cuda") -> np.ndarray:
    mosaic = np.full(shape, np.nan, np.float32)
    for f in sorted(Path(hubble_dir).glob("reg_*.fits")):
        img = read_fits(f)
        w = TanWCS.from_header(img.header)
        re = reproject_bilinear(np.nan_to_num(img.data), w, obs_wcs, shape, device=device)
        mosaic = np.fmax(mosaic, re)
    return mosaic


def mosaic_check(
    hubble_dir: str | Path,
    obs_dir: str | Path,
    out_png: str | Path,
    *,
    target_name: str = "",
    log=print,
    device: torch.device | str = "cuda",
) -> bool:
    device = resolve_device(device)
    master, obs_wcs = load_observatory_master(obs_dir)
    if master is None:
        log("[step2] no observatory frames")
        return False
    mosaic = create_hubble_mosaic(hubble_dir, obs_wcs, master.shape, device)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    obs_n = normalize_zscale(np.nan_to_num(master))
    hub_n = normalize_zscale(np.nan_to_num(mosaic))
    rgb = np.stack([obs_n, hub_n, obs_n], axis=-1)

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(obs_n, cmap="gray", origin="lower")
    axes[0].set_title(f"{target_name} Observatory (median stack)")
    axes[1].imshow(hub_n, cmap="gray", origin="lower")
    axes[1].set_title("Hubble mosaic (max composite)")
    axes[2].imshow(rgb, origin="lower")
    axes[2].set_title("Overlay (G=Hubble, R/B=Obs)")
    for ax in axes:
        ax.axis("off")
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_png, dpi=110, bbox_inches="tight")
    plt.close(fig)
    log(f"[step2] wrote {out_png}")
    return True
