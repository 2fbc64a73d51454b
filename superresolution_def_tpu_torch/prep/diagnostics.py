"""Per-patch diagnostic cards — step 3's visual QC (Dataset_step3:73-160).

The reference renders a 6-panel matplotlib card for the first DEBUG_SAMPLES
pairs: HR patch, LR patch, 4x-nearest LR, side-by-side stretch views, and a
quantitative WCS alignment check — the RA/DEC of the HR patch center vs the
LR patch center, with a PERFECT/MISMATCH verdict at a 1.0 arcsec threshold
(:121-130). Reproduced here against our TanWCS.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .wcs import TanWCS, angular_separation_deg

MISMATCH_THRESHOLD_ARCSEC = 1.0


def alignment_check(
    hr_wcs: TanWCS, lr_wcs: TanWCS, hr_size: int, lr_size: int
) -> dict:
    """Angular offset between HR and LR patch centers, arcsec + verdict."""
    ra_h, dec_h = hr_wcs.center_world((hr_size, hr_size))
    ra_l, dec_l = lr_wcs.center_world((lr_size, lr_size))
    sep_arcsec = angular_separation_deg(ra_h, dec_h, ra_l, dec_l) * 3600.0
    return {
        "hr_center": (ra_h, dec_h),
        "lr_center": (ra_l, dec_l),
        "sep_arcsec": sep_arcsec,
        "verdict": "PERFECT" if sep_arcsec < MISMATCH_THRESHOLD_ARCSEC else "MISMATCH",
    }


def _stretch(img: np.ndarray) -> np.ndarray:
    v = np.nan_to_num(np.asarray(img, np.float64))
    lo, hi = np.percentile(v, [1, 99])
    return np.clip((v - lo) / (hi - lo + 1e-9), 0, 1)


def save_diagnostic_card(
    out_png: str | Path,
    hr_patch: np.ndarray,
    lr_patch: np.ndarray,
    hr_wcs: TanWCS,
    lr_wcs: TanWCS,
    pair_name: str = "",
) -> dict:
    """Render the 6-panel card; returns the alignment-check dict."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hr_size = hr_patch.shape[0]
    lr_size = lr_patch.shape[0]
    chk = alignment_check(hr_wcs, lr_wcs, hr_size, lr_size)

    lr_up = np.repeat(np.repeat(lr_patch, hr_size // lr_size, 0), hr_size // lr_size, 1)
    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    panels = [
        (hr_patch, f"{pair_name} HR (Hubble) {hr_size}px"),
        (lr_patch, f"LR (Observatory) {lr_size}px"),
        (lr_up, "LR nearest-upscaled"),
        (_stretch(hr_patch), "HR stretched"),
        (_stretch(lr_patch), "LR stretched"),
        (np.abs(_stretch(hr_patch) - _stretch(lr_up)), "abs diff (stretched)"),
    ]
    for ax, (img, title) in zip(axes.ravel(), panels):
        ax.imshow(np.nan_to_num(img), cmap="gray", origin="lower")
        ax.set_title(title, fontsize=10)
        ax.axis("off")
    fig.suptitle(
        f"WCS alignment: {chk['sep_arcsec']:.3f}\" -> {chk['verdict']}"
        f"  (threshold {MISMATCH_THRESHOLD_ARCSEC}\")",
        fontsize=13,
        color="green" if chk["verdict"] == "PERFECT" else "red",
    )
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_png, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return chk


def save_normalization_debug(
    hr_raw: np.ndarray,
    lr_raw: np.ndarray,
    hr_norm_u16: np.ndarray,
    lr_norm_u16: np.ndarray,
    clip_percentile: float,
    out_png: str | Path,
) -> None:
    """Step-4 normalization debug card (Dataset_step4:96-116): raw frames
    log-stretched on top, the u16 AI inputs below, black background."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 10), facecolor="#000000")
    axes[0, 0].imshow(np.log1p(np.maximum(np.nan_to_num(hr_raw), 1e-5)), cmap="inferno")
    axes[0, 0].set_title("Hubble RAW (Log)", color="white")
    axes[0, 1].imshow(np.log1p(np.maximum(np.nan_to_num(lr_raw), 1e-5)), cmap="viridis")
    axes[0, 1].set_title("Obs RAW (Log)", color="white")
    axes[1, 0].imshow(hr_norm_u16, cmap="gray", vmin=0, vmax=65535)
    axes[1, 0].set_title(f"Hubble AI Input (Clip {clip_percentile}%)", color="white")
    axes[1, 1].imshow(lr_norm_u16, cmap="gray", vmin=0, vmax=65535)
    axes[1, 1].set_title(f"Obs AI Input (Clip {clip_percentile}%)", color="white")
    for ax in axes.flat:
        ax.axis("off")
    plt.tight_layout()
    Path(out_png).parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_png, facecolor="#000000")
    plt.close(fig)
