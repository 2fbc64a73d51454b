"""Step 3 — aligned patch-pair extraction (Dataset_step3_extractpatches.py).

The JAX ``prep/patches.py`` on the port's ``reproject_batch``. Behavior parity:
- constants HR_SIZE=512, AI_LR_SIZE=128, REF_STRIDE=40, MIN_COVERAGE=0.50,
  MIN_PIXEL_VALUE=1e-4, DEBUG_SAMPLES=50 (:29-34);
- adaptive stride from historical REF_YIELDS via
  stride = 40*sqrt(ref_yield/desired), clamped >= 10 (:37-44,164-197);
- grid-slide over the FIRST registered Hubble frame; per (y, x): coverage
  filter on the HR patch (:232), WCS slice, aligned LR WCS (CD x4,
  CRPIX / 4, :213-221);
- observatory frames distance-filtered < 0.1 deg from the Hubble CRVAL
  (flat |d(crval)| like the reference, :401-404);
- per obs frame, reproject onto every candidate LR grid, coverage-filter,
  write `pair_NNNNNN/{hubble,observatory}.fits` float32 with WCS headers.

Instead of a process pool reprojecting one 128x128 patch per task, the
candidate LR grids of one observatory frame go through one batched gather
on ``device`` (``batch_patches`` grids at a time). Pair indices are
assigned sequentially in one process, so no cross-process counter race can
overwrite pair dirs.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .fits import read_fits, write_fits
from .wcs import TanWCS
from .reproject import reproject_batch

HR_SIZE = 512
AI_LR_SIZE = 128
REF_STRIDE = 40
MIN_COVERAGE = 0.50
MIN_PIXEL_VALUE = 1e-4
DEBUG_SAMPLES = 50

REF_YIELDS = {
    "M1": 850,
    "M82": 1400,
    "M8": 180,
    "M33": 490,
    "M42": 1200,
    "NGC": 1200,
}


def calculate_stride_for_target(folder_name: str, desired_count: int | None) -> int:
    """Adaptive stride from historical yields (Dataset_step3:164-197)."""
    if not desired_count:
        return REF_STRIDE
    folder_upper = folder_name.upper()
    for key in sorted(REF_YIELDS, key=len, reverse=True):
        if key in folder_upper:
            stride = int(REF_STRIDE * math.sqrt(REF_YIELDS[key] / desired_count))
            return max(stride, 10)
    return REF_STRIDE


def _coverage(patch: np.ndarray) -> float:
    return float(np.count_nonzero(patch > MIN_PIXEL_VALUE)) / patch.size


def extract_patches(
    hubble_reg_dir: str | Path,
    obs_reg_dir: str | Path,
    out_dir: str | Path,
    *,
    target_name: str = "",
    desired_count: int | None = None,
    stride: int | None = None,
    hr_size: int = HR_SIZE,
    lr_size: int = AI_LR_SIZE,
    batch_patches: int = 64,
    debug_dir: str | Path | None = None,
    debug_samples: int = DEBUG_SAMPLES,
    zip_outputs: bool = False,
    log=print,
    device: torch.device | str = "cuda",
) -> int:
    """Extract aligned pairs; returns the number of pairs written. The
    reprojection runs on ``device``."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    h_files = sorted(Path(hubble_reg_dir).glob("reg_*.fits"))
    o_files_all = sorted(Path(obs_reg_dir).glob("reg_*.fits"))
    if not h_files:
        log("[step3] no registered Hubble frames")
        return 0
    if stride is None:
        stride = calculate_stride_for_target(target_name, desired_count)

    h_img = read_fits(h_files[0])
    d_h = np.nan_to_num(h_img.data)
    w_h = TanWCS.from_header(h_img.header)
    h_center = w_h.crval

    # distance filter: flat |delta crval| < 0.1 deg (reference :401-404)
    o_good = []
    for f in o_files_all:
        try:
            img = read_fits(f)
            w = TanWCS.from_header(img.header)
            dist = math.sqrt(
                (w.crval[0] - h_center[0]) ** 2 + (w.crval[1] - h_center[1]) ** 2
            )
            if dist < 0.1:
                o_good.append((np.nan_to_num(img.data), w, f.name))
        except Exception:
            pass
    if not o_good:
        log("[step3] no observatory frames near the Hubble field")
        return 0

    hh, ww = d_h.shape
    candidates = []  # (y, x, hr_patch, lr_wcs)
    for y in range(0, hh - hr_size + 1, stride):
        for x in range(0, ww - hr_size + 1, stride):
            patch_h = d_h[y : y + hr_size, x : x + hr_size]
            if _coverage(patch_h) < MIN_COVERAGE:
                continue
            patch_wcs = w_h.slice(y, x)
            lr_wcs = patch_wcs.scaled_lr(hr_size / lr_size)
            candidates.append((y, x, patch_h, patch_wcs, lr_wcs))
    log(f"[step3] stride={stride}: {len(candidates)} candidate grid positions")

    idx = 0
    for data_o, wcs_o, oname in o_good:
        for c0 in range(0, len(candidates), batch_patches):
            chunk = candidates[c0 : c0 + batch_patches]
            lr_batch = reproject_batch(
                data_o,
                wcs_o,
                [c[4] for c in chunk],
                (lr_size, lr_size),
                fill_nan=True,
                device=device,
            )
            lr_batch = np.nan_to_num(lr_batch)
            for (y, x, patch_h, patch_wcs, lr_wcs), patch_o in zip(chunk, lr_batch):
                if np.sum(patch_o > MIN_PIXEL_VALUE) < lr_size * lr_size * MIN_COVERAGE:
                    continue
                pair_dir = out_dir / f"pair_{idx:06d}"
                pair_dir.mkdir(exist_ok=True)
                write_fits(
                    pair_dir / "hubble.fits",
                    patch_h.astype(np.float32),
                    patch_wcs.to_header(),
                )
                write_fits(
                    pair_dir / "observatory.fits",
                    patch_o.astype(np.float32),
                    lr_wcs.to_header(),
                )
                if debug_dir is not None and idx < debug_samples:
                    from .diagnostics import save_diagnostic_card

                    save_diagnostic_card(
                        Path(debug_dir) / f"pair_{idx:06d}_card.png",
                        patch_h, patch_o, patch_wcs, lr_wcs,
                        pair_name=f"pair_{idx:06d}",
                    )
                idx += 1
    log(f"[step3] wrote {idx} pairs")
    if zip_outputs and idx:
        # reference archives the FITS pairs and debug cards into the
        # target dir (Dataset_step3:431-435)
        import shutil

        name = target_name or out_dir.parent.name
        shutil.make_archive(str(out_dir.parent / f"{name}_patches"), "zip", str(out_dir))
        if debug_dir is not None and Path(debug_dir).exists():
            shutil.make_archive(
                str(out_dir.parent / f"{name}_debug_visuals"), "zip", str(debug_dir)
            )
        log("[step3] archives created")
    return idx
