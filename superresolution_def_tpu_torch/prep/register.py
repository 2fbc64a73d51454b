"""Step 1 — plate solve + registration (Dataset_step1_datasetwcs.py).

Per target folder: copy originals, skip already-celestial frames, ASTAP
solve (fast -> blind retry ladder, astap.py), then registration: the first
solved Hubble WCS is the master reference (:267); every frame gets a fresh
TAN target WCS centered on the master CRVAL at its native pixel scale
(:236-240) and is reprojected onto it (reproject.py — a bilinear gather
on ``device`` instead of CPU reproject_interp); written as `reg_*.fits`
float32 with a REG_METH card (:244-248). Sentinel values < -10000 become NaN (:232).
ThreadPoolExecutor(2) concurrency preserved for the solve stage.
"""

from __future__ import annotations

import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from .fits import read_fits, write_fits
from .wcs import TanWCS
from .reproject import reproject_bilinear
from .astap import find_astap_path, solve_with_astap

SENTINEL = -10000.0
SOLVE_WORKERS = 2


def process_step1_folder(
    in_dir: str | Path, out_dir: str | Path, *, astap: str | None = None, log=print
) -> list[Path]:
    """Copy + solve each FITS; returns the list of solved files."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    astap = astap or find_astap_path()
    files = sorted(
        p for ext in ("*.fits", "*.fit", "*.fts") for p in in_dir.glob(ext)
    )

    def solve_one(src: Path) -> Path | None:
        dst = out_dir / f"{src.stem}_solved.fits"
        if not dst.exists():
            shutil.copy2(src, dst)
        try:
            img = read_fits(dst)
        except Exception as e:
            log(f"[step1] unreadable {src.name}: {e}")
            return None
        if TanWCS.has_celestial(img.header):
            return dst  # already solved
        if solve_with_astap(dst, astap, log=log):
            return dst
        return None

    with ThreadPoolExecutor(SOLVE_WORKERS) as pool:
        solved = [p for p in pool.map(solve_one, files) if p is not None]
    log(f"[step1] {in_dir.name}: {len(solved)}/{len(files)} solved")
    return solved


def extract_wcs_info(path: str | Path) -> dict | None:
    try:
        img = read_fits(path)
        if not TanWCS.has_celestial(img.header):
            return None
        w = TanWCS.from_header(img.header)
        return {
            "file": Path(path),
            "wcs": w,
            "shape": img.shape,
            "ra": float(w.crval[0]),
            "dec": float(w.crval[1]),
            "scale": w.pixel_scale_arcsec(),
        }
    except Exception:
        return None


def register_single_image(info: dict, ref_wcs: TanWCS, out_dir: Path, log=print,
                          device: torch.device | str = "cuda") -> dict:
    try:
        img = read_fits(info["file"])
        data = np.nan_to_num(img.data)
        data = np.where(data < SENTINEL, np.nan, data)
        target = TanWCS.registration_target(
            ref_wcs.crval, data.shape, info["scale"] / 3600.0
        )
        out = reproject_bilinear(data, info["wcs"], target, data.shape, device=device)
        hdr = target.to_header()
        hdr["REG_METH"] = "ASTAP_SOLVE+REPROJECT"
        out_name = f"reg_{info['file'].name}"
        write_fits(out_dir / out_name, out.astype(np.float32), hdr)
        return {"status": "ok", "file": out_name}
    except Exception as e:
        log(f"[step1] register failed {info['file'].name}: {e}")
        return {"status": "err", "file": str(info["file"]), "err": str(e)}


def main_registration(
    hubble_solved_dir: str | Path,
    obs_solved_dir: str | Path,
    hubble_out: str | Path,
    obs_out: str | Path,
    log=print,
    device: torch.device | str = "cuda",
) -> dict:
    """Register all solved frames onto the first Hubble WCS's CRVAL; the
    reprojections run on ``device``."""
    device = resolve_device(device)
    hubble_out, obs_out = Path(hubble_out), Path(obs_out)
    hubble_out.mkdir(parents=True, exist_ok=True)
    obs_out.mkdir(parents=True, exist_ok=True)

    h_files = sorted(Path(hubble_solved_dir).glob("*_solved.fits"))
    o_files = sorted(Path(obs_solved_dir).glob("*_solved.fits"))
    h_infos = [x for x in (extract_wcs_info(f) for f in h_files) if x]
    o_infos = [x for x in (extract_wcs_info(f) for f in o_files) if x]
    if not h_infos:
        log("[step1] no solved Hubble frames — cannot register")
        return {"ok": 0, "err": 0}

    ref_wcs = h_infos[0]["wcs"]  # master reference (Dataset_step1:267)
    results = []
    with ThreadPoolExecutor(SOLVE_WORKERS) as pool:
        for infos, out in ((h_infos, hubble_out), (o_infos, obs_out)):
            results += list(pool.map(
                lambda i: register_single_image(i, ref_wcs, out, log, device), infos))
    ok = sum(1 for r in results if r["status"] == "ok")
    log(f"[step1] registered {ok}/{len(results)}")
    return {"ok": ok, "err": len(results) - ok}
