"""ASTAP plate-solver subprocess wrapper — Dataset_step1 contract.

ASTAP stays an external native binary boundary (SURVEY.md §2.5). Identical
CLI contract and retry ladder (Dataset_step1:119-177):
  1. fast solve:  astap -f <file> -update -r 30 -z 0
  2. blind retry: astap -f <file> -update -r 180 -z 0 [-fov 0.46 if forced]
with `.wcs`/`.ini` sidecar cleanup, cross-platform binary discovery
(:56-89), and per-file log-and-skip failure handling. Gated: if no binary
is installed the solver reports unavailable instead of crashing.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

ASTAP_CANDIDATES = [
    "/opt/astap/astap",
    "/usr/bin/astap",
    "/usr/local/bin/astap",
    "C:/Program Files/astap/astap.exe",
    "C:/astap/astap.exe",
]

FORCE_FOV = False
FOV_DEG = 0.46


def find_astap_path() -> str | None:
    for cand in ASTAP_CANDIDATES:
        if Path(cand).exists():
            return cand
    return shutil.which("astap")


def solve_with_astap(
    fits_path: str | Path,
    astap: str | None = None,
    *,
    force_fov: bool = FORCE_FOV,
    timeout: int = 300,
    log=print,
) -> bool:
    """Solve in place (-update). Returns True on success."""
    astap = astap or find_astap_path()
    if astap is None:
        log("[astap] binary not found — skipping plate solve")
        return False
    fits_path = Path(fits_path)

    def run(extra: list[str]) -> bool:
        cmd = [astap, "-f", str(fits_path), "-update", *extra, "-z", "0"]
        try:
            res = subprocess.run(
                cmd, capture_output=True, timeout=timeout, text=True
            )
            return res.returncode == 0
        except (subprocess.TimeoutExpired, OSError) as e:
            log(f"[astap] {fits_path.name}: {e}")
            return False

    ok = run(["-r", "30"])
    if not ok:
        extra = ["-r", "180"]
        if force_fov:
            extra += ["-fov", str(FOV_DEG)]
        ok = run(extra)

    for ext in (".wcs", ".ini"):
        side = fits_path.with_suffix(ext)
        if side.exists():
            side.unlink()
    if not ok:
        log(f"[astap] solve failed: {fits_path.name}")
    return ok
