"""Timestamped prep log files — step 1's logging discipline for all steps.

The reference logs step 1 to a timestamped file AND the console
(Dataset_step1:44-54: `pipeline_smart_FIXED_FOV_<ts>.log`, format
'%(asctime)s - %(message)s'). Every prep function here takes a plain
``log`` callable, so this module just manufactures one that tees each
line (with a timestamp) to a file and stdout.
"""

from __future__ import annotations

import datetime
from pathlib import Path
from typing import Callable


def make_prep_logger(
    log_dir: str | Path, prefix: str = "prep"
) -> tuple[Callable[[str], None], Path]:
    """Returns (log_fn, log_path). log_fn(msg) appends a timestamped line
    to ``<log_dir>/<prefix>_<YYYYmmdd_HHMMSS>.log`` and prints it."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    log_path = log_dir / f"{prefix}_{ts}.log"

    def log(msg: str = "") -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} - {msg}"
        with log_path.open("a", encoding="utf-8") as f:
            f.write(line + "\n")
        print(line)

    return log, log_path
