"""CSV logging with the reference's column schema (the JAX ``obs/loggers.py``).

swin metrics.csv: [Epoch, Loss_G, Loss_D, PSNR, SSIM, Time_Sec]
(train_swin.py:190-193,308-310); hat train_log.csv: [Epoch, G_Total, L1,
G_Adv, D_Total, PSNR, SSIM, LR] (train_hat.py:173-176,300-306).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Sequence

SWIN_CSV_COLUMNS = ["Epoch", "Loss_G", "Loss_D", "PSNR", "SSIM", "Time_Sec"]
HAT_CSV_COLUMNS = ["Epoch", "G_Total", "L1", "G_Adv", "D_Total", "PSNR", "SSIM", "LR"]


class CSVLogger:
    """Writes the header row at construction, then one row per :meth:`log`."""

    def __init__(self, path: str | Path, columns: Sequence[str]):
        self.path = Path(path)
        self.columns = list(columns)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerow(self.columns)

    def log(self, row: dict) -> None:
        """Appends ``row``'s values in column order ('' for a missing column)."""
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(c, "") for c in self.columns])
