"""CSV and TensorBoard logging with the reference's schemas (the JAX ``obs/loggers.py``).

swin metrics.csv: [Epoch, Loss_G, Loss_D, PSNR, SSIM, Time_Sec]
(train_swin.py:190-193,308-310); hat train_log.csv: [Epoch, G_Total, L1,
G_Adv, D_Total, PSNR, SSIM, LR] (train_hat.py:173-176,300-306); the
TensorBoard scalar 'Metrics/PSNR' (train_swin.py:118,305).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Sequence

SWIN_CSV_COLUMNS = ["Epoch", "Loss_G", "Loss_D", "PSNR", "SSIM", "Time_Sec"]
HAT_CSV_COLUMNS = ["Epoch", "G_Total", "L1", "G_Adv", "D_Total", "PSNR", "SSIM", "LR"]


class CSVLogger:
    """Writes the header row at construction, then one row per :meth:`log`.
    With ``resume`` an existing file is kept and appended to (a resumed run
    continues its log under the one header)."""

    def __init__(self, path: str | Path, columns: Sequence[str], resume: bool = False):
        self.path = Path(path)
        self.columns = list(columns)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not resume or not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerow(self.columns)

    def log(self, row: dict) -> None:
        """Appends ``row``'s values in column order ('' for a missing column)."""
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([row.get(c, "") for c in self.columns])


class TensorBoardLogger:
    """TensorBoard scalars through the standard-library event writer
    (:mod:`.tbevents`), as the reference's ``SummaryWriter`` writes them."""

    def __init__(self, log_dir: str | Path):
        from .tbevents import EventFileWriter

        self.writer = EventFileWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.scalar(tag, float(value), step)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
