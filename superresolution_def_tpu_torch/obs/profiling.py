"""Profiling and throughput (the JAX ``obs/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of the CPU and, where
there is one, the card (a Chrome trace TensorBoard's profile plugin and
``chrome://tracing`` read); :class:`ThroughputMeter` turns step timings
into patches/s and patches/s per card, the rate divided by the world size.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block and write ``<log_dir>/trace.json`` when it ends."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class ThroughputMeter:
    """Patches/s over the intervals between :meth:`tick` calls; the first
    tick only starts the clock. ``world_size`` defaults to the process
    group's size (1 without a group)."""

    def __init__(self, world_size: int | None = None):
        if world_size is None:
            from ..parallel import process_count

            world_size = process_count()
        self.world_size = world_size
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self.patches = 0
        self.seconds = 0.0

    def tick(self, batch_patches: int) -> None:
        now = time.perf_counter()
        if self._t0 is not None:
            self.seconds += now - self._t0
            self.patches += batch_patches
        self._t0 = now

    @property
    def patches_per_sec(self) -> float:
        return self.patches / self.seconds if self.seconds else 0.0

    @property
    def patches_per_sec_per_chip(self) -> float:
        return self.patches_per_sec / max(self.world_size, 1)
