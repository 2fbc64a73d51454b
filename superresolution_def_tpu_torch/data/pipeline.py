"""Host input pipeline: threaded PIL TIFF decode into uint16 batches.

The JAX ``data/pipeline.py`` for one process: batches in manifest order or
in a seeded per-epoch shuffle (the JAX ``_epoch_order``, so both packages
see the same batch order), decoded on a thread pool and kept a few batches
ahead by a producer thread. A file that fails to decode is replaced by
another sample chosen deterministically from the failing index
(astronomical_dataset_swin.py:53-55). Unless ``drop_last``, the last batch
wraps around to the start when the split does not divide.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from .manifest import ManifestEntry
from .tiff import read_tiff_u16

DECODE_THREADS = 8
PREFETCH_BATCHES = 4


class PatchDataset:
    """Decodes manifest entries to ``{'lr': (h, w, 1), 'hr': (H, W, 1)}`` uint16."""

    def __init__(self, entries: Sequence[ManifestEntry], lr_size: int = 128,
                 hr_size: int = 512):
        self.entries = list(entries)
        self.lr_size = lr_size
        self.hr_size = hr_size

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def _read_one(path: str, size: int) -> np.ndarray:
        arr = read_tiff_u16(path)
        if arr.shape != (size, size):
            raise ValueError(f"{path}: bad shape {arr.shape}, want {(size, size)}")
        return arr

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        tries, cur = 0, idx
        while True:
            e = self.entries[cur]
            try:
                hr = self._read_one(e.hubble_path, self.hr_size)
                lr = self._read_one(e.ground_path, self.lr_size)
                return {"lr": lr[..., None], "hr": hr[..., None]}
            except (OSError, ValueError):
                if tries >= 8:
                    raise
                tries += 1
                cur = int(np.random.default_rng(idx * 1000003 + tries).integers(len(self.entries)))


def _epoch_order(n: int, epoch: int, shuffle: bool, seed: int = 0) -> np.ndarray:
    if shuffle:
        return np.random.default_rng(seed + epoch).permutation(n)
    return np.arange(n)


class DataIterator:
    """Yields ``{'lr': (B, h, w, 1), 'hr': (B, H, W, 1)}`` uint16 batches."""

    def __init__(self, dataset: PatchDataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.ds = dataset
        self.batch = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def epoch(self, epoch: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """One pass over the split; ``epoch`` seeds the shuffle."""
        n = len(self.ds)
        nb = n // self.batch if self.drop_last else -(-n // self.batch)
        if nb == 0:
            return iter(())
        # wrap-around padding, like DistributedSampler
        order = np.resize(_epoch_order(n, epoch, self.shuffle, self.seed), nb * self.batch)
        out_q: queue.Queue = queue.Queue(maxsize=PREFETCH_BATCHES)
        stop = threading.Event()

        def produce():
            # any failure is relayed to the consumer, and a sentinel always
            # follows, so the consumer never blocks on a dead producer
            try:
                with ThreadPoolExecutor(DECODE_THREADS) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            break
                        chunk = order[b * self.batch : (b + 1) * self.batch]
                        items = list(pool.map(self.ds.__getitem__, chunk))
                        out_q.put({k: np.stack([it[k] for it in items]) for k in ("lr", "hr")})
            except BaseException as e:  # noqa: BLE001 — relayed, not swallowed
                out_q.put(e)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        def gen():
            try:
                while (item := out_q.get()) is not None:
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()
                while thread.is_alive():  # drain so the producer can exit
                    try:
                        out_q.get_nowait()
                    except queue.Empty:
                        thread.join(timeout=0.1)

        return gen()
