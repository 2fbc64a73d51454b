"""JSON split manifests in the reference schema (the JAX ``data/manifest.py``).

A manifest is a JSON list of ``{"patch_id", "hubble_path", "ground_path"}``
with absolute paths, stored as ``8_dataset_split/splits_json/<split>.json``;
``split_pairs`` cuts them 80/10/10 after the reference's seeded shuffle
(prepare_data.py:46-55).
A stored path that no longer exists is re-rooted after its '/data/' marker
under the local base path (astronomical_dataset_swin.py:19-23).
"""

from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    patch_id: str
    hubble_path: str
    ground_path: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def fix_path(path: str, base_path: str | Path | None) -> str:
    """Re-root a stale absolute path on the '/data/' marker (reference rule)."""
    if base_path is None or Path(path).exists():
        return path
    spath = str(path).replace("\\", "/")
    idx = spath.find("/data/")
    if idx < 0:
        return path
    return str(Path(base_path) / spath[idx + len("/data/"):])


def load_manifest(path: str | Path, base_path: str | Path | None = None) -> list[ManifestEntry]:
    with open(path) as f:
        raw = json.load(f)
    return [
        ManifestEntry(
            patch_id=str(e["patch_id"]),
            hubble_path=fix_path(e["hubble_path"], base_path),
            ground_path=fix_path(e["ground_path"], base_path),
        )
        for e in raw
    ]


def write_manifest(path: str | Path, entries: Sequence[ManifestEntry]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump([e.to_json() for e in entries], f, indent=2)


def merge_manifests(paths: Sequence[str | Path], base_path=None) -> list[ManifestEntry]:
    """Concatenate several split files (multi-target training, train_swin.py:123-136)."""
    return [e for p in paths for e in load_manifest(p, base_path)]


def split_pairs(
    entries: Sequence[ManifestEntry],
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    seed: int = 42,
) -> dict[str, list[ManifestEntry]]:
    """Seeded shuffle + 80/10/10 split (reference prepare_data.py:10-11,46-55)."""
    items = list(entries)
    random.Random(seed).shuffle(items)
    n_train = int(len(items) * train_ratio)
    n_val = int(len(items) * val_ratio)
    return {
        "train": items[:n_train],
        "val": items[n_train : n_train + n_val],
        "test": items[n_train + n_val :],
    }
