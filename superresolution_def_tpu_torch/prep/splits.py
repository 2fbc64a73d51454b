"""Split manifests — prepare_data.py behavior.

Scans `7_dataset_ready_LOG` (fallback `7_dataset_ready`) pair dirs, builds
{patch_id, hubble_path, ground_path} entries with resolved absolute paths,
seed-42 shuffles, 80/10/10 splits, writes three indented JSONs to
`8_dataset_split/splits_json/` (prepare_data.py:18-63). A copy of the JAX
``prep/splits.py``.
"""

from __future__ import annotations

from pathlib import Path

from ..data.manifest import ManifestEntry, split_pairs, write_manifest

TRAIN_RATIO = 0.8
VAL_RATIO = 0.1


def collect_pairs(target_dir: str | Path) -> list[ManifestEntry]:
    target_dir = Path(target_dir)
    base = target_dir / "7_dataset_ready_LOG"
    if not base.exists():
        base = target_dir / "7_dataset_ready"
    if not base.exists():
        return []
    entries = []
    for pair_dir in sorted(base.glob("pair_*")):
        h = pair_dir / "hubble.tiff"
        g = pair_dir / "observatory.tiff"
        if h.exists() and g.exists():
            entries.append(
                ManifestEntry(pair_dir.name, str(h.resolve()), str(g.resolve()))
            )
    return entries


def prepare_full_dataset(target_dir: str | Path, seed: int = 42) -> dict:
    """Build and write train/val/test manifests for one target. Returns counts."""
    target_dir = Path(target_dir)
    entries = collect_pairs(target_dir)
    if not entries:
        print(f"[split] {target_dir.name}: no pairs found")
        return {"train": 0, "val": 0, "test": 0}
    splits = split_pairs(entries, TRAIN_RATIO, VAL_RATIO, seed)
    out_dir = target_dir / "8_dataset_split" / "splits_json"
    for name, es in splits.items():
        write_manifest(out_dir / f"{name}.json", es)
    counts = {k: len(v) for k, v in splits.items()}
    print(f"[split] {target_dir.name}: {counts}")
    return counts
