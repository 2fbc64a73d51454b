from .manifest import (
    ManifestEntry,
    fix_path,
    load_manifest,
    merge_manifests,
    split_pairs,
    write_manifest,
)
from .tiff import read_tiff_u16, write_tiff_u16
from .pipeline import DataIterator, PatchDataset
from .augment import augment_pair_batch, draw_augment
from .synth import synth_batch_u16, synth_pair

__all__ = [
    "ManifestEntry",
    "fix_path",
    "load_manifest",
    "merge_manifests",
    "split_pairs",
    "write_manifest",
    "read_tiff_u16",
    "write_tiff_u16",
    "DataIterator",
    "PatchDataset",
    "augment_pair_batch",
    "draw_augment",
    "synth_batch_u16",
    "synth_pair",
]
