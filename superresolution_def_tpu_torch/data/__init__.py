from .manifest import ManifestEntry, fix_path, load_manifest, write_manifest
from .tiff import read_tiff_u16, write_tiff_u16
from .pipeline import DataIterator, PatchDataset
from .augment import augment_pair_batch, draw_augment

__all__ = [
    "ManifestEntry",
    "fix_path",
    "load_manifest",
    "write_manifest",
    "read_tiff_u16",
    "write_tiff_u16",
    "DataIterator",
    "PatchDataset",
    "augment_pair_batch",
    "draw_augment",
]
