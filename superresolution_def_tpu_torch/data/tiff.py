"""16-bit grayscale TIFF IO (the JAX ``data/tiff.py``).

:func:`read_tiff_u16` decodes with PIL; :func:`write_tiff_u16` encodes through
the native writer (``fast_tiff``: the uncompressed little-endian single-strip
layout that PIL writes and both decoders read), with PIL for a file the
writer cannot open.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from .fast_tiff import write_u16_native


def read_tiff_u16(path: str | Path) -> np.ndarray:
    """Read a 16-bit grayscale TIFF to (H, W) uint16."""
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.int32:  # PIL decodes I;16 as mode 'I' on some paths
        arr = arr.astype(np.uint16)
    elif arr.dtype != np.uint16:
        arr = np.clip(np.asarray(arr, dtype=np.float64), 0, 65535).astype(np.uint16)
    return arr


def write_tiff_u16(path: str | Path, img01: np.ndarray) -> None:
    """Write a [0, 1] float image as a 16-bit TIFF (uint16 input as it is)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(img01)
    if arr.dtype != np.uint16:
        arr = (np.clip(arr.astype(np.float64), 0.0, 1.0) * 65535.0).astype(np.uint16)
    if not write_u16_native(path, arr):
        Image.fromarray(arr).save(str(path))  # uint16 -> PIL mode 'I;16'
