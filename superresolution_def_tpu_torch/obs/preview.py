"""Preview image artifacts — the reference's 'Tris' strips.

[LR nearest-upscaled | SR | HR] horizontally stacked, 8-bit PNG
(train_swin.py:329-336, train_hat.py:46-54, infer_swin.py:142-149). The
port's copy of the JAX package's ``obs/preview.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def to_u8(img01: np.ndarray) -> np.ndarray:
    """[0,1] float (H, W) or (H, W, 1) -> uint8 (reference tensor_to_img)."""
    arr = np.asarray(img01, dtype=np.float64)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def save_tris_preview(path: str | Path, lr01: np.ndarray, sr01: np.ndarray, hr01: np.ndarray) -> None:
    sr = to_u8(sr01)
    hr = to_u8(hr01)
    h, w = sr.shape
    lr_up = np.array(Image.fromarray(to_u8(lr01)).resize((w, h), resample=Image.NEAREST))
    combined = np.hstack((lr_up, sr, hr))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(combined).save(str(path))
