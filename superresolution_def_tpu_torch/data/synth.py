"""Structured synthetic skies for learning runs and tests (the JAX ``data/synth.py``).

Astronomical-style HR/LR pairs with learnable structure: smooth nebulosity
(large-scale correlated background) plus PSF-blurred stars, with LR the
exact 4x4 box mean of HR, a well-posed x4 SR mapping. The same seed gives
the JAX package's arrays, so ``tools/train_learns.py`` trains on the skies of
the TPU learning runs and ``tests/test_torch_learns.py`` on those of the JAX
learning tests.

The generator is scale-invariant: PSF sigma, nebula correlation length and
star density track ``hr_size``, so a 64 px test pair has the structure of
the 512 px pairs (the reference trains on 512 px HR patches,
misc/Dataset_step3_extractpatches.py:29-34).
"""

from __future__ import annotations

import numpy as np


def synth_pair(rng: np.random.Generator, hr_size: int = 512):
    """One structured sky -> (hr, lr) float32 in [0,1]; lr = 4x4 box mean."""
    from scipy.ndimage import gaussian_filter

    # nebula: large-scale correlated background
    neb = gaussian_filter(rng.random((hr_size, hr_size)), hr_size * 48.0 / 512.0)
    neb = (neb - neb.min()) / (np.ptp(neb) + 1e-9) * 0.25
    # stars: sparse bright points, PSF sigma ~1.5 px (HR scale)
    stars = np.zeros((hr_size, hr_size), np.float64)
    density = hr_size * hr_size / (512.0 * 512.0)
    n_stars = rng.integers(max(4, int(80 * density)), max(8, int(160 * density)))
    ys = rng.integers(0, hr_size, n_stars)
    xs = rng.integers(0, hr_size, n_stars)
    amps = rng.pareto(2.0, n_stars) * 0.3 + 0.15
    stars[ys, xs] = np.minimum(amps, 3.0)
    stars = gaussian_filter(stars, 1.5)
    hr = np.clip(neb + stars + rng.normal(0, 0.003, (hr_size, hr_size)), 0, 1)
    lr = hr.reshape(hr_size // 4, 4, hr_size // 4, 4).mean(axis=(1, 3))
    return hr.astype(np.float32), lr.astype(np.float32)


def synth_batch_u16(
    n: int, hr_size: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """n pairs quantized to the training dtype: {'lr','hr'} uint16
    (n, H, W, 1), the wire format of the data pipeline (PIL 'I;16'
    TIFFs /65535 in the step, astronomical_dataset_swin.py:34-35)."""
    rng = np.random.default_rng(seed)
    hrs, lrs = [], []
    for _ in range(n):
        hr, lr = synth_pair(rng, hr_size=hr_size)
        hrs.append(np.round(hr * 65535.0).astype(np.uint16))
        lrs.append(np.round(lr * 65535.0).astype(np.uint16))
    return {
        "hr": np.stack(hrs)[..., None],
        "lr": np.stack(lrs)[..., None],
    }
