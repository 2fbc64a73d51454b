"""Step 4 — two-pass normalization to 16-bit TIFF (Dataset_step4), the JAX
``prep/normalize_pipeline.py`` on ``device``.

Reference behavior: per target, HR and LR streams separately: pass 1 samples
up to 4000 px/img of pixels > 1e-5, log1p-stretches, computes
global_min = P4.0 and global_max = P99.99 (:22-28,51-93); pass 2 applies
log1p -> (x - min)/(max - min + 1e-8) -> clip[0,1] -> uint16 TIFF
(:159-177).

The sampling stays on the host with the same ``np.random.default_rng(seed)``
draws as the JAX package; the percentiles of the sampled pool are a sort on
``device`` (``ops/normalize.py::masked_percentiles``); pass 2 maps each
chunk of same-shape pairs in one batched call.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..data.tiff import write_tiff_u16
from ..device import resolve_device
from ..ops.normalize import log_stretch, log_stretch_normalize, masked_percentiles
from .fits import read_fits

SAMPLES_PER_IMAGE = 4000
MIN_VALID = 1e-5
BLACK_CLIP_PERCENTILE = 4.0
WHITE_CLIP_PERCENTILE = 99.99
USE_LOG_STRETCH = True


def calculate_robust_stats(
    paths: list[Path], *, use_log_stretch: bool = USE_LOG_STRETCH, seed: int = 0, log=print,
    device: torch.device | str = "cuda",
) -> tuple[float, float]:
    """Pass 1: global percentile stats over sampled valid pixels."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    samples = []
    for p in paths:
        try:
            data = np.nan_to_num(read_fits(p).data).ravel()
        except Exception as e:
            log(f"[step4] unreadable {p}: {e}")
            continue
        valid = data[data > MIN_VALID]
        if valid.size == 0:
            continue
        if valid.size > SAMPLES_PER_IMAGE:
            valid = rng.choice(valid, SAMPLES_PER_IMAGE, replace=False)
        samples.append(valid.astype(np.float32))
    if not samples:
        return 0.0, 1.0
    flat = torch.from_numpy(np.concatenate(samples)).to(device)
    v = log_stretch(flat) if use_log_stretch else flat
    lo, hi = masked_percentiles(v, torch.ones_like(v, dtype=torch.bool),
                                (BLACK_CLIP_PERCENTILE, WHITE_CLIP_PERCENTILE))
    lo, hi = float(lo), float(hi)
    log(f"[step4] stats over {flat.numel()} px: min={lo:.5f} max={hi:.5f}")
    return lo, hi


DEBUG_INTERVAL = 50


def normalize_target(
    pairs_dir: str | Path,
    out_dir: str | Path,
    *,
    use_log_stretch: bool = USE_LOG_STRETCH,
    debug_dir: str | Path | None = None,
    debug_interval: int = DEBUG_INTERVAL,
    zip_debug: bool = False,
    log=print,
    device: torch.device | str = "cuda",
) -> int:
    """Pass 1 + pass 2 over every pair; writes 7_dataset_ready_LOG layout.

    ``debug_dir``: write a normalization debug card every ``debug_interval``
    pairs (reference Dataset_step4:179-180; needs matplotlib); ``zip_debug``
    archives the debug dir next to it as debug_checks_clip_<pct>.zip
    (:187-189)."""
    device = resolve_device(device)
    pairs_dir, out_dir = Path(pairs_dir), Path(out_dir)
    pair_dirs = sorted(pairs_dir.glob("pair_*"))
    if not pair_dirs:
        log("[step4] no pairs found")
        return 0

    hr_paths = [d / "hubble.fits" for d in pair_dirs]
    lr_paths = [d / "observatory.fits" for d in pair_dirs]
    # HR and LR streams get separate stats (reference runs per stream)
    hr_lo, hr_hi = calculate_robust_stats(hr_paths, use_log_stretch=use_log_stretch, log=log,
                                          device=device)
    lr_lo, lr_hi = calculate_robust_stats(lr_paths, use_log_stretch=use_log_stretch, log=log,
                                          device=device)

    # pass 2 in chunks: one batched call per (chunk, stream, shape)
    chunk_size = 32
    n = 0
    for c0 in range(0, len(pair_dirs), chunk_size):
        chunk = pair_dirs[c0 : c0 + chunk_size]
        hrs, lrs, good = [], [], []
        for d in chunk:
            try:
                hrs.append(np.nan_to_num(read_fits(d / "hubble.fits").data))
                lrs.append(np.nan_to_num(read_fits(d / "observatory.fits").data))
                good.append(d)
            except Exception as e:
                log(f"[step4] skipping {d.name}: {e}")
        if not good:
            continue
        # bucket by shape: pairs from different extraction runs (or a
        # truncated FITS) may differ in size — each same-shape bucket is
        # one batched call, odd shapes just get their own call
        buckets: dict = {}
        for i, (hr, lr) in enumerate(zip(hrs, lrs)):
            buckets.setdefault((hr.shape, lr.shape), []).append(i)
        hr01b = [None] * len(good)
        lr01b = [None] * len(good)
        for idxs in buckets.values():
            hb = log_stretch_normalize(np.stack([hrs[i] for i in idxs]), hr_lo, hr_hi,
                                       use_log_stretch, device=device).cpu().numpy()
            lb = log_stretch_normalize(np.stack([lrs[i] for i in idxs]), lr_lo, lr_hi,
                                       use_log_stretch, device=device).cpu().numpy()
            for j, i in enumerate(idxs):
                hr01b[i] = hb[j]
                lr01b[i] = lb[j]
        for d, hr, lr, hr01, lr01 in zip(good, hrs, lrs, hr01b, lr01b):
            pd = out_dir / d.name
            pd.mkdir(parents=True, exist_ok=True)
            write_tiff_u16(pd / "hubble.tiff", hr01)
            write_tiff_u16(pd / "observatory.tiff", lr01)
            if debug_dir is not None and n % debug_interval == 0:
                from .diagnostics import save_normalization_debug

                save_normalization_debug(
                    hr, lr,
                    (hr01 * 65535.0).astype(np.uint16),
                    (lr01 * 65535.0).astype(np.uint16),
                    BLACK_CLIP_PERCENTILE,
                    Path(debug_dir) / f"check_{d.name}.png",
                )
            n += 1
    log(f"[step4] normalized {n} pairs -> {out_dir}")
    if zip_debug and debug_dir is not None and Path(debug_dir).exists():
        import shutil

        shutil.make_archive(
            str(Path(debug_dir).parent / f"debug_checks_clip_{BLACK_CLIP_PERCENTILE}"),
            "zip", str(debug_dir),
        )
        log("[step4] debug archive created")
    return n
