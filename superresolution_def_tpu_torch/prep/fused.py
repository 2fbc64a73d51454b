"""Fused dataset prep — BASELINE config #5's hot path (the JAX ``prep/fused.py``).

The reference runs steps 3+4 as per-patch CPU loops: one `reproject_interp`
per patch (Dataset_step3_extractpatches.py:247-252) and a two-pass
DataLoader-sampled normalization (Dataset_step4_normalization.py:51-93,
151-183). Here the LR pipeline runs on ``device`` with the data resident
there throughout:

    phase 1, per observatory frame:
      upload the source frame and its candidates' sampling grids once
      -> bilinear reprojection of every candidate patch (one gather)
      -> coverage keep (Dataset_step3:255-257 semantics)
      (patches STAY on the device)
    phase 2, once per target:
      concatenate every frame's patches
      -> per-TARGET percentiles over the kept patches' valid pixels
         (log-stretched, > MIN_VALID, multiset over all kept pairs —
          the same population the staged normalize_target reads from
          6_patches_final)
      -> log1p -> affine normalize -> clip -> truncating 16-bit quantize
    download the quantized LR patches (+ the raw f32 patches only when
    FITS pairs are requested).

Every device pass is enqueued before the first download, and nothing in
phase 1 waits for the device: on the card the frames' raw patches and keeps
come back on a side stream while phase 2 runs. The HR stream never needs the
device — its patches are slices of a frame already in host memory — so it
runs as vectorized numpy: per-target stats over the reference's
4000-px-per-file sample (``_hr_host_stats``), quantized in the writer pool
beside the TIFF IO. FITS pairs (6_patches_final layout) and uint16 TIFFs
(7_dataset_ready_LOG layout) are written exactly like the staged path.

Documented deviation from the staged path (as in the JAX package): the LR
stream's percentile stats are exact, over ALL valid pixels of the kept
patches, instead of the reference's 4000-px-per-image subsample.
"""

from __future__ import annotations

import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data.tiff import write_tiff_u16
from ..device import resolve_device
from ..ops.normalize import (
    log_stretch,
    log_stretch_normalize,
    masked_percentiles,
    quantize_u16,
)
from .fits import read_fits, write_fits
from .normalize_pipeline import (
    BLACK_CLIP_PERCENTILE,
    MIN_VALID,
    SAMPLES_PER_IMAGE,
    WHITE_CLIP_PERCENTILE,
)
from .patches import (
    AI_LR_SIZE,
    HR_SIZE,
    MIN_COVERAGE,
    MIN_PIXEL_VALUE,
    calculate_stride_for_target,
)
from .reproject import bilinear_gather, source_pixel_grid
from .wcs import TanWCS


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    if device.type == "cuda":  # from pinned memory the copy does not wait
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _lr_reproject_program(src, pxs, pys):
    """(N, h, w) reprojection + coverage keep; patches stay on the device."""
    patches = bilinear_gather(src, pxs, pys, 0.0)  # reproject-NaN -> nan_to_num fused
    n_px = patches.shape[1] * patches.shape[2]
    keep = (patches > MIN_PIXEL_VALUE).sum(dim=(1, 2)) >= n_px * MIN_COVERAGE
    return patches, keep


def _lr_normalize_program(stack, keep):
    """Per-TARGET stats + quantization over ALL frames' kept patches.

    ``stack``: (M, h, w) every frame's reprojected patches concatenated;
    ``keep``: (M,) the per-frame coverage masks. Stats run over the kept
    patches' valid pixels only — one (lo, hi) per target, matching the staged
    `normalize_target`. The codes are int32 in [0, 65535]: truncation, as
    the reference's `(v*65535).astype(uint16)`."""
    v = log_stretch(stack)
    mask = (stack > MIN_VALID) & keep[:, None, None]
    lo, hi = masked_percentiles(v, mask, (BLACK_CLIP_PERCENTILE, WHITE_CLIP_PERCENTILE))
    return quantize_u16(log_stretch_normalize(v, lo, hi, use_log_stretch=False)), lo, hi


class _Downloads:
    """Device -> host copies of each frame's phase-1 results.

    On the card each frame's copy waits only for that frame's phase 1 (an
    event recorded after it) and runs on a side stream into pinned memory,
    beside phase 2; on the CPU the tensors are the host arrays already."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.items = []

    def mark(self) -> torch.cuda.Event | None:
        """An event after everything enqueued so far (one frame's phase 1)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def start(self, ready, tensors) -> None:
        if not self.cuda:
            self.items.append((tensors, None))
            return
        self.stream.wait_event(ready)
        with torch.cuda.stream(self.stream):
            host = []
            for t in tensors:
                t.record_stream(self.stream)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            done = torch.cuda.Event()
            done.record()
        self.items.append((host, done))

    def get(self, i: int) -> list[np.ndarray]:
        host, done = self.items[i]
        if done is not None:
            done.synchronize()
        return [h.numpy() for h in host]


def _hr_host_stats(hr_v, hr_valid, counts, *, seed: int = 0):
    """Per-target HR percentile stats over the kept-pair multiset.

    Reference-true sampling (Dataset_step4_normalization.py:51-67, same
    as the staged ``calculate_robust_stats``): each written hubble.fits
    copy contributes at most SAMPLES_PER_IMAGE randomly chosen valid
    pixels to the percentile pool — ``counts[c]`` copies of candidate
    ``c`` draw independently, like step 4 reading one file per kept
    (frame, patch) pair."""
    rng = np.random.default_rng(seed)
    chunks = []
    for c, k in enumerate(counts):
        if k <= 0:
            continue
        valid = hr_v[c][hr_valid[c]]
        for _ in range(int(k)):
            if valid.size > SAMPLES_PER_IMAGE:
                chunks.append(rng.choice(valid, SAMPLES_PER_IMAGE, replace=False))
            else:
                chunks.append(valid)
    pool = np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
    if pool.size:
        lo, hi = np.percentile(
            pool, (BLACK_CLIP_PERCENTILE, WHITE_CLIP_PERCENTILE)
        )
    else:
        lo, hi = 0.0, 1.0
    return float(lo), float(hi)


def _quantize_hr(hr_v_c, lo: float, hi: float) -> np.ndarray:
    """One candidate's stretched HR slice -> u16 (runs in the writer pool;
    numpy ufuncs drop the GIL so this overlaps the file IO)."""
    v01 = np.clip((hr_v_c - lo) / (hi - lo + 1e-8), 0.0, 1.0)
    return (v01 * 65535.0).astype(np.uint16)


class _WriterPool:
    """Async file-writer pool overlapping host IO with device compute.

    File writes release the GIL in the write syscall and PIL/FITS encode
    paths, so a small thread pool lets the pair writes proceed while the
    main thread waits on device downloads. ``drain()`` re-raises the first
    failure so IO errors are not silently swallowed.
    """

    def __init__(self, workers: int = 4):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futs = []

    def submit(self, fn, *a) -> None:
        self._futs.append(self._pool.submit(fn, *a))

    def drain(self) -> None:
        for f in self._futs:
            f.result()
        self._futs.clear()
        self._pool.shutdown()


def _write_pair_fits(pd: Path, hr, lr, hdr_h, hdr_l) -> None:
    # f32 casts run here, in the pool thread, not on the dispatch thread
    pd.mkdir(exist_ok=True)
    write_fits(pd / "hubble.fits", np.asarray(hr, np.float32), hdr_h)
    write_fits(pd / "observatory.fits", np.asarray(lr, np.float32), hdr_l)


def _write_pair_tiff(rd: Path, hr_u16, lr_u16) -> None:
    rd.mkdir(exist_ok=True)
    write_tiff_u16(rd / "hubble.tiff", hr_u16)
    write_tiff_u16(rd / "observatory.tiff", lr_u16)


def _quantize_write_pair_tiff(rd: Path, hr_v_c, lo, hi, lr_code) -> None:
    _write_pair_tiff(rd, _quantize_hr(hr_v_c, lo, hi), lr_code.astype(np.uint16))


def fused_prep_target(
    hubble_reg_dir: str | Path,
    obs_reg_dir: str | Path,
    pairs_dir: str | Path,
    ready_dir: str | Path,
    *,
    target_name: str = "",
    desired_count: int | None = None,
    stride: int | None = None,
    hr_size: int = HR_SIZE,
    lr_size: int = AI_LR_SIZE,
    write_fits_pairs: bool = True,
    log=print,
    device: torch.device | str = "cuda",
    stats: dict | None = None,
) -> int:
    """Steps 3+4 fused: registered frames -> FITS pairs + uint16 TIFF pairs.

    Returns the number of pairs written. Produces the same on-disk layouts
    as `extract_patches` + `normalize_target` (6_patches_final pair dirs
    when ``write_fits_pairs`` and the 7_dataset_ready_LOG TIFF dirs). The LR
    stream runs on ``device``. ``stats``, when given, receives the target's
    ``hr`` and ``lr`` (lo, hi) and the logged phase times in seconds
    (``phases``).
    """
    device = resolve_device(device)
    pairs_dir, ready_dir = Path(pairs_dir), Path(ready_dir)
    pairs_dir.mkdir(parents=True, exist_ok=True)
    ready_dir.mkdir(parents=True, exist_ok=True)
    h_files = sorted(Path(hubble_reg_dir).glob("reg_*.fits"))
    o_files = sorted(Path(obs_reg_dir).glob("reg_*.fits"))
    if not h_files or not o_files:
        log("[fused-prep] missing registered frames")
        return 0
    if stride is None:
        stride = calculate_stride_for_target(target_name, desired_count)

    h_img = read_fits(h_files[0])
    d_h = np.nan_to_num(h_img.data)
    w_h = TanWCS.from_header(h_img.header)
    h_center = w_h.crval

    # candidate grid, HR-coverage-filtered on host (slices of resident data)
    hh, ww = d_h.shape
    candidates, cand_wcs = [], []
    for y in range(0, hh - hr_size + 1, stride):
        for x in range(0, ww - hr_size + 1, stride):
            patch = d_h[y : y + hr_size, x : x + hr_size]
            if np.count_nonzero(patch > MIN_PIXEL_VALUE) < patch.size * MIN_COVERAGE:
                continue
            pw = w_h.slice(y, x)
            candidates.append((y, x))
            cand_wcs.append((pw, pw.scaled_lr(hr_size / lr_size)))
    if not candidates:
        log("[fused-prep] no candidates above coverage")
        return 0
    log(f"[fused-prep] stride={stride}: {len(candidates)} candidates")

    t0 = time.perf_counter()

    # HR host work is frame-invariant — do it ONCE, overlapping the device
    # passes below (stats need the per-frame keeps, quantization waits)
    hr_stack = np.stack(
        [d_h[y : y + hr_size, x : x + hr_size] for y, x in candidates]
    )
    hr_v = np.log1p(np.maximum(hr_stack, 0.0))
    hr_valid = hr_stack > MIN_VALID
    t_hr = time.perf_counter()

    # Phase 1 — one reprojection per frame; patches stay on the device.
    # Nothing here waits for the device: while it reprojects frame i, the
    # host builds frame i+1's sampling grids.
    downloads = _Downloads(device)
    frames = []  # (o_file, dev_patches, dev_keep, phase-1 event)
    for o_file in o_files:
        try:
            o_img = read_fits(o_file)
            w_o = TanWCS.from_header(o_img.header)
        except Exception as e:
            log(f"[fused-prep] unreadable {o_file.name}: {e}")
            continue
        dist = math.sqrt(
            (w_o.crval[0] - h_center[0]) ** 2 + (w_o.crval[1] - h_center[1]) ** 2
        )
        if dist >= 0.1:  # reference distance filter (Dataset_step3:401-409)
            continue
        d_o = np.nan_to_num(o_img.data)
        grids = [
            source_pixel_grid(w_o, lrw, (lr_size, lr_size))
            for _, lrw in cand_wcs
        ]
        pxs = np.stack([g[0] for g in grids])
        pys = np.stack([g[1] for g in grids])
        patches, keep = _lr_reproject_program(
            _upload(d_o, device), _upload(pxs, device), _upload(pys, device)
        )
        frames.append((o_file, patches, keep, downloads.mark()))
    if not frames:
        log("[fused-prep] no observatory frames within 0.1 deg")
        return 0

    # Phase 2 — ONE per-target stats+quantize pass over the device-resident
    # concatenation of every frame's patches (staged parity: normalize_target
    # computes one (lo,hi) per target/stream), enqueued BEFORE any download.
    lr_code_dev, lr_lo_dev, lr_hi_dev = _lr_normalize_program(
        torch.cat([p for _, p, _, _ in frames]),
        torch.cat([k for _, _, k, _ in frames]),
    )
    # raw LR f32 patches leave the device only if FITS pairs are wanted
    for _, patches, keep, ready in frames:
        downloads.start(ready, [keep, patches] if write_fits_pairs else [keep])
    t_p1 = time.perf_counter()

    # While the device runs phase 2: take each frame's keeps and raw LR
    # patches, assign pair names, and start the FITS writes on the writer
    # pool (they depend only on phase-1 results).
    pool = _WriterPool()
    idx = 0
    keeps = []
    pair_names: list[list[str | None]] = []  # [frame][candidate] -> name
    for fi, (o_file, _, _, _) in enumerate(frames):
        keep, *raw = downloads.get(fi)
        lr_raw = raw[0] if write_fits_pairs else None
        keeps.append(keep)
        log(f"[fused-prep] {o_file.name}: keep {int(keep.sum())}")
        names: list[str | None] = []
        for ci, ((y, x), (pw, lrw)) in enumerate(zip(candidates, cand_wcs)):
            if not keep[ci]:
                names.append(None)
                continue
            name = f"pair_{idx:06d}"
            names.append(name)
            if write_fits_pairs:
                pool.submit(
                    _write_pair_fits, pairs_dir / name,
                    hr_stack[ci], lr_raw[ci],
                    pw.to_header(), lrw.to_header(),
                )
            idx += 1
        pair_names.append(names)
    counts = np.sum(keeps, axis=0)
    hr_lo, hr_hi = _hr_host_stats(hr_v, hr_valid, counts)
    t_fits = time.perf_counter()

    # Quantized LR download (waits until phase 2 lands), then the TIFF
    # writes stream through the same pool — each task quantizes its HR
    # slice in the pool thread right before writing.
    lr_code_all = lr_code_dev.cpu().numpy()
    lr_lo, lr_hi = float(lr_lo_dev), float(lr_hi_dev)
    log(
        f"[fused-prep] target stats over {len(frames)} frame(s): "
        f"hr[{hr_lo:.5f},{hr_hi:.5f}] lr[{lr_lo:.5f},{lr_hi:.5f}]"
    )
    t_p2 = time.perf_counter()

    n_cand = len(candidates)
    for fi in range(len(frames)):
        lr_code = lr_code_all[fi * n_cand : (fi + 1) * n_cand]
        for ci, name in enumerate(pair_names[fi]):
            if name is None:
                continue
            pool.submit(
                _quantize_write_pair_tiff, ready_dir / name,
                hr_v[ci], hr_lo, hr_hi, lr_code[ci],
            )
    pool.drain()
    t_end = time.perf_counter()
    phases = {"total": t_end - t0, "hr-host": t_hr - t0, "dispatches": t_p1 - t_hr,
              "fits-enqueue+hr-stats": t_fits - t_p1, "lr-download": t_p2 - t_fits,
              "tiff-quant+drain": t_end - t_p2}
    log(
        f"[fused-prep] wrote {idx} pairs in {phases['total']:.2f}s "
        f"(hr-host {phases['hr-host']:.2f}s, dispatches {phases['dispatches']:.2f}s, "
        f"fits-enqueue+hr-stats {phases['fits-enqueue+hr-stats']:.2f}s, "
        f"lr-download {phases['lr-download']:.2f}s, "
        f"tiff-quant+drain {phases['tiff-quant+drain']:.2f}s)"
    )
    if stats is not None:
        stats.update(hr=(hr_lo, hr_hi), lr=(lr_lo, lr_hi), phases=phases)
    return idx
