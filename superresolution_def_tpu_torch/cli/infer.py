"""Evaluate a trained SwinIR or HAT-hybrid run on its test split (the JAX ``cli/infer.py``).

- checkpoint discovery in the JAX package's order for ``.pth`` files, in
  ``checkpoints/`` and the run folder: for SwinIR ``best_gan_model.pth`` ->
  ``latest_checkpoint.pth``, for the hybrid ``best_hybrid_model.pth``; then
  ``hybrid_epoch_*.pth`` in reverse name order (as the JAX package sorts
  them: ``hybrid_epoch_9`` before ``hybrid_epoch_10``), then any ``*.pth``; with
  ``module.``-strip and shape-sniffed hyperparameters. Orbax checkpoints need
  jax and are not read;
- targets from the run-folder name (strip ``_DDP_SwinIR``, split on '_');
- per image: SR -> nan_to_num -> clamp [0, 1] -> ``test_NNNN_sr.tiff``, the
  ``test_NNNN_tris.png`` comparison strip and PSNR/SSIM accumulation, plus
  ``test_metrics.csv`` [ID, PSNR, SSIM] (by default for the hybrid only);
- ``tiled_sr``: overlap-blended tiled SR of a whole frame (``sr upscale``).
"""

from __future__ import annotations

import csv as csv_mod
import pickle
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..data import DataIterator, PatchDataset, load_manifest, write_tiff_u16
from ..device import resolve_device
from ..kernels import make_fused_hybrid, make_fused_swinir
from ..models import (
    HybridHATRealESRGAN,
    SwinIR,
    detect_hybrid_params,
    detect_swinir_params,
    load_torch_state_dict,
)
from ..obs import save_tris_preview
from ..ops.metrics import TrainMetrics, psnr, ssim


ARCHES = ("swin", "hat")


def _torch_candidates(folder: Path, arch: str) -> list[Path]:
    ck = folder / "checkpoints"
    names = ["best_gan_model.pth", "latest_checkpoint.pth"] if arch == "swin" else [
        "best_hybrid_model.pth"]
    out = [p for n in names for p in [ck / n, folder / n] if p.exists()]
    for base in (ck, folder):
        out += sorted(base.glob("hybrid_epoch_*.pth"), reverse=True)
        out += sorted(base.glob("*.pth"))
    return list(dict.fromkeys(out))


def _build(arch: str, sd) -> tuple[torch.nn.Module, dict]:
    if arch == "swin":
        det = detect_swinir_params(sd)
        return SwinIR(
            img_size=128, in_chans=1, embed_dim=det["embed_dim"],
            depths=det["depths"], num_heads=det["num_heads"],
            window_size=8, mlp_ratio=det["mlp_ratio"], upscale=4,
        ), det
    det = detect_hybrid_params(sd)
    return HybridHATRealESRGAN(
        img_size=128, in_chans=1, embed_dim=det["embed_dim"], depths=det["depths"],
        num_heads=det["num_heads"], window_size=det["window_size"], num_rrdb=det["num_rrdb"],
        num_feat=det["num_feat"], num_grow_ch=det["num_grow_ch"],
    ), det


def load_generator(folder: str | Path, device: torch.device | str = "cuda", arch: str = "swin"):
    """Returns ``(model, info)``: the first loadable ``.pth`` of ``folder``
    for ``arch`` ('swin': SwinIR, 'hat': HybridHATRealESRGAN)."""
    if arch not in ARCHES:
        raise ValueError(f"arch must be one of {ARCHES}, got {arch!r}")
    folder = Path(folder)
    for cand in _torch_candidates(folder, arch):
        try:
            sd = load_torch_state_dict(str(cand))
        except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError):
            continue
        model, det = _build(arch, sd)
        # reference checkpoints may carry extra buffers (index tables, masks)
        missing = set(model.state_dict()) - set(sd)
        if missing:
            raise KeyError(f"{cand}: missing {arch} weights {sorted(missing)[:5]}")
        model.load_state_dict(sd, strict=False)
        model = model.to(device).eval()
        return model, {"source": str(cand), "format": "torch", "detected": det}
    raise FileNotFoundError(f"No .pth checkpoint found under {folder}")


def tiled_sr(
    forward: Callable[[torch.Tensor], torch.Tensor],
    img01: np.ndarray,
    *,
    tile: int = 128,
    overlap: int = 16,
    scale: int = 4,
    batch_tiles: int = 8,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """SR an arbitrarily large (H, W) or (H, W, 1) image by overlap-blending
    (the JAX ``tiled_sr`` without its mesh).

    ``forward`` maps NHWC tensors on ``device`` to NHWC: the ``nn.Module``,
    or ``make_fused_swinir(model)`` / ``make_fused_hybrid(model)``. Tiles of
    ``tile`` x ``tile`` with an ``overlap`` halo go through it in batches of
    ``batch_tiles``, the last padded with copies of its last tile so every
    call has one shape; a frame no larger than a tile is reflect-padded to
    one. The tiles are blended on the host in float32 with a linear feather
    that stays strictly positive, so pixels at the frame's border (covered
    by one tile's ramp) keep their full signal.
    """
    device = resolve_device(device)
    x = np.asarray(img01, np.float32)
    if x.ndim == 2:
        x = x[..., None]
    h, w, _ = x.shape

    def run(batch: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return forward(torch.from_numpy(batch).to(device)).float().cpu().numpy()

    if h <= tile and w <= tile:
        pad_h, pad_w = tile - h, tile - w
        xin = np.pad(x, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect") if (pad_h or pad_w) else x
        return run(np.ascontiguousarray(xin[None]))[0][: h * scale, : w * scale]

    stride = tile - 2 * overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} too large for tile {tile}")
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if ys[-1] + tile < h:
        ys.append(h - tile)
    if xs[-1] + tile < w:
        xs.append(w - tile)

    tiles = np.stack([x[y : y + tile, xx : xx + tile] for y in ys for xx in xs])
    outs = []
    for i in range(0, len(tiles), batch_tiles):
        chunk = tiles[i : i + batch_tiles]
        n_real = len(chunk)
        if n_real < batch_tiles:  # pad the batch to keep one shape
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch_tiles - n_real, axis=0)])
        outs.append(run(chunk)[:n_real])
    sr_tiles = np.concatenate(outs)

    ramp = np.ones(tile * scale, np.float32)
    ov = overlap * scale
    if ov:
        rise = (np.arange(ov, dtype=np.float32) + 1.0) / (ov + 1.0)
        ramp[:ov] = rise
        ramp[-ov:] = rise[::-1]
    weight2d = np.outer(ramp, ramp)[..., None]

    acc = np.zeros((h * scale, w * scale, 1), np.float32)
    wacc = np.zeros_like(acc)
    k = 0
    for y in ys:
        for xx in xs:
            ys_, xs_ = y * scale, xx * scale
            acc[ys_ : ys_ + tile * scale, xs_ : xs_ + tile * scale] += sr_tiles[k] * weight2d
            wacc[ys_ : ys_ + tile * scale, xs_ : xs_ + tile * scale] += weight2d
            k += 1
    return acc / np.maximum(wacc, 1e-8)


def targets_from_folder_name(name: str) -> list[str]:
    """'M1_M33_DDP_SwinIR' -> ['M1', 'M33'] (infer_swin.py:108-109)."""
    return name.replace("_DDP_SwinIR", "").split("_")


def run_test(
    folder: str | Path,
    arch: str = "swin",
    *,
    data_root: str = "data",
    lr_size: int = 128,
    hr_size: int = 512,
    limit: int | None = None,
    write_csv: bool | None = None,
    manifest: str | None = None,
    impl: str | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Evaluate a run folder on its targets' test split and write artifacts.

    ``impl='fused'`` runs bf16 through the fused kernels (SwinIR: every Swin
    block through K1; the hybrid: HABs through K5, OCAB tails through K6, the
    RRDB trunk through K7); otherwise the fp32 ``nn.Module`` forward runs. It
    runs on ``device``, the card unless the caller asks for the CPU.
    ``write_csv=None`` writes ``test_metrics.csv`` for the hybrid only, as the
    JAX package does.
    """
    device = resolve_device(device)
    folder = Path(folder)
    model, info = load_generator(folder, device, arch)
    forward = model
    if impl == "fused":
        forward = (make_fused_swinir if arch == "swin" else make_fused_hybrid)(model)
        info["impl"] = "fused"

    if manifest is not None:
        entries = load_manifest(manifest, data_root)
    else:
        entries = []
        for t in targets_from_folder_name(folder.name):
            p = Path(data_root) / t / "8_dataset_split" / "splits_json" / "test.json"
            if p.exists():
                entries.extend(load_manifest(p, data_root))
    if limit:
        entries = entries[:limit]
    if not entries:
        raise FileNotFoundError("no test manifest entries found")

    out_dir = folder / "test_results"
    out_dir.mkdir(parents=True, exist_ok=True)
    if write_csv is None:
        write_csv = arch == "hat"
    csv_rows = []
    metrics = TrainMetrics()

    batches = DataIterator(PatchDataset(entries, lr_size, hr_size), 1).epoch()
    with torch.no_grad():
        for i, batch in enumerate(batches):
            lr01 = torch.from_numpy(batch["lr"].astype("float32")).to(device) / 65535.0
            hr01 = torch.from_numpy(batch["hr"].astype("float32")).to(device) / 65535.0
            sr = torch.nan_to_num(forward(lr01).float()).clamp(0.0, 1.0)
            metrics.update(sr, hr01)
            sr_np = sr.cpu().numpy()
            write_tiff_u16(out_dir / f"test_{i:04d}_sr.tiff", sr_np[0, ..., 0])
            save_tris_preview(
                out_dir / f"test_{i:04d}_tris.png",
                lr01[0].cpu().numpy(), sr_np[0], hr01[0].cpu().numpy(),
            )
            if write_csv:
                pv = float(psnr(sr, hr01)[0])
                sv = float(ssim(sr, hr01.clamp(0, 1)))
                csv_rows.append([i, f"{pv:.4f}", f"{sv:.6f}"])

    if write_csv:
        with open(out_dir / "test_metrics.csv", "w", newline="") as f:
            w = csv_mod.writer(f)
            w.writerow(["ID", "PSNR", "SSIM"])
            w.writerows(csv_rows)

    result = metrics.compute()
    result["num_images"] = metrics.count
    result["checkpoint"] = info
    return result
