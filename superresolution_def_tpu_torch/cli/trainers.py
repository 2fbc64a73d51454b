"""GAN training loops of SwinIR and the HAT-Real hybrid (the JAX ``cli/trainers.py``).

:func:`train_swin_run` (train_swin.py:88-341): outputs/<targets>_DDP_SwinIR/{checkpoints,
images}; merged multi-target manifests; cosine LR per epoch (eta_min 1e-7);
per epoch the steps, then EMA-copy validation (PSNR/SSIM), a CSV row
[Epoch, Loss_G, Loss_D, PSNR, SSIM, Time_Sec], an [LR|SR|HR] preview,
``best_gan_model.pth`` (``{'net_g': EMA state dict}``, the reference layout
the port's ``infer`` reads) when the validation PSNR improves, and
``latest_checkpoint.pth`` with G, D (with its spectral buffers), both
optimizers, the EMA copy, the epoch and the best PSNR.

:func:`train_hat_run` (train_hat.py:88-330): outputs/<targets>/{checkpoints,
previews}; L1-only warmup epochs, then the GAN; cosine LR per epoch; per
epoch the steps' mean losses and live train PSNR/SSIM, every
``csv_interval`` epochs a ``train_log.csv`` row, every ``ckpt_interval``
``hybrid_epoch_{N}.pth`` (both networks, both optimizers, the EMA copy) and
``best_hybrid_model.pth`` / ``best_hybrid_model_EMA.pth`` (G's and the EMA
copy's weights, written unconditionally as the reference does), every
``img_interval`` a preview of the last batch.

Both resume by default, as the JAX trainers do: swin from
``checkpoints/latest_checkpoint.pth``, hat from the ``hybrid_epoch_N.pth``
of the largest N; G, D (with its spectral-norm vectors), both optimizers,
the EMA copy (and for swin the best PSNR) are restored, the loop starts at
the epoch after the saved one, and the CSV log is appended to.
``resume=False`` (``train --no-resume``) starts over and rewrites the log.
The noise and drop-path generators restart from the seed on resume.

One process on one device. Not ported yet: TensorBoard, host-to-device
prefetch overlap, multi-GPU.
"""

from __future__ import annotations

import dataclasses
import re
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..data import DataIterator, PatchDataset, load_manifest
from ..models import load_torch_state_dict, vgg19_state_dict_from_jax
from ..obs import HAT_CSV_COLUMNS, SWIN_CSV_COLUMNS, CSVLogger, save_tris_preview
from ..train import (
    HAT_METRICS,
    CombinedGANLoss,
    VGG19Features,
    cosine_annealing_lr,
    create_hat_train_state,
    create_swin_train_state,
    make_eval_step,
    make_hat_train_step,
    make_swin_train_step,
)
from .infer import resolve_device


@dataclasses.dataclass
class SwinTrainConfig:
    targets: Sequence[str] = ("M1",)
    data_root: str = "data"
    outputs_root: str = "outputs"
    epochs: int = 300
    # the JAX default split, micro 8 x accum 1 (the mean gradient over 8
    # patches for any split); the reference envelope is micro 2 x accum 4
    batch_size: int = 8
    accum_steps: int = 1
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    ema_decay: float = 0.999
    img_size: int = 128
    upscale: int = 4
    embed_dim: int = 180
    depths: tuple = (6,) * 6
    num_heads: tuple = (6,) * 6
    window_size: int = 8
    mlp_ratio: float = 4.0
    use_bf16: bool = False
    vgg_weights: str | None = None  # npz of the JAX package's VGG params; None -> seeded
    seed: int = 0
    max_steps_per_epoch: int | None = None
    device: str = "cuda"

    @property
    def run_name(self) -> str:
        return "_".join(self.targets) + "_DDP_SwinIR"


@dataclasses.dataclass
class HATTrainConfig:
    targets: Sequence[str] = ("M1",)
    data_root: str = "data"
    outputs_root: str = "outputs"
    epochs: int = 300
    warmup_epochs: int = 30
    # the JAX default split, micro 2 x accum 8 (the mean gradient over 16
    # patches for any split); the reference envelope is micro 1 x accum 16
    batch_size: int = 2
    accum_steps: int = 8
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    ema_decay: float = 0.999
    ckpt_interval: int = 5
    img_interval: int = 10
    csv_interval: int = 10
    img_size: int = 128
    embed_dim: int = 90
    depths: tuple = (6, 6, 6, 6)
    num_heads: tuple = (6, 6, 6, 6)
    window_size: int = 8
    num_rrdb: int = 12
    num_feat: int = 48
    num_grow_ch: int = 24
    use_bf16: bool = False
    vgg_weights: str | None = None  # npz of the JAX package's VGG params; None -> seeded
    pretrained_hat: str | None = None  # a HAT-only .pth to seed the backbone
    fused_hab: bool = False  # the backbone's HABs and OCABs through K9/K10 too
    seed: int = 0
    max_steps_per_epoch: int | None = None
    device: str = "cuda"

    @property
    def run_name(self) -> str:
        return "_".join(self.targets)


def _split_entries(cfg, split: str) -> list:
    return [e for t in cfg.targets for e in load_manifest(
        Path(cfg.data_root) / t / "8_dataset_split" / "splits_json" / f"{split}.json",
        cfg.data_root)]


def _load_vgg(cfg, dtype: torch.dtype, device) -> VGG19Features:
    """VGG19[:36] for the perceptual loss: the JAX package's npz when given
    (read with numpy), else seeded weights."""
    model = VGG19Features(cutoff=35, dtype=dtype, generator=torch.Generator().manual_seed(0))
    if cfg.vgg_weights:
        loaded = np.load(cfg.vgg_weights, allow_pickle=True)
        params = loaded["params"].item() if "params" in loaded else dict(loaded)
        model.load_state_dict(vgg19_state_dict_from_jax(params))
    return model.to(device).requires_grad_(False).eval()


def _restore(state, path: Path, device) -> dict:
    """Loads G, D, both optimizers and the EMA copy of ``state`` from the
    checkpoint at ``path``; returns the checkpoint. ``load_state_dict``
    copies into the parameters in place, which moves their versions, so the
    kernels' cached packed weights are remade from the loaded values."""
    ck = torch.load(path, map_location=device, weights_only=False)
    state.g.load_state_dict(ck["net_g"])
    state.d.load_state_dict(ck["net_d"])
    state.g_opt.load_state_dict(ck["optimizer_g"])
    state.d_opt.load_state_dict(ck["optimizer_d"])
    state.ema.load_state_dict(ck["ema"])
    return ck


def latest_epoch_checkpoint(ckpt_dir: Path) -> Path | None:
    """The ``hybrid_epoch_N.pth`` of the largest N (compared as integers), or None."""
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob("hybrid_epoch_*.pth")
             if (m := re.fullmatch(r"hybrid_epoch_(\d+)\.pth", p.name))]
    return max(found)[1] if found else None


def train_swin_run(cfg: SwinTrainConfig, resume: bool = True) -> dict:
    """Full SwinIR-GAN training. Returns the last epoch's metrics."""
    device = resolve_device(cfg.device)
    run_dir = Path(cfg.outputs_root) / cfg.run_name
    (run_dir / "images").mkdir(parents=True, exist_ok=True)
    (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    hr_size = cfg.img_size * cfg.upscale
    train_ds = PatchDataset(_split_entries(cfg, "train"), cfg.img_size, hr_size)
    val_ds = PatchDataset(_split_entries(cfg, "val"), cfg.img_size, hr_size)
    per_step = cfg.batch_size * cfg.accum_steps
    if len(train_ds) < per_step:
        raise ValueError(f"train split has {len(train_ds)} pairs < one optimizer step "
                         f"({cfg.batch_size} x {cfg.accum_steps} accum = {per_step})")
    it = DataIterator(train_ds, per_step, shuffle=True, drop_last=True, seed=cfg.seed)
    val_it = DataIterator(val_ds, 1)

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    # the fused kernels take bf16 on the card; the CPU runs the module path
    fused = device.type == "cuda" and cfg.use_bf16
    state = create_swin_train_state(
        torch.Generator().manual_seed(cfg.seed), img_size=cfg.img_size, upscale=cfg.upscale,
        embed_dim=cfg.embed_dim, depths=cfg.depths, num_heads=cfg.num_heads,
        window_size=cfg.window_size, mlp_ratio=cfg.mlp_ratio, dtype=dtype, fused=fused,
        device=device)
    criterion_g = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                  adversarial_weight=0.005,
                                  vgg_apply=_load_vgg(cfg, dtype, device))
    step = make_swin_train_step(state, accum_steps=cfg.accum_steps, criterion_g=criterion_g,
                                ema_decay=cfg.ema_decay,
                                generator=torch.Generator().manual_seed(cfg.seed + 1))
    eval_step = make_eval_step(state.ema_forward)
    start_epoch, best_psnr = 1, 0.0
    latest = run_dir / "checkpoints" / "latest_checkpoint.pth"
    if resume and latest.exists():
        ck = _restore(state, latest, device)
        start_epoch, best_psnr = ck["epoch"] + 1, ck["best_psnr"]
        print(f"Resumed from epoch {start_epoch}")
    csv_log = CSVLogger(run_dir / "metrics.csv", SWIN_CSV_COLUMNS, resume=start_epoch > 1)

    last = {}
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.time()
        lr_g = cosine_annealing_lr(epoch, cfg.lr_g, cfg.epochs)
        lr_d = cosine_annealing_lr(epoch, cfg.lr_d, cfg.epochs)
        g_sum = d_sum = valid = 0.0
        for bi, b in enumerate(it.epoch(epoch)):
            if cfg.max_steps_per_epoch and bi >= cfg.max_steps_per_epoch:
                break
            b = {k: v.reshape(cfg.accum_steps, cfg.batch_size, *v.shape[1:])
                 for k, v in b.items()}
            m = step(b, lr_g, lr_d)
            g_sum += m["loss_g"] * m["valid_batches"]
            d_sum += m["loss_d"] * m["valid_batches"]
            valid += m["valid_batches"]
        avg_g, avg_d = g_sum / max(valid, 1.0), d_sum / max(valid, 1.0)

        # EMA-copy validation (train_swin.py:277-300)
        psnr_sum = ssim_sum = count = 0.0
        preview = None
        for vi, vb in enumerate(val_it.epoch(0)):
            if cfg.max_steps_per_epoch and vi >= cfg.max_steps_per_epoch:
                break
            out = eval_step(vb, device)
            psnr_sum += out["psnr_sum"]
            ssim_sum += out["ssim_sum"]
            count += out["count"]
            preview = (vb, out["sr"][0].cpu().numpy())
        val_psnr, val_ssim = psnr_sum / max(count, 1.0), ssim_sum / max(count, 1.0)

        dt = time.time() - t0
        last = {"epoch": epoch, "loss_g": avg_g, "loss_d": avg_d, "psnr": val_psnr,
                "ssim": val_ssim, "time_sec": dt}
        print(f"Ep {epoch}: G={avg_g:.4f} D={avg_d:.4f} PSNR={val_psnr:.2f} "
              f"SSIM={val_ssim:.4f} ({dt:.1f}s)", flush=True)
        csv_log.log({"Epoch": epoch, "Loss_G": avg_g, "Loss_D": avg_d, "PSNR": val_psnr,
                     "SSIM": val_ssim, "Time_Sec": round(dt, 1)})
        if val_psnr > best_psnr:
            best_psnr = val_psnr
            torch.save({"net_g": state.ema.state_dict()},
                       run_dir / "checkpoints" / "best_gan_model.pth")
        torch.save({
            "net_g": state.g.state_dict(), "net_d": state.d.state_dict(),
            "optimizer_g": state.g_opt.state_dict(), "optimizer_d": state.d_opt.state_dict(),
            "ema": state.ema.state_dict(), "epoch": epoch, "best_psnr": best_psnr,
        }, run_dir / "checkpoints" / "latest_checkpoint.pth")
        if preview is not None:
            vb, sr = preview
            save_tris_preview(run_dir / "images" / f"epoch_{epoch:03d}.png",
                              vb["lr"][0] / 65535.0, sr, vb["hr"][0] / 65535.0)
    return last


def _load_pretrained_hat(path: str, model) -> None:
    """Seed the hybrid's HAT backbone from a HAT-only ``.pth`` (keys bare or
    under ``hat.``), non-strictly as the reference loads it
    (hybridmodels_hat.py:133-143)."""
    if not str(path).endswith(".pth"):
        raise ValueError(f"--pretrained-hat takes a .pth file (orbax needs jax): {path}")
    sd = load_torch_state_dict(path)
    if any(k.startswith("hat.") for k in sd):
        sd = {k[len("hat."):]: v for k, v in sd.items() if k.startswith("hat.")}
    missing, _ = model.hat.load_state_dict(sd, strict=False)
    if len(missing) == len(model.hat.state_dict()):
        raise ValueError(f"{path} holds no weight of the HAT backbone")


def train_hat_run(cfg: HATTrainConfig, resume: bool = True) -> dict:
    """Full Hybrid-HAT GAN training. Returns the last epoch's metrics."""
    device = resolve_device(cfg.device)
    run_dir = Path(cfg.outputs_root) / cfg.run_name
    (run_dir / "previews").mkdir(parents=True, exist_ok=True)
    (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    train_ds = PatchDataset(_split_entries(cfg, "train"), cfg.img_size, cfg.img_size * 4)
    per_step = cfg.batch_size * cfg.accum_steps
    if len(train_ds) < per_step:
        raise ValueError(f"train split has {len(train_ds)} pairs < one optimizer step "
                         f"({cfg.batch_size} x {cfg.accum_steps} accum = {per_step})")
    it = DataIterator(train_ds, per_step, shuffle=True, drop_last=True, seed=cfg.seed)

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    # the fused trunk takes bf16 on the card; the CPU runs the module path
    # unless fused_hab asks for the fused generator (its plain versions there)
    fused = cfg.fused_hab or (device.type == "cuda" and cfg.use_bf16)
    state = create_hat_train_state(
        torch.Generator().manual_seed(cfg.seed), img_size=cfg.img_size, embed_dim=cfg.embed_dim,
        depths=cfg.depths, num_heads=cfg.num_heads, window_size=cfg.window_size,
        num_rrdb=cfg.num_rrdb, num_feat=cfg.num_feat, num_grow_ch=cfg.num_grow_ch, dtype=dtype,
        fused=fused, fused_hab=cfg.fused_hab, device=device)
    if cfg.pretrained_hat:
        _load_pretrained_hat(cfg.pretrained_hat, state.g)
        state.ema.load_state_dict(state.g.state_dict())
        print(f"Seeded HAT backbone from {cfg.pretrained_hat}")
    criterion_g = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=1.0,
                                  adversarial_weight=0.005,
                                  vgg_apply=_load_vgg(cfg, dtype, device))
    step = make_hat_train_step(
        state, accum_steps=cfg.accum_steps, criterion_g=criterion_g, ema_decay=cfg.ema_decay,
        generator=torch.Generator().manual_seed(cfg.seed + 1),
        drop_generator=torch.Generator(device).manual_seed(cfg.seed + 2))
    ckpt = run_dir / "checkpoints"
    start_epoch = 1
    latest = latest_epoch_checkpoint(ckpt) if resume else None
    if latest is not None:
        start_epoch = _restore(state, latest, device)["epoch"] + 1
        print(f"Resume from epoch {start_epoch}")
    csv_log = CSVLogger(run_dir / "train_log.csv", HAT_CSV_COLUMNS, resume=start_epoch > 1)

    last = {}
    for epoch in range(start_epoch, cfg.epochs + 1):
        warmup = epoch <= cfg.warmup_epochs
        lr_g = cosine_annealing_lr(epoch, cfg.lr_g, cfg.epochs)
        lr_d = cosine_annealing_lr(epoch, cfg.lr_d, cfg.epochs)
        sums = dict.fromkeys(HAT_METRICS, 0.0)
        steps, last_batch = 0, None
        for bi, b in enumerate(it.epoch(epoch)):
            if cfg.max_steps_per_epoch and bi >= cfg.max_steps_per_epoch:
                break
            m = step({k: v.reshape(cfg.accum_steps, cfg.batch_size, *v.shape[1:])
                      for k, v in b.items()}, lr_g, lr_d, warmup=warmup)
            for k in sums:
                sums[k] += m[k]
            steps += 1
            last_batch = b
        n, cnt = max(steps, 1), max(sums["count"], 1.0)
        last = {"epoch": epoch, "g_total": sums["loss_g"] / n, "l1": sums["l1"] / n,
                "g_adv": sums["g_adv"] / n, "d_total": sums["loss_d"] / n,
                "psnr": sums["psnr_sum"] / cnt, "ssim": sums["ssim_sum"] / cnt, "lr": lr_g}
        print(f"Ep {epoch} [{'WARMUP' if warmup else 'GAN'}]: G={last['g_total']:.4f} "
              f"L1={last['l1']:.4f} D={last['d_total']:.4f} PSNR={last['psnr']:.2f}", flush=True)
        if epoch % cfg.csv_interval == 0:
            csv_log.log({"Epoch": epoch, "G_Total": last["g_total"], "L1": last["l1"],
                         "G_Adv": last["g_adv"], "D_Total": last["d_total"],
                         "PSNR": last["psnr"], "SSIM": last["ssim"], "LR": lr_g})
        if epoch % cfg.ckpt_interval == 0:
            torch.save({"net_g": state.g.state_dict(), "net_d": state.d.state_dict(),
                        "optimizer_g": state.g_opt.state_dict(),
                        "optimizer_d": state.d_opt.state_dict(), "ema": state.ema.state_dict(),
                        "epoch": epoch}, ckpt / f"hybrid_epoch_{epoch}.pth")
            # the reference overwrites 'best' unconditionally (train_hat.py:314-322)
            torch.save({"model_state_dict": state.g.state_dict()},
                       ckpt / "best_hybrid_model.pth")
            torch.save({"model_state_dict": state.ema.state_dict()},
                       ckpt / "best_hybrid_model_EMA.pth")
        if epoch % cfg.img_interval == 0 and last_batch is not None:
            pv = {k: v[:1] for k, v in last_batch.items()}
            out = make_eval_step(state.g_forward)(pv, device)
            save_tris_preview(run_dir / "previews" / f"epoch_{epoch:03d}_preview.png",
                              pv["lr"][0] / 65535.0, out["sr"][0].cpu().numpy(),
                              pv["hr"][0] / 65535.0)
    return last
