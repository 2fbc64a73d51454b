"""SwinIR GAN training loop (the JAX ``cli/trainers.py::train_swin_run``).

Behaviour (train_swin.py:88-341): outputs/<targets>_DDP_SwinIR/{checkpoints,
images}; merged multi-target manifests; cosine LR per epoch (eta_min 1e-7);
per epoch the steps, then EMA-copy validation (PSNR/SSIM), a CSV row
[Epoch, Loss_G, Loss_D, PSNR, SSIM, Time_Sec], an [LR|SR|HR] preview,
``best_gan_model.pth`` (``{'net_g': EMA state dict}``, the reference layout
the port's ``infer`` reads) when the validation PSNR improves, and
``latest_checkpoint.pth`` with G, D (with its spectral buffers), both
optimizers, the EMA copy, the epoch and the best PSNR.

One process on one device. Not ported yet: resume, TensorBoard, host-to-device
prefetch overlap, multi-GPU.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..data import DataIterator, PatchDataset, load_manifest
from ..models import vgg19_state_dict_from_jax
from ..obs import SWIN_CSV_COLUMNS, CSVLogger, save_tris_preview
from ..train import (
    CombinedGANLoss,
    VGG19Features,
    cosine_annealing_lr,
    create_swin_train_state,
    make_eval_step,
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


def _split_entries(cfg: SwinTrainConfig, split: str) -> list:
    return [e for t in cfg.targets for e in load_manifest(
        Path(cfg.data_root) / t / "8_dataset_split" / "splits_json" / f"{split}.json",
        cfg.data_root)]


def _load_vgg(cfg: SwinTrainConfig, dtype: torch.dtype, device) -> VGG19Features:
    """VGG19[:36] for the perceptual loss: the JAX package's npz when given
    (read with numpy), else seeded weights."""
    model = VGG19Features(cutoff=35, dtype=dtype, generator=torch.Generator().manual_seed(0))
    if cfg.vgg_weights:
        loaded = np.load(cfg.vgg_weights, allow_pickle=True)
        params = loaded["params"].item() if "params" in loaded else dict(loaded)
        model.load_state_dict(vgg19_state_dict_from_jax(params))
    return model.to(device).requires_grad_(False).eval()


def train_swin_run(cfg: SwinTrainConfig) -> dict:
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
    csv_log = CSVLogger(run_dir / "metrics.csv", SWIN_CSV_COLUMNS)

    best_psnr, last = 0.0, {}
    for epoch in range(1, cfg.epochs + 1):
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
