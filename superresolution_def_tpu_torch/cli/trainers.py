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
the epoch after the saved one, and the CSV log is appended to. The
augmentation generator (and the hybrid's drop-path generator) is saved
with each checkpoint (keys ``rng_augment``, ``rng_drop_path``, which the
JAX package's ``.pth`` readers do not read) and restored with it, as the
JAX trainers restore their PRNG key, so a resumed run draws what an
uninterrupted one would. ``resume=False`` (``train --no-resume``) starts
over and rewrites the log.

Both run in the process group of the launch (``torchrun --nproc-per-node
N``, one process a card, NCCL; gloo on the CPU), or in a world of one
without it, as the JAX trainers run over the mesh of every chip:

- ``batch_size`` is per rank; the global micro-batch is ``batch_size *
  ranks``, and the check that the split holds one optimizer step uses it;
- each rank reads a disjoint rank-strided share of every epoch
  (``DataIterator(process_index=, process_count=)``), the train and the
  validation split alike, staged onto its card by ``prefetch_to_mesh``
  (the upload of batch i+1 overlaps step i);
- the step is data-parallel (``make_*_train_step(mesh=)``: global draws,
  losses and NaN guard, gradients averaged over the ranks), the validation
  sums are all-reduced (``sync_metrics``);
- only rank 0 writes: checkpoints, the CSV log, previews and, for swin,
  TensorBoard's ``Metrics/PSNR`` per epoch (``<run>/tensorboard``), with a
  barrier after each epoch's writes;
- a resumed run reads the checkpoint on every rank, then ``replicate``s
  rank 0's state.

Both keep every step's metrics on the device, as the JAX loops do (JAX
``cli/trainers.py:316-339, 481-501``): the steps return 0-d tensors, the
loop waits for the device once every :data:`_RUNAHEAD_SYNC` steps, and the
epoch's metrics come to the host in one transfer at its end.
"""

from __future__ import annotations

import dataclasses
import re
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..data import DataIterator, PatchDataset, merge_manifests
from ..models import load_torch_state_dict, vgg19_state_dict_from_jax
from ..obs import (
    HAT_CSV_COLUMNS,
    SWIN_CSV_COLUMNS,
    CSVLogger,
    TensorBoardLogger,
    save_tris_preview,
)
from ..parallel import make_mesh, prefetch_to_mesh, replicate, sync_metrics
from ..parallel.mesh import barrier
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
    # the fused generator (K2-K4); None: on for the card with bf16
    fused: bool | None = None
    # the SwinIR module's window attention ("xla" or "pallas", K11: forward
    # only, so a train step through it raises); the fused generator ignores it
    attn_impl: str = "xla"
    remat: bool = False  # the module's blocks rematerialized; the fused generator ignores it
    # D and the perceptual VGG rematerialized (train/steps.py): the same step
    # in less memory. Off, unlike the JAX swin default, whose micro-8 step
    # did not fit the TPU's 15.75 GB without it: on an 80 GB H100 the fused
    # micro-8 step fits, and the recompute only adds step time
    remat_loss: bool = False
    use_vgg: bool = True  # False: no perceptual term
    vgg_weights: str | None = None  # torchvision .pth or the JAX package's npz; None -> seeded
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
    # the fused trunk (K7/K8); None: on for the card with bf16, or with fused_hab
    fused: bool | None = None
    # the HAT backbone's window attention and its RHAGs rematerialized, where
    # it runs as the module (unfused, and around the K7/K8 trunk); fused_hab
    # ignores both
    attn_impl: str = "xla"
    remat: bool = False
    remat_loss: bool = False  # D and the perceptual VGG rematerialized, as the JAX default
    use_vgg: bool = True  # False: no perceptual term
    vgg_weights: str | None = None  # torchvision .pth or the JAX package's npz; None -> seeded
    pretrained_hat: str | None = None  # a HAT-only .pth to seed the backbone
    fused_hab: bool = False  # the backbone's HABs and OCABs through K9/K10 too
    seed: int = 0
    max_steps_per_epoch: int | None = None
    device: str = "cuda"

    @property
    def run_name(self) -> str:
        return "_".join(self.targets)


def _split_entries(cfg, split: str) -> list:
    return merge_manifests([Path(cfg.data_root) / t / "8_dataset_split" / "splits_json"
                            / f"{split}.json" for t in cfg.targets], cfg.data_root)


def _load_vgg(cfg, dtype: torch.dtype, device) -> VGG19Features | None:
    """VGG19[:36] for the perceptual loss, None without ``use_vgg``: from
    ``vgg_weights`` when given, a torchvision ``vgg19`` state dict (``.pth``:
    its ``features.{i}`` keys load as they are) or the JAX package's npz
    (``cli/port_vgg.py``'s, read with numpy); else seeded weights."""
    if not cfg.use_vgg:
        return None
    model = VGG19Features(cutoff=35, dtype=dtype, generator=torch.Generator().manual_seed(0))
    if cfg.vgg_weights and str(cfg.vgg_weights).endswith((".pth", ".pt")):
        sd = load_torch_state_dict(cfg.vgg_weights)
        model.load_state_dict({k: v for k, v in sd.items() if k.startswith("features.")})
    elif cfg.vgg_weights:
        loaded = np.load(cfg.vgg_weights, allow_pickle=True)
        params = loaded["params"].item() if "params" in loaded else dict(loaded)
        model.load_state_dict(vgg19_state_dict_from_jax(params))
    return model.to(device).requires_grad_(False).eval()


def _restore(state, path: Path, device, generators: dict | None = None) -> dict:
    """Loads G, D, both optimizers and the EMA copy of ``state`` from the
    checkpoint at ``path``, and each of ``generators`` (checkpoint key ->
    ``torch.Generator``) whose state the checkpoint holds; returns the
    checkpoint. ``load_state_dict`` copies into the parameters in place,
    which moves their versions, so the kernels' cached packed weights are
    remade from the loaded values."""
    ck = torch.load(path, map_location=device, weights_only=False)
    state.g.load_state_dict(ck["net_g"])
    state.d.load_state_dict(ck["net_d"])
    state.g_opt.load_state_dict(ck["optimizer_g"])
    state.d_opt.load_state_dict(ck["optimizer_d"])
    state.ema.load_state_dict(ck["ema"])
    for key, gen in (generators or {}).items():
        if key in ck:  # checkpoints written before the key existed restart the stream
            gen.set_state(ck[key].cpu())  # map_location may have moved it to the card
    return ck


def _generator_states(generators: dict) -> dict:
    return {key: gen.get_state() for key, gen in generators.items()}


def _reshape_accum(batch: dict, accum: int, micro: int) -> dict:
    return {k: v.reshape(accum, micro, *v.shape[1:]) for k, v in batch.items()}


def _check_split(n: int, cfg, ranks: int) -> int:
    """The global micro-batch; raises when the split holds no optimizer step."""
    micro = cfg.batch_size * ranks
    per_step = micro * cfg.accum_steps
    if n < per_step:
        raise ValueError(f"train split has {n} pairs < one optimizer step ({cfg.batch_size}/rank "
                         f"x {ranks} ranks x {cfg.accum_steps} accum = {per_step})")
    return micro


# Deferring metric reads to epoch end removes every per-step sync, so the
# host could dispatch arbitrarily far ahead of the device, keeping each
# dispatched step's batch alive: the pinned host copy and the side-stream
# upload that prefetch_to_mesh records on the consumer's stream are freed
# only once the step that read them has run. Every _RUNAHEAD_SYNC steps the
# loop reads one scalar from that many steps back: at most ~2x_RUNAHEAD_SYNC
# steps' batches are ever held, while paying one wait per _RUNAHEAD_SYNC
# steps instead of one per step.
_RUNAHEAD_SYNC = 8


def _wait_for(value: torch.Tensor) -> float:
    """The run-ahead bound's read: the host waits until ``value`` is computed."""
    return value.item()


def _run_steps(stream, step, max_steps: int | None, *args, **kwargs) -> tuple[list, dict | None]:
    """``step(batch, *args, **kwargs)`` on each staged batch of ``stream``, at
    most ``max_steps`` of them: the steps' metrics, kept on the device, and
    the last host batch. Every :data:`_RUNAHEAD_SYNC` steps the host waits
    for ``loss_g`` of the step that many back."""
    metrics, last = [], None
    for bi, (host, b) in enumerate(stream):
        if max_steps and bi >= max_steps:
            break
        metrics.append(step(b, *args, **kwargs))
        last = host
        if len(metrics) % _RUNAHEAD_SYNC == 0:
            _wait_for(metrics[-_RUNAHEAD_SYNC]["loss_g"])
    return metrics, last


def _drain(metrics: list[dict], keys: Sequence[str]) -> list[list[float]]:
    """Each step's ``keys`` as Python floats, in one host transfer."""
    if not metrics:
        return []
    return torch.stack([torch.stack([m[k] for k in keys]) for m in metrics]).cpu().tolist()


def latest_epoch_checkpoint(ckpt_dir: Path) -> Path | None:
    """The ``hybrid_epoch_N.pth`` of the largest N (compared as integers), or None."""
    found = [(int(m.group(1)), p) for p in ckpt_dir.glob("hybrid_epoch_*.pth")
             if (m := re.fullmatch(r"hybrid_epoch_(\d+)\.pth", p.name))]
    return max(found)[1] if found else None


def train_swin_run(cfg: SwinTrainConfig, resume: bool = True) -> dict:
    """Full SwinIR-GAN training. Returns the last epoch's metrics."""
    mesh = make_mesh(cfg.device)
    device, master = mesh.device, mesh.rank == 0
    run_dir = Path(cfg.outputs_root) / cfg.run_name
    if master:
        (run_dir / "images").mkdir(parents=True, exist_ok=True)
        (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    hr_size = cfg.img_size * cfg.upscale
    train_ds = PatchDataset(_split_entries(cfg, "train"), cfg.img_size, hr_size)
    val_ds = PatchDataset(_split_entries(cfg, "val"), cfg.img_size, hr_size)
    _check_split(len(train_ds), cfg, mesh.size)
    shard = dict(process_index=mesh.rank, process_count=mesh.size)
    it = DataIterator(train_ds, cfg.batch_size * cfg.accum_steps, shuffle=True, drop_last=True,
                      seed=cfg.seed, **shard)
    val_it = DataIterator(val_ds, 1, **shard)

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    # the fused kernels take bf16 on the card; the CPU runs the module path
    fused = cfg.fused if cfg.fused is not None else device.type == "cuda" and cfg.use_bf16
    state = create_swin_train_state(
        torch.Generator().manual_seed(cfg.seed), img_size=cfg.img_size, upscale=cfg.upscale,
        embed_dim=cfg.embed_dim, depths=cfg.depths, num_heads=cfg.num_heads,
        window_size=cfg.window_size, mlp_ratio=cfg.mlp_ratio, dtype=dtype, fused=fused,
        device=device, attn_impl=cfg.attn_impl, remat=cfg.remat)
    criterion_g = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                  adversarial_weight=0.005,
                                  vgg_apply=_load_vgg(cfg, dtype, device))
    generators = {"rng_augment": torch.Generator().manual_seed(cfg.seed + 1)}
    step = make_swin_train_step(state, accum_steps=cfg.accum_steps, criterion_g=criterion_g,
                                ema_decay=cfg.ema_decay, generator=generators["rng_augment"],
                                mesh=mesh, remat_loss=cfg.remat_loss)
    eval_step = make_eval_step(state.ema_forward)
    start_epoch, best_psnr = 1, 0.0
    latest = run_dir / "checkpoints" / "latest_checkpoint.pth"
    if resume and latest.exists():
        ck = _restore(state, latest, device, generators)
        start_epoch, best_psnr = ck["epoch"] + 1, ck["best_psnr"]
        if master:
            print(f"Resumed from epoch {start_epoch}")
    replicate(state, mesh)
    csv_log = tb = None
    if master:
        csv_log = CSVLogger(run_dir / "metrics.csv", SWIN_CSV_COLUMNS, resume=start_epoch > 1)
        tb = TensorBoardLogger(run_dir / "tensorboard")

    last = {}
    for epoch in range(start_epoch, cfg.epochs + 1):
        t0 = time.time()
        lr_g = cosine_annealing_lr(epoch, cfg.lr_g, cfg.epochs)
        lr_d = cosine_annealing_lr(epoch, cfg.lr_d, cfg.epochs)
        with prefetch_to_mesh(it.epoch(epoch), mesh, transform=lambda b: _reshape_accum(
                b, cfg.accum_steps, cfg.batch_size)) as stream:
            step_metrics, _ = _run_steps(stream, step, cfg.max_steps_per_epoch, lr_g, lr_d)
        g_sum = d_sum = valid = 0.0
        for loss_g, loss_d, n in _drain(step_metrics, ("loss_g", "loss_d", "valid_batches")):
            g_sum += loss_g * n
            d_sum += loss_d * n
            valid += n
        avg_g, avg_d = g_sum / max(valid, 1.0), d_sum / max(valid, 1.0)

        # EMA-copy validation (train_swin.py:277-300), summed over the ranks
        sums = {"psnr_sum": 0.0, "ssim_sum": 0.0, "count": 0.0}
        preview = None
        for vi, vb in enumerate(val_it.epoch(0)):
            if cfg.max_steps_per_epoch and vi >= cfg.max_steps_per_epoch:
                break
            out = eval_step(vb, device)
            for k in sums:
                sums[k] += out[k]
            preview = (vb, out["sr"][0].cpu().numpy())
        sums = sync_metrics(sums, mesh)
        val_psnr = sums["psnr_sum"] / max(sums["count"], 1.0)
        val_ssim = sums["ssim_sum"] / max(sums["count"], 1.0)

        dt = time.time() - t0
        last = {"epoch": epoch, "loss_g": avg_g, "loss_d": avg_d, "psnr": val_psnr,
                "ssim": val_ssim, "time_sec": dt}
        if val_psnr > best_psnr:
            best_psnr = val_psnr
            if master:
                torch.save({"net_g": state.ema.state_dict()},
                           run_dir / "checkpoints" / "best_gan_model.pth")
        if master:
            print(f"Ep {epoch}: G={avg_g:.4f} D={avg_d:.4f} PSNR={val_psnr:.2f} "
                  f"SSIM={val_ssim:.4f} ({dt:.1f}s)", flush=True)
            csv_log.log({"Epoch": epoch, "Loss_G": avg_g, "Loss_D": avg_d, "PSNR": val_psnr,
                         "SSIM": val_ssim, "Time_Sec": round(dt, 1)})
            tb.scalar("Metrics/PSNR", val_psnr, epoch)
            tb.flush()
            torch.save({
                "net_g": state.g.state_dict(), "net_d": state.d.state_dict(),
                "optimizer_g": state.g_opt.state_dict(),
                "optimizer_d": state.d_opt.state_dict(),
                "ema": state.ema.state_dict(), "epoch": epoch, "best_psnr": best_psnr,
                **_generator_states(generators),
            }, run_dir / "checkpoints" / "latest_checkpoint.pth")
            if preview is not None:
                vb, sr = preview
                save_tris_preview(run_dir / "images" / f"epoch_{epoch:03d}.png",
                                  vb["lr"][0] / 65535.0, sr, vb["hr"][0] / 65535.0)
        barrier(mesh)
    if tb is not None:
        tb.close()
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
    mesh = make_mesh(cfg.device)
    device, master = mesh.device, mesh.rank == 0
    run_dir = Path(cfg.outputs_root) / cfg.run_name
    if master:
        (run_dir / "previews").mkdir(parents=True, exist_ok=True)
        (run_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    train_ds = PatchDataset(_split_entries(cfg, "train"), cfg.img_size, cfg.img_size * 4)
    _check_split(len(train_ds), cfg, mesh.size)
    it = DataIterator(train_ds, cfg.batch_size * cfg.accum_steps, shuffle=True, drop_last=True,
                      seed=cfg.seed, process_index=mesh.rank, process_count=mesh.size)

    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    # the fused trunk takes bf16 on the card; the CPU runs the module path
    # unless fused_hab asks for the fused generator (its plain versions there)
    fused = cfg.fused
    if fused is None:
        fused = cfg.fused_hab or (device.type == "cuda" and cfg.use_bf16)
    state = create_hat_train_state(
        torch.Generator().manual_seed(cfg.seed), img_size=cfg.img_size, embed_dim=cfg.embed_dim,
        depths=cfg.depths, num_heads=cfg.num_heads, window_size=cfg.window_size,
        num_rrdb=cfg.num_rrdb, num_feat=cfg.num_feat, num_grow_ch=cfg.num_grow_ch, dtype=dtype,
        fused=fused, fused_hab=cfg.fused_hab, device=device, attn_impl=cfg.attn_impl,
        remat=cfg.remat)
    if cfg.pretrained_hat:
        _load_pretrained_hat(cfg.pretrained_hat, state.g)
        state.ema.load_state_dict(state.g.state_dict())
        if master:
            print(f"Seeded HAT backbone from {cfg.pretrained_hat}")
    criterion_g = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=1.0,
                                  adversarial_weight=0.005,
                                  vgg_apply=_load_vgg(cfg, dtype, device))
    generators = {"rng_augment": torch.Generator().manual_seed(cfg.seed + 1),
                  "rng_drop_path": torch.Generator(device).manual_seed(cfg.seed + 2)}
    step = make_hat_train_step(
        state, accum_steps=cfg.accum_steps, criterion_g=criterion_g, ema_decay=cfg.ema_decay,
        generator=generators["rng_augment"], drop_generator=generators["rng_drop_path"],
        mesh=mesh, remat_loss=cfg.remat_loss)
    ckpt = run_dir / "checkpoints"
    start_epoch = 1
    latest = latest_epoch_checkpoint(ckpt) if resume else None
    if latest is not None:
        start_epoch = _restore(state, latest, device, generators)["epoch"] + 1
        if master:
            print(f"Resume from epoch {start_epoch}")
    replicate(state, mesh)
    csv_log = None
    if master:
        csv_log = CSVLogger(run_dir / "train_log.csv", HAT_CSV_COLUMNS, resume=start_epoch > 1)

    last = {}
    for epoch in range(start_epoch, cfg.epochs + 1):
        warmup = epoch <= cfg.warmup_epochs
        lr_g = cosine_annealing_lr(epoch, cfg.lr_g, cfg.epochs)
        lr_d = cosine_annealing_lr(epoch, cfg.lr_d, cfg.epochs)
        with prefetch_to_mesh(it.epoch(epoch), mesh, transform=lambda b: _reshape_accum(
                b, cfg.accum_steps, cfg.batch_size)) as stream:
            step_metrics, last_batch = _run_steps(stream, step, cfg.max_steps_per_epoch,
                                                  lr_g, lr_d, warmup=warmup)
        sums = dict.fromkeys(HAT_METRICS, 0.0)
        for row in _drain(step_metrics, HAT_METRICS):
            for k, v in zip(HAT_METRICS, row):
                sums[k] += v
        n, cnt = max(len(step_metrics), 1), max(sums["count"], 1.0)
        last = {"epoch": epoch, "g_total": sums["loss_g"] / n, "l1": sums["l1"] / n,
                "g_adv": sums["g_adv"] / n, "d_total": sums["loss_d"] / n,
                "psnr": sums["psnr_sum"] / cnt, "ssim": sums["ssim_sum"] / cnt, "lr": lr_g}
        if master:
            print(f"Ep {epoch} [{'WARMUP' if warmup else 'GAN'}]: G={last['g_total']:.4f} "
                  f"L1={last['l1']:.4f} D={last['d_total']:.4f} PSNR={last['psnr']:.2f}",
                  flush=True)
            if epoch % cfg.csv_interval == 0:
                csv_log.log({"Epoch": epoch, "G_Total": last["g_total"], "L1": last["l1"],
                             "G_Adv": last["g_adv"], "D_Total": last["d_total"],
                             "PSNR": last["psnr"], "SSIM": last["ssim"], "LR": lr_g})
            if epoch % cfg.ckpt_interval == 0:
                torch.save({"net_g": state.g.state_dict(), "net_d": state.d.state_dict(),
                            "optimizer_g": state.g_opt.state_dict(),
                            "optimizer_d": state.d_opt.state_dict(),
                            "ema": state.ema.state_dict(), "epoch": epoch,
                            **_generator_states(generators)},
                           ckpt / f"hybrid_epoch_{epoch}.pth")
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
        barrier(mesh)
    return last
