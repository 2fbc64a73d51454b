"""GAN train and eval steps of SwinIR (the JAX ``train/steps.py``).

One step consumes one accumulation window: a uint16 batch of shape
(accum, micro_batch, H, W, 1). The update algebra is the JAX step's
(train_swin.py:210-259):

- per micro-batch: /65535 normalisation, paired augmentation, one generator
  forward whose graph serves both phases;
- D phase first, on the detached SR: D(hr) then D(sr), RaGAN;
- G phase: D(sr) then D(hr) (detached), pixel 1.0 + perceptual 0.5 +
  RaGAN 0.005; each loss divided by ``accum``;
- every D forward runs in training mode, so the four of a micro-batch
  advance the spectral power iteration in that order;
- NaN guard: a non-finite D loss drops the accumulated D gradients and
  skips the G phase (its D forwards never run, so (u, v) stay as the D
  phase left them); a non-finite G loss drops the accumulated G gradients;
- D's optimizer steps, then G's, once per window even when no micro-batch
  was valid; the EMA follows G's step.

The G-phase gradient reaches only G: ``torch.autograd.grad`` takes the loss
to the SR image, and ``sr.backward`` carries it through the generator, as
the JAX step's ``vjp`` does; D's gradients come from the D phase alone.
Whether a loss is finite is read on the host, once per phase.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.augment import augment_pair_batch, draw_augment
from ..ops.metrics import psnr as psnr_fn, ssim as ssim_fn
from .ema import EMA_DECAY, ema_update
from .losses import CombinedGANLoss, DiscriminatorLoss
from .state import SwinTrainState


def to01(u16: np.ndarray, device) -> torch.Tensor:
    """uint16 array -> float32 in [0, 1] on ``device``; the copy moves 2 bytes
    a pixel (as int16 bits), widened on the device."""
    bits = torch.from_numpy(np.ascontiguousarray(u16).view(np.int16)).to(device)
    return (bits.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _zero_grads(module: torch.nn.Module) -> None:
    """Zero every gradient, creating missing ones: the optimizer then steps
    every parameter, as the JAX step does even when no micro-batch was valid."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def make_swin_train_step(
    state: SwinTrainState,
    *,
    accum_steps: int = 4,
    augment: bool = True,
    criterion_g: CombinedGANLoss | None = None,
    criterion_d: DiscriminatorLoss | None = None,
    ema_decay: float = EMA_DECAY,
    generator: torch.Generator | None = None,
):
    """SwinIR-GAN step: ``step(batch, lr_g, lr_d) -> metrics``, updating
    ``state`` in place. ``generator`` draws the augmentation."""
    criterion_g = criterion_g or CombinedGANLoss(
        pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005)
    criterion_d = criterion_d or DiscriminatorLoss()
    generator = generator or torch.Generator().manual_seed(0)
    g, d = state.g, state.d
    device = next(g.parameters()).device

    def step(batch, lr_g: float, lr_d: float) -> dict[str, float]:
        _zero_grads(g)
        _zero_grads(d)
        valid, g_sum, d_sum = 0, 0.0, 0.0
        for i in range(accum_steps):
            lr01, hr01 = to01(batch["lr"][i], device), to01(batch["hr"][i], device)
            if augment:
                lr01, hr01 = augment_pair_batch(lr01, hr01,
                                                draw_augment(lr01.shape[0], generator))
            sr = state.g_forward(lr01)

            # ---- D phase (reference order: real then fake)
            d_real = d(hr01, True)
            d_fake = d(sr.detach(), True)
            d_loss = criterion_d(d_real, d_fake)[0] / accum_steps
            if not torch.isfinite(d_loss).item():
                # reference zero_grad() + `continue`: drop D's window, skip G's phase
                _zero_grads(d)
                continue
            d_loss.backward()

            # ---- G phase (fake then real; d_real detached)
            d_fake = d(sr, True)
            d_real = d(hr01, True).detach()
            g_loss = criterion_g(sr, hr01, d_real, d_fake)[0] / accum_steps
            if not torch.isfinite(g_loss).item():
                _zero_grads(g)
                continue
            (sr_grad,) = torch.autograd.grad(g_loss, sr)
            sr.backward(sr_grad)
            valid += 1
            g_sum += g_loss.item() * accum_steps
            d_sum += d_loss.item() * accum_steps

        _set_lr(state.d_opt, lr_d)
        state.d_opt.step()
        _set_lr(state.g_opt, lr_g)
        state.g_opt.step()
        ema_update(state.ema, g, ema_decay)
        state.step += 1
        return {"loss_g": g_sum / max(valid, 1), "loss_d": d_sum / max(valid, 1),
                "valid_batches": float(valid)}

    return step


def make_eval_step(forward):
    """Validation step: forward (the EMA copy's, in the trainers) + nan_to_num +
    clamp + PSNR/SSIM (train_swin.py:277-290). Batch: {'lr','hr'} uint16 (B, H, W, 1)."""

    @torch.no_grad()
    def step(batch, device) -> dict:
        lr01, hr01 = to01(batch["lr"], device), to01(batch["hr"], device)
        sr = torch.nan_to_num(forward(lr01).float()).clamp(0.0, 1.0)
        b = sr.shape[0]
        return {
            "psnr_sum": float(psnr_fn(sr, hr01).sum()),
            "ssim_sum": float(ssim_fn(sr, hr01.clamp(0, 1))) * b,
            "count": float(b),
            "sr": sr,
        }

    return step
