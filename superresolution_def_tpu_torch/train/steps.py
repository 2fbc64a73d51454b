"""GAN train and eval steps of SwinIR and the HAT-Real hybrid (the JAX ``train/steps.py``).

One step consumes one accumulation window: a uint16 batch of shape
(accum, micro_batch, H, W, 1). The SwinIR step's update algebra is the JAX
step's (train_swin.py:210-259):

- per micro-batch: /65535 normalisation, paired augmentation, one generator
  forward whose graph serves both phases;
- D phase first, on the detached SR: D(hr) then D(sr), RaGAN;
- G phase: D(sr) then D(hr) (detached), pixel 1.0 + perceptual 0.5 +
  RaGAN 0.005; each loss divided by ``accum``;
- every D forward runs in training mode, so the four of a micro-batch
  advance the spectral power iteration in that order;
- NaN guard: a non-finite D loss drops the accumulated D gradients and
  skips the G phase (its gradient and its spectral updates are discarded,
  so (u, v) stay as the D phase left them); a non-finite G loss drops the
  accumulated G gradients;
- D's optimizer steps, then G's, once per window even when no micro-batch
  was valid; the EMA follows G's step.

The G-phase gradient reaches only G: ``torch.autograd.grad`` takes the loss
to the SR image, and ``sr.backward`` carries it through the generator, as
the JAX step's ``vjp`` does; D's gradients come from the D phase alone.
The guard is the JAX step's selects (``train/steps.py:162-193`` there), on
the device: both phases always run, and 0-d bool tensors choose, in place
in the :class:`FlatGrads` buffer, between the accumulation with the
micro-batch's gradient, without it, or zero (``torch.where``: NaN * 0 is
NaN), and between the spectral vectors after the G phase and after the D
phase. The loss sums and the count of valid micro-batches stay on the
device, and the step returns them as 0-d tensors: it never waits for the
device, so the host can queue the next step while this one runs.

With a ``mesh`` (``parallel.make_mesh``) the step is data-parallel, each
rank holding its rows of every micro-batch, and computes what one process
computes on the concatenated batch, as the JAX step does under SPMD: the
augmentation and drop-path draws are for the global micro-batch (each rank
keeps its rows), RaGAN averages the logits over the global micro-batch,
the NaN guard decides on the global loss (every rank skips the same
window), the accumulated gradients are averaged over the ranks before the
optimizers step (:class:`~..parallel.mesh.FlatGrads`), and the
returned metrics are global. Each global statistic is written once, as a
sum all-reduced over a count, so a world of one computes the bits of the
step without a mesh.

:func:`make_hat_train_step` is the hybrid's (train_hat.py:219-266): G phase
first, then D; no NaN guard; see its docstring.

``remat_loss`` (both steps, the JAX flag) runs every D forward and the
perceptual VGG forward of SR stage by stage as rematerialized regions: D
keeps only its stage boundaries (the JAX ``d_stage`` tags), VGG its pooled
block outputs (``vgg_block``; the criterion's ``vgg_apply`` is called with
``remat=True``, as :class:`~.vgg.VGG19Features` takes it), and the backward
recomputes each stage's interior. Only the stages are regions, never the
loss arithmetic, so no collective (RaGAN's ``batch_means``, the guard's
``global_mean``) runs in a recompute; D's power iterations run once a
forward, outside the regions, and the recompute divides by the forward's
sigma. The step is the same: the same autograd graph, the stash recomputed
to the same values.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..data.augment import augment_pair_batch, draw_augment
from ..models.hat import DrawShard
from ..models.spectral_norm import SNConv2d
from ..parallel.mesh import FlatGrads, Mesh, all_reduce_sum, global_mean
from ..ops.metrics import psnr as psnr_fn, ssim as ssim_fn
from .ema import EMA_DECAY, ema_update
from .losses import CombinedGANLoss, DiscriminatorLoss, l1_loss
from .state import HATTrainState, SwinTrainState


def to01(u16, device) -> torch.Tensor:
    """uint16 array -> float32 in [0, 1] on ``device``; the copy moves 2 bytes
    a pixel (as int16 bits), widened on the device. A tensor is taken as
    int16 bits already staged (``parallel.shard_batch``)."""
    if not isinstance(u16, torch.Tensor):
        u16 = torch.from_numpy(np.ascontiguousarray(u16).view(np.int16))
    bits = u16.to(device)
    return (bits.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _remat_perceptual(criterion: CombinedGANLoss) -> CombinedGANLoss:
    """``criterion`` whose perceptual feature function is called with
    ``remat=True`` (:class:`~.vgg.VGG19Features`: block by block)."""
    if criterion.vgg_apply is None:
        return criterion
    return dataclasses.replace(criterion,
                               vgg_apply=functools.partial(criterion.vgg_apply, remat=True))


def _select_(ok: torch.Tensor, acc: list[torch.Tensor],
             other: list[torch.Tensor] | None = None) -> None:
    """``acc`` <- ``where(ok, acc, other)`` in place, one run of a flat
    gradient buffer at a time; ``other`` None is zero."""
    for i, t in enumerate(acc):
        torch.where(ok, t, t.new_zeros(()) if other is None else other[i], out=t)


def make_swin_train_step(
    state: SwinTrainState,
    *,
    accum_steps: int = 4,
    augment: bool = True,
    criterion_g: CombinedGANLoss | None = None,
    criterion_d: DiscriminatorLoss | None = None,
    ema_decay: float = EMA_DECAY,
    generator: torch.Generator | None = None,
    mesh: Mesh | None = None,
    remat_loss: bool = False,
):
    """SwinIR-GAN step: ``step(batch, lr_g, lr_d) -> metrics``, updating
    ``state`` in place. ``generator`` draws the augmentation; ``mesh`` makes
    the step data-parallel, ``remat_loss`` rematerializes D and the
    perceptual VGG (the module docstring). The metrics, ``loss_g``,
    ``loss_d`` (means over the valid micro-batches) and ``valid_batches``,
    are 0-d float32 tensors on the model's device."""
    criterion_g = dataclasses.replace(criterion_g or CombinedGANLoss(
        pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005), mesh=mesh)
    if remat_loss:
        criterion_g = _remat_perceptual(criterion_g)
    criterion_d = dataclasses.replace(criterion_d or DiscriminatorLoss(), mesh=mesh)
    generator = generator or torch.Generator().manual_seed(0)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    g, d = state.g, state.d
    device = next(g.parameters()).device
    grads = FlatGrads((g, d), mesh)
    g_acc, d_acc = grads.segments
    spectral = [m for m in d.modules() if isinstance(m, SNConv2d)]

    def step(batch, lr_g: float, lr_d: float) -> dict[str, torch.Tensor]:
        grads.zero_()
        valid = g_sum = d_sum = torch.zeros((), device=device)
        for i in range(accum_steps):
            lr01, hr01 = to01(batch["lr"][i], device), to01(batch["hr"][i], device)
            if augment:
                lr01, hr01 = augment_pair_batch(
                    lr01, hr01, draw_augment(lr01.shape[0], generator, rank, world))
            sr = state.g_forward(lr01)

            # ---- D phase (reference order: real then fake)
            d_real = d(hr01, True, remat_loss)
            d_fake = d(sr.detach(), True, remat_loss)
            d_loss = criterion_d(d_real, d_fake)[0] / accum_steps
            d_global = global_mean(d_loss, mesh)
            d_ok = torch.isfinite(d_global)
            d_loss.backward()
            # reference zero_grad() on a non-finite D loss: drop D's window
            _select_(d_ok, d_acc)
            spec1 = [(m.weight_u, m.weight_v) for m in spectral]  # SNConv2d rebinds them

            # ---- G phase (fake then real; d_real detached)
            g_before = [t.clone() for t in g_acc] if i else None  # zero before the first
            d_fake = d(sr, True, remat_loss)
            d_real = d(hr01, True, remat_loss).detach()
            g_loss = criterion_g(sr, hr01, d_real, d_fake)[0] / accum_steps
            g_global = global_mean(g_loss, mesh)
            g_ok = torch.isfinite(g_global)
            (sr_grad,) = torch.autograd.grad(g_loss, sr)
            sr.backward(sr_grad)
            both = d_ok & g_ok
            # G-NaN drops G's window; D-NaN `continue`s past the G phase
            if g_before is not None:
                _select_(~d_ok, g_before)
            _select_(both, g_acc, g_before)
            for m, (u, v) in zip(spectral, spec1):
                m.weight_u = torch.where(d_ok, m.weight_u, u)
                m.weight_v = torch.where(d_ok, m.weight_v, v)
            valid = valid + both.float()
            g_sum = g_sum + torch.where(both, g_global.float() * accum_steps, 0.0)
            d_sum = d_sum + torch.where(both, d_global.float() * accum_steps, 0.0)

        grads.average()
        _set_lr(state.d_opt, lr_d)
        state.d_opt.step()
        _set_lr(state.g_opt, lr_g)
        state.g_opt.step()
        ema_update(state.ema, g, ema_decay)
        state.step += 1
        count = valid.clamp(min=1.0)
        return {"loss_g": g_sum / count, "loss_d": d_sum / count, "valid_batches": valid}

    return step


def hat_d_phase(d, criterion_d: DiscriminatorLoss, fake: torch.Tensor, real: torch.Tensor,
                accum_steps: int = 1, remat: bool = False) -> torch.Tensor:
    """The hybrid step's D phase (train_hat.py:258-266): D(fake), then D(real),
    both training forwards, and the backward of the RaGAN-D loss over
    ``accum_steps`` into D's gradients; returns the loss. ``fake`` is the
    detached SR; ``remat`` is the step's ``remat_loss``."""
    d_fake = d(fake, True, remat)
    d_real = d(real, True, remat)
    d_loss = criterion_d(d_real, d_fake)[0]
    (d_loss / accum_steps).backward()
    return d_loss


HAT_METRICS = ("loss_g", "l1", "g_adv", "loss_d", "psnr_sum", "ssim_sum", "count")


def make_hat_train_step(
    state: HATTrainState,
    *,
    accum_steps: int = 16,
    augment: bool = True,
    criterion_g: CombinedGANLoss | None = None,
    criterion_d: DiscriminatorLoss | None = None,
    ema_decay: float = EMA_DECAY,
    generator: torch.Generator | None = None,
    drop_generator: torch.Generator | None = None,
    mesh: Mesh | None = None,
    remat_loss: bool = False,
):
    """Hybrid-HAT GAN step: ``step(batch, lr_g, lr_d, warmup=False) ->
    metrics``, updating ``state`` in place. ``generator`` draws the
    augmentation, ``drop_generator`` (on the model's device) the drop-path;
    ``mesh`` makes the step data-parallel, ``remat_loss`` rematerializes D
    and the perceptual VGG (the module docstring).

    Per micro-batch: /65535, paired augmentation, one G forward with
    drop-path on. G phase first: L1 alone during ``warmup`` (no D forward),
    else D(sr) then D(hr) (detached) with pixel 1.0 + perceptual 1.0 +
    RaGAN 0.005; the gradient reaches G only. Then the D phase on the
    detached SR, D(fake) then D(real), skipped in warmup, when neither D's
    optimizer nor its (u, v) move. Live metrics on the detached SR: L1, the
    PSNR sum and SSIM of the clipped images. G's optimizer steps, the EMA
    follows, then D's. The metrics are summed on the device, all-reduced
    over the ranks, and returned as 0-d float32 tensors on the model's
    device (the four losses as means over the micro-batches and ranks); the
    names are the JAX step's (:data:`HAT_METRICS`). No guard: the JAX step
    has none.
    """
    criterion_g = dataclasses.replace(criterion_g or CombinedGANLoss(
        pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005), mesh=mesh)
    if remat_loss:
        criterion_g = _remat_perceptual(criterion_g)
    criterion_d = dataclasses.replace(criterion_d or DiscriminatorLoss(), mesh=mesh)
    generator = generator or torch.Generator().manual_seed(0)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    g, d = state.g, state.d
    device = next(g.parameters()).device
    drops = DrawShard(drop_generator or torch.Generator(device).manual_seed(0), rank, world)
    grads = FlatGrads((g, d), mesh)

    def step(batch, lr_g: float, lr_d: float, warmup: bool = False) -> dict[str, torch.Tensor]:
        grads.zero_()  # D's stay zero in warmup: its average is zero too
        # loss_g, l1, g_adv, loss_d, psnr_sum, ssim_sum, count
        sums = torch.zeros(len(HAT_METRICS), device=device)
        for i in range(accum_steps):
            lr01, hr01 = to01(batch["lr"][i], device), to01(batch["hr"][i], device)
            if augment:
                lr01, hr01 = augment_pair_batch(
                    lr01, hr01, draw_augment(lr01.shape[0], generator, rank, world))
            sr = state.g_forward(lr01, False, drops)

            # ---- G phase first (train_hat.py:225-251)
            if warmup:
                g_loss = l1_loss(sr, hr01)
                g_adv = torch.zeros((), device=device)
            else:
                d_fake = d(sr, True, remat_loss)
                d_real = d(hr01, True, remat_loss).detach()
                g_loss, parts = criterion_g(sr, hr01, d_real, d_fake)
                g_adv = parts["adversarial"]
            (sr_grad,) = torch.autograd.grad(g_loss / accum_steps, sr)
            sr.backward(sr_grad)
            sr = sr.detach()

            # ---- D phase (fake then real, train_hat.py:258-266)
            d_loss = torch.zeros((), device=device)
            if not warmup:
                d_loss = hat_d_phase(d, criterion_d, sr, hr01, accum_steps, remat_loss)

            # ---- live train metrics (train_hat.py:228)
            with torch.no_grad():
                b = sr.shape[0]
                sums += torch.stack([
                    g_loss.detach().float(), l1_loss(sr, hr01).float(), g_adv.detach().float(),
                    d_loss.detach().float(), psnr_fn(sr, hr01).sum().float(),
                    ssim_fn(sr.clamp(0, 1), hr01.clamp(0, 1)).float() * b,
                    torch.full((), b, dtype=torch.float32, device=device)])

        grads.average()
        _set_lr(state.g_opt, lr_g)
        state.g_opt.step()
        ema_update(state.ema, g, ema_decay)
        if not warmup:
            _set_lr(state.d_opt, lr_d)
            state.d_opt.step()
        state.step += 1
        sums = all_reduce_sum(sums, mesh)
        # loss_g, l1, g_adv, loss_d: means over the micro-batches and ranks
        sums = torch.cat([sums[:4] / (accum_steps * world), sums[4:]])
        return dict(zip(HAT_METRICS, sums.unbind()))

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
