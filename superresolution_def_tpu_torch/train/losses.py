"""Losses with the reference's algebra (the JAX ``train/losses.py``).

- GANLoss: 'vanilla' = BCE-with-logits vs constant targets, 'lsgan'/'ragan'
  = MSE vs constant targets (gan_losses_swin.py:6-27).
- RaGAN: symmetric relativistic-average BCE, halved (gan_losses_swin.py:29-42).
  The detach pattern is the caller's job, as in the reference. Its averages
  of the logits are over the global micro-batch: with a ``mesh`` the local
  sums are all-reduced (differentiably) over the global count, the one
  formula at every world size (``parallel.mesh.batch_means``).
- CombinedGANLoss: pixel_w*L1 + perc_w*VGG + adv_w*RaGAN-G (+ texture)
  (gan_losses_swin.py:74-112; swin weights 1.0/0.5/0.005).
- DiscriminatorLoss: RaGAN-D (gan_losses_swin.py:117-134).
- Charbonnier: SUM reduction of sqrt(diff^2 + 1e-6) (losses_train_swin.py:42).
- Texture: Gram-matrix MSE of VGG features (gan_losses_swin.py:44-72).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..parallel.mesh import Mesh, batch_means


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def charbonnier_loss(pred, target, eps: float = 1e-6) -> torch.Tensor:
    diff = pred - target
    return torch.sqrt(diff * diff + eps).sum()


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCEWithLogits, the numerically stable log-sum-exp form."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_loss(prediction: torch.Tensor, target_is_real: bool, gan_type: str = "ragan",
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """Plain GAN loss vs a constant target (GANLoss in the reference)."""
    target = torch.full_like(prediction, real_label if target_is_real else fake_label)
    if gan_type == "vanilla":
        return _bce_with_logits(prediction, target)
    if gan_type in ("lsgan", "ragan"):
        return ((prediction - target) ** 2).mean()
    raise ValueError(f"GAN type {gan_type} not supported")


def relative_gan_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor,
                      for_discriminator: bool = True, mesh: Mesh | None = None) -> torch.Tensor:
    """RaGAN: relativistic average BCE, both directions halved; the logits'
    averages are over every rank of ``mesh``."""
    if not for_discriminator:
        real_pred, fake_pred = fake_pred, real_pred
    fake_mean, real_mean = batch_means([fake_pred, real_pred], mesh)
    return (_bce_with_logits(real_pred - fake_mean, torch.ones_like(real_pred))
            + _bce_with_logits(fake_pred - real_mean, torch.zeros_like(fake_pred))) / 2


def gram_matrix(feats: torch.Tensor) -> torch.Tensor:
    """NHWC features -> (B, C, C) Gram normalised by C*H*W (reference)."""
    b, h, w, c = feats.shape
    f = feats.reshape(b, h * w, c)
    return torch.einsum("bnc,bnd->bcd", f, f) / (c * h * w)


def texture_loss(pred_feats: torch.Tensor, target_feats: torch.Tensor) -> torch.Tensor:
    """MSE of Gram matrices; the target side is detached."""
    return mse_loss(gram_matrix(pred_feats), gram_matrix(target_feats.detach()))


@dataclasses.dataclass(frozen=True)
class CombinedGANLoss:
    """Generator loss: pixel + perceptual + adversarial (+ texture).

    ``vgg_apply(x) -> features`` is the perceptual feature function; None
    disables the perceptual term. ``mesh``: the ranks RaGAN averages over.
    """

    gan_type: str = "ragan"
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    adversarial_weight: float = 0.005
    texture_weight: float = 0.0
    vgg_apply: Optional[Callable] = None
    texture_vgg_apply: Optional[Callable] = None
    mesh: Optional[Mesh] = None

    def __call__(self, pred, target, real_pred=None, fake_pred=None):
        losses: dict[str, torch.Tensor] = {"pixel": l1_loss(pred, target) * self.pixel_weight}
        if self.vgg_apply is not None and self.perceptual_weight:
            pf = self.vgg_apply(pred)
            with torch.no_grad():
                tf = self.vgg_apply(target)
            losses["perceptual"] = l1_loss(pf, tf) * self.perceptual_weight
        if self.texture_vgg_apply is not None and self.texture_weight:
            losses["texture"] = texture_loss(self.texture_vgg_apply(pred),
                                             self.texture_vgg_apply(target)) * self.texture_weight
        if fake_pred is not None:
            if self.gan_type == "ragan" and real_pred is not None:
                adv = relative_gan_loss(real_pred, fake_pred, for_discriminator=False,
                                        mesh=self.mesh)
            else:
                adv = gan_loss(fake_pred, True, self.gan_type)
            losses["adversarial"] = adv * self.adversarial_weight
        total = sum(losses.values())
        losses["total"] = total
        return total, losses


@dataclasses.dataclass(frozen=True)
class DiscriminatorLoss:
    gan_type: str = "ragan"
    mesh: Optional[Mesh] = None

    def __call__(self, real_pred, fake_pred):
        if self.gan_type == "ragan":
            adv = relative_gan_loss(real_pred, fake_pred, for_discriminator=True,
                                    mesh=self.mesh)
        else:
            adv = (gan_loss(real_pred, True, self.gan_type)
                   + gan_loss(fake_pred, False, self.gan_type)) / 2
        return adv, {"adversarial": adv, "total": adv}
