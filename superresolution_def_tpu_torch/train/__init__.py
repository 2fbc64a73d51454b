"""Losses, VGG19 features, EMA, the LR schedule, train states and steps (the JAX ``train/``).

The JAX package's one ``GANTrainState`` pytree has two counterparts here,
:class:`SwinTrainState` and :class:`HATTrainState`: each holds its
generator, discriminator, both AdamW optimizers and the EMA copy as
``nn.Module``s and ``torch.optim`` objects, which its train step updates in place.
"""

from .ema import EMA_DECAY, ema_init, ema_update
from .losses import (
    CombinedGANLoss,
    DiscriminatorLoss,
    charbonnier_loss,
    gan_loss,
    gram_matrix,
    l1_loss,
    mse_loss,
    relative_gan_loss,
    texture_loss,
)
from .schedule import cosine_annealing_lr
from .state import HATTrainState, SwinTrainState, create_hat_train_state, create_swin_train_state
from .steps import HAT_METRICS, make_eval_step, make_hat_train_step, make_swin_train_step
from .vgg import VGG19Features, init_vgg_params, vgg19_from_torch

__all__ = [
    "EMA_DECAY",
    "ema_init",
    "ema_update",
    "CombinedGANLoss",
    "DiscriminatorLoss",
    "charbonnier_loss",
    "gan_loss",
    "gram_matrix",
    "l1_loss",
    "mse_loss",
    "relative_gan_loss",
    "texture_loss",
    "cosine_annealing_lr",
    "HAT_METRICS",
    "HATTrainState",
    "SwinTrainState",
    "create_hat_train_state",
    "create_swin_train_state",
    "make_eval_step",
    "make_hat_train_step",
    "make_swin_train_step",
    "VGG19Features",
    "init_vgg_params",
    "vgg19_from_torch",
]
