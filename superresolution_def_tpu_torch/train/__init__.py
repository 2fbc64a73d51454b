from .ema import EMA_DECAY, ema_update
from .losses import (
    CombinedGANLoss,
    DiscriminatorLoss,
    charbonnier_loss,
    gan_loss,
    gram_matrix,
    l1_loss,
    relative_gan_loss,
    texture_loss,
)
from .schedule import cosine_annealing_lr
from .state import HATTrainState, SwinTrainState, create_hat_train_state, create_swin_train_state
from .steps import HAT_METRICS, make_eval_step, make_hat_train_step, make_swin_train_step
from .vgg import VGG19Features

__all__ = [
    "EMA_DECAY",
    "ema_update",
    "CombinedGANLoss",
    "DiscriminatorLoss",
    "charbonnier_loss",
    "gan_loss",
    "gram_matrix",
    "l1_loss",
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
]
