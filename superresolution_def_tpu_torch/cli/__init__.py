from .trainers import HATTrainConfig, SwinTrainConfig, train_hat_run, train_swin_run

__all__ = ["SwinTrainConfig", "HATTrainConfig", "train_swin_run", "train_hat_run"]
