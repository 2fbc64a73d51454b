"""LR schedules matching torch.optim.lr_scheduler semantics (the JAX ``train/schedule.py``).

Both trainers step CosineAnnealingLR once per epoch with T_max=300 and
eta_min=1e-7 (train_swin.py:163-164, train_hat.py:180-182). torch's closed
form for a fresh scheduler is

    lr(e) = eta_min + (base_lr - eta_min) * (1 + cos(pi * e / T_max)) / 2

where e counts completed scheduler steps (epoch-1 during epoch `epoch`).
"""

from __future__ import annotations

import math


def cosine_annealing_lr(
    epoch: int, base_lr: float = 1e-4, t_max: int = 300, eta_min: float = 1e-7
) -> float:
    """LR used during 1-indexed ``epoch`` (scheduler stepped epoch-1 times)."""
    e = max(0, epoch - 1)
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * e / t_max)) / 2
