"""EMA of generator parameters (the JAX ``train/ema.py``).

Reference semantics (train_swin.py:45-74 ModelEMA): shadow = decay * shadow +
(1 - decay) * param, decay 0.999, updated once per optimizer step (i.e. per
accumulation window). The swin trainer validates and saves 'best' from the
EMA shadow.
"""

from __future__ import annotations

import copy

import torch

EMA_DECAY = 0.999


def ema_init(model: torch.nn.Module) -> torch.nn.Module:
    """The shadow: a copy of ``model`` (never an alias of its parameters)
    that takes no gradient."""
    return copy.deepcopy(model).requires_grad_(False)


@torch.no_grad()
def ema_update(shadow: torch.nn.Module, model: torch.nn.Module, decay: float = EMA_DECAY) -> None:
    """shadow <- decay * shadow + (1 - decay) * model, IN PLACE on ``shadow``'s
    parameters (the JAX version returns a new tree; updating in place keeps
    one copy of the shadow on the card)."""
    s = list(shadow.parameters())
    p = list(model.parameters())
    # lerp: s + (1 - decay) * (p - s), the same update in one fused op
    torch._foreach_lerp_(s, p, 1.0 - decay)
