"""Shared building blocks with the JAX ``models/layers.py`` numerics.

Layers are ``nn.Conv2d``, ``nn.Linear`` and ``nn.LayerNorm(eps=1e-5)``.
Initialisation reproduces torch's defaults, drawn from an explicit
``torch.Generator``: weights and biases U(+-1/sqrt(fan_in)), the
relative-position tables trunc-normal(0.02) cut at two standard deviations.
GELU is the exact erf form (``nn.GELU``'s default); the LeakyReLU slope
before the upsampler is 0.01.

:func:`checkpoint_call` and :func:`checkpoint_module` are the JAX package's
``jax.checkpoint`` / ``nn.remat`` regions: ``torch.utils.checkpoint``
without reentrance, only when grad is enabled.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU."""
    return F.gelu(x, approximate="none")


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv (or conv stack) to an NHWC tensor through permuted views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def checkpoint_call(fn: Callable, *args, context_fn: Callable | None = None,
                    preserve_rng_state: bool = False):
    """``fn(*args)`` as one rematerialized region: the backward keeps its
    inputs and recomputes what its ops saved when it needs them
    (``torch.utils.checkpoint``, ``use_reentrant=False``: the forward's
    autograd graph, so the gradients are those of the plain call when the
    recompute gives the forward's bits). A plain call when grad is disabled.
    ``context_fn`` as ``checkpoint``'s: called at the forward, it returns the
    forward's and the recompute's context managers. An error in the region
    or its recompute raises."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=preserve_rng_state,
                      **kwargs)


def checkpoint_module(module: nn.Module, *args, context_fn: Callable | None = None):
    """``module(*args)`` as one region (``nn.remat`` of a flax module). Its
    parameters are taken as they are at the forward and passed into the
    region: inside ``functional_call`` (a forward in the compute dtype)
    they are the casts, which the recompute, run in the backward after
    ``functional_call`` has put the fp32 masters back, must use again."""
    params = dict(module.named_parameters())
    return checkpoint_call(lambda p, *a: functional_call(module, p, a), params, *args,
                           context_fn=context_fn, preserve_rng_state=True)


@torch.no_grad()
def reset_torch_default_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Conv2d/Linear of ``module`` as torch's default init does."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (the JAX package's table init)."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (the reference's dropout rates are all 0)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))
