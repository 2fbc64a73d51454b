"""Shared building blocks with the JAX ``models/layers.py`` numerics.

Layers are ``nn.Conv2d``, ``nn.Linear`` and ``nn.LayerNorm(eps=1e-5)``.
Initialisation reproduces torch's defaults, drawn from an explicit
``torch.Generator``: weights and biases U(+-1/sqrt(fan_in)), the
relative-position tables trunc-normal(0.02) cut at two standard deviations.
GELU is the exact erf form (``nn.GELU``'s default); the LeakyReLU slope
before the upsampler is 0.01.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU."""
    return F.gelu(x, approximate="none")


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv (or conv stack) to an NHWC tensor through permuted views."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def attention(q, k, v, bias, mask=None):
    """Softmax attention of (Bw, heads, Nq, d) queries, already scaled, with
    an additive (heads, Nq, Nk) bias and an optional (nW, Nq, Nk) mask tiled
    over the batch of windows; softmax in fp32, the rest in q's dtype."""
    attn = q @ k.transpose(-1, -2) + bias.to(q.dtype)
    if mask is not None:
        bw, h, n, m = attn.shape
        nw = mask.shape[0]
        attn = (attn.reshape(bw // nw, nw, h, n, m) + mask.to(q.dtype)[None, :, None]).reshape(
            bw, h, n, m)
    return torch.softmax(attn.float(), dim=-1).to(q.dtype) @ v


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
