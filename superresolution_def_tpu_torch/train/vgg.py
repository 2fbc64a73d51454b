"""VGG19 feature extractor for the perceptual loss (the JAX ``train/vgg.py``).

The reference's VGGLoss builds torchvision ``vgg19.features[:feature_layer+1]``
with feature_layer=35 (through relu5_4), utils/losses_train_swin.py:6-40.
Inputs are grayscale repeated to 3 channels, then ImageNet-normalised.
``features.{i}`` keeps torchvision's indices, so a torchvision state dict
loads as it is, and ``models.weights.vgg19_state_dict_from_jax`` turns the
JAX package's parameters (or its npz) into this module's state dict;
:func:`vgg19_from_torch` goes the other way, to the parameters that the JAX
package's npz holds (``cli/port_vgg.py`` writes it). Without
weights the parameters are drawn from an explicit generator (a random-feature
perceptual loss, as the JAX package's seeded fallback).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import checkpoint_call, reset_torch_default_

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    """features[:cutoff+1] of VGG19, NHWC in and out; cutoff=35 is the reference VGGLoss.

    ``dtype`` casts the input and the weights of every conv, as the JAX
    module's ``dtype`` does (parameters stay fp32). ``forward(x, remat=True)``
    runs each block up to and with its max-pool as one rematerialized region
    (the JAX ``vgg_block`` boundaries, ``train/steps.py``'s ``remat_loss``):
    the backward keeps the pooled outputs and recomputes each block's convs.
    """

    def __init__(self, cutoff: int = 35, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        cin = 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers[: cutoff + 1])
        reset_torch_default_(self, generator or torch.Generator().manual_seed(0))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD), persistent=False)

    def blocks(self) -> list[tuple[int, int]]:
        """``features`` index ranges [lo, hi) of the blocks, each ending after its max-pool."""
        ends = [i + 1 for i, m in enumerate(self.features) if isinstance(m, nn.MaxPool2d)]
        ends += [len(self.features)] if not ends or ends[-1] < len(self.features) else []
        return list(zip([0] + ends[:-1], ends))

    def _block(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        if lo == 0:
            if x.shape[-1] == 1:
                x = x.repeat(1, 1, 1, 3)
            x = ((x - self.mean) / self.std).to(self.dtype).permute(0, 3, 1, 2)
        for m in self.features[lo:hi]:
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, m.weight.to(self.dtype), m.bias.to(self.dtype), padding=1)
            else:
                x = m(x)
        return x

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        for lo, hi in self.blocks():
            x = checkpoint_call(self._block, x, lo, hi) if remat else self._block(x, lo, hi)
        return x.permute(0, 2, 3, 1)


def _conv_indices(cutoff: int) -> list[int]:
    """``features`` indices of the convs in ``features[:cutoff+1]``."""
    out, idx = [], 0
    for v in _CFG:
        if v != "M":
            out.append(idx)
        idx += 1 if v == "M" else 2  # a conv is followed by its ReLU
    return [i for i in out if i <= cutoff]


def vgg19_from_torch(sd, cutoff: int = 35) -> dict:
    """A torchvision vgg19 state dict (``features.{i}.weight``) -> the JAX
    ``VGG19Features`` params: ``conv_{i}`` with an HWIO ``kernel`` and a
    ``bias``, numpy arrays (the JAX ``train/vgg.py::vgg19_from_torch``)."""

    def _np(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    return {f"conv_{i}": {"kernel": _np(sd[f"features.{i}.weight"]).transpose(2, 3, 1, 0),
                          "bias": _np(sd[f"features.{i}.bias"])}
            for i in _conv_indices(cutoff)}


def init_vgg_params(cutoff: int = 35, seed: int = 0) -> dict[str, torch.Tensor]:
    """The seeded fall-back weights (a random-feature perceptual loss): the
    state dict of a :class:`VGG19Features` drawn from a generator seeded ``seed``."""
    return VGG19Features(cutoff, generator=torch.Generator().manual_seed(seed)).state_dict()
