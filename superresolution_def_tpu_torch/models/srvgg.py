"""SRVGGNetCompact, the compact VGG-style SR net of the Real-ESRGAN family (the JAX ``models/srvgg.py``).

models/hat_arch/srvgg_arch.py:7-69: a 3x3 conv and its activation, then
``num_conv`` (3x3 conv + activation), a conv to ``num_out_ch * upscale**2``
channels, pixel-shuffle, plus the nearest-upsampled input. The reference's
arch registry holds it and no trainer uses it; it is here for the same
availability. NHWC in and out, as the port's other generators; ``body``
keeps the reference's ``nn.ModuleList`` indices (``body.{2i}`` the convs,
``body.{2i+1}`` the activations, a PReLU's slopes as ``body.{2i+1}.weight``),
so ``torch_port.srvgg_from_torch`` maps its ``state_dict`` into the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import reset_torch_default_


def _activation(act_type: str, num_feat: int) -> nn.Module:
    if act_type == "relu":
        return nn.ReLU()
    if act_type == "leakyrelu":
        return nn.LeakyReLU(0.1)
    if act_type == "prelu":
        return nn.PReLU(num_parameters=num_feat, init=0.25)  # per channel
    raise ValueError(f"act_type must be relu, leakyrelu or prelu, not {act_type!r}")


class SRVGGNetCompact(nn.Module):
    """x``upscale`` SR net, NHWC; parameters drawn from ``generator`` (a
    fresh one seeded 0 if None) as torch's default init draws them."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_conv: int = 16, upscale: int = 4, act_type: str = "prelu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.upscale = upscale
        body = [nn.Conv2d(num_in_ch, num_feat, 3, 1, 1), _activation(act_type, num_feat)]
        for _ in range(num_conv):
            body += [nn.Conv2d(num_feat, num_feat, 3, 1, 1), _activation(act_type, num_feat)]
        body.append(nn.Conv2d(num_feat, num_out_ch * upscale * upscale, 3, 1, 1))
        self.body = nn.ModuleList(body)
        reset_torch_default_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        out = x
        for m in self.body:
            out = m(out)
        out = F.pixel_shuffle(out, self.upscale)
        out = out + F.interpolate(x, scale_factor=self.upscale, mode="nearest")
        return out.permute(0, 2, 3, 1)
