"""U-Net discriminators with spectral norm, both variants (the JAX ``models/discriminators.py``).

UNetDiscriminatorSNSwin (models/discriminator_swin.py:6-84): every conv
spectral-normalised, ConvTranspose upsampling, a bilinear
(align_corners=True) size fix when a skip's size differs, channel CONCAT
skips, LeakyReLU 0.2. NHWC in and out.

UNetDiscriminatorSNHAT (models/discriminator_hat.py:8-50, Real-ESRGAN
style): plain conv0 and conv9 with bias, spectral-normalised convs without
bias elsewhere, bilinear (align_corners=False) x2 upsampling, ADDITIVE
skips. Its keys are ``conv0.*``, ``conv{1-8}.weight_orig/_u/_v`` and
``conv9.*``, as ``torch_port.discriminator_hat_from_torch`` reads them.

Submodules carry the reference's state-dict keys (``conv0.0``, ``conv0.2``,
``conv{1-4}.model.0``, ``up{1-4}.model.0``, ``final_conv.0``,
``final_conv.2``), so ``torch_port.discriminator_swin_from_torch`` maps this
module's ``state_dict`` onto the JAX parameters. ``dtype`` casts x and w/sigma
as the JAX ``dtype`` attribute does; ``update_stats`` advances every
spectral power iteration, as a torch training-mode forward does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import interpolate_bilinear
from .layers import reset_torch_default_
from .spectral_norm import SNConv2d


class _Stage(nn.Module):
    """A ``model`` Sequential holding one SN conv and its activation (reference layout)."""

    def __init__(self, conv: SNConv2d):
        super().__init__()
        self.model = nn.Sequential(conv, nn.LeakyReLU(0.2))


class UNetDiscriminatorSNSwin(nn.Module):
    def __init__(self, num_in_ch: int = 1, num_feat: int = 64, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        nf = num_feat
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def sn(i, o, k, s, p, tr=False):
            return SNConv2d(i, o, k, s, p, transpose=tr, generator=generator)

        self.conv0 = nn.Sequential(sn(num_in_ch, nf, 3, 1, 1), nn.LeakyReLU(0.2),
                                   sn(nf, nf, 4, 2, 1))
        for i, (cin, cout) in enumerate([(nf, 2 * nf), (2 * nf, 4 * nf), (4 * nf, 8 * nf),
                                         (8 * nf, 8 * nf)], 1):
            setattr(self, f"conv{i}", _Stage(sn(cin, cout, 4, 2, 1)))
        for i, (cin, cout) in enumerate([(8 * nf, 8 * nf), (16 * nf, 4 * nf), (8 * nf, 2 * nf),
                                         (4 * nf, nf)], 1):
            setattr(self, f"up{i}", _Stage(sn(cin, cout, 4, 2, 1, tr=True)))
        self.final_conv = nn.Sequential(sn(2 * nf, nf, 3, 1, 1), nn.LeakyReLU(0.2),
                                        sn(nf, 1, 3, 1, 1))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        def lr(t):
            return F.leaky_relu(t, 0.2)

        def sn(conv, t):
            return conv(t, update_stats, self.dtype)

        x0 = lr(sn(self.conv0[0], x))
        x0 = lr(sn(self.conv0[2], x0))
        x1 = lr(sn(self.conv1.model[0], x0))
        x2 = lr(sn(self.conv2.model[0], x1))
        x3 = lr(sn(self.conv3.model[0], x2))
        x4 = lr(sn(self.conv4.model[0], x3))

        def up(stage, feat, skip):
            y = lr(sn(stage.model[0], feat))
            if y.shape[1:3] != skip.shape[1:3]:
                y = interpolate_bilinear(y, tuple(skip.shape[1:3]), align_corners=True)
            return torch.cat([y, skip], dim=-1)

        d1 = up(self.up1, x4, x3)
        d2 = up(self.up2, d1, x2)
        d3 = up(self.up3, d2, x1)
        d4 = up(self.up4, d3, x0)
        out = lr(sn(self.final_conv[0], d4))
        return sn(self.final_conv[2], out)


class UNetDiscriminatorSNHAT(nn.Module):
    def __init__(self, num_in_ch: int = 1, num_feat: int = 64, skip_connection: bool = True, *,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        nf = num_feat
        self.dtype = dtype
        self.skip_connection = skip_connection
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.conv0 = nn.Conv2d(num_in_ch, nf, 3, 1, 1)
        reset_torch_default_(self.conv0, generator)
        for i, (cin, cout, k, s) in enumerate(
                [(nf, 2 * nf, 4, 2), (2 * nf, 4 * nf, 4, 2), (4 * nf, 8 * nf, 4, 2),
                 (8 * nf, 4 * nf, 3, 1), (4 * nf, 2 * nf, 3, 1), (2 * nf, nf, 3, 1),
                 (nf, nf, 3, 1), (nf, nf, 3, 1)], 1):
            setattr(self, f"conv{i}", SNConv2d(cin, cout, k, s, 1, generator=generator))
        self.conv9 = nn.Conv2d(nf, 1, 3, 1, 1)
        reset_torch_default_(self.conv9, generator)

    def _plain(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                     padding=1)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        def lr(t):
            return F.leaky_relu(t, 0.2)

        def sn(i, t):
            return getattr(self, f"conv{i}")(t, update_stats, self.dtype)

        def up(t):
            return interpolate_bilinear(t, (t.shape[1] * 2, t.shape[2] * 2), align_corners=False)

        x0 = lr(self._plain(self.conv0, x))
        x1 = lr(sn(1, x0))
        x2 = lr(sn(2, x1))
        x3 = lr(sn(3, x2))
        x4 = lr(sn(4, up(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lr(sn(5, up(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lr(sn(6, up(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = lr(sn(7, x6))
        out = lr(sn(8, out))
        return self._plain(self.conv9, out)
