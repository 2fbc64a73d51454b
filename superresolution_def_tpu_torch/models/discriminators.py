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

``remat`` (the JAX ``remat_loss``'s ``d_stage`` boundaries,
``train/steps.py``) runs each stage between two boundaries as one
rematerialized region (:func:`~.layers.checkpoint_call`): the backward keeps
the boundaries and recomputes each stage's interior (the leaky-relu and
conv temporaries). Every power iteration of the forward runs first, outside
the regions, and each region takes its convs' (u, v) as inputs, so a
recompute divides by the forward's sigma even after later forwards have
advanced the buffers: the iteration runs once a forward, remat or not.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import interpolate_bilinear
from .layers import checkpoint_call, reset_torch_default_
from .spectral_norm import SNConv2d


def _lrelu(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, 0.2)


def _spectral(convs: list[SNConv2d], update_stats: bool) -> list[torch.Tensor]:
    """Each conv's (u, v), flat, after its power iteration when ``update_stats``."""
    if update_stats:
        for c in convs:
            c.power_iteration()
    return [t for c in convs for t in (c.weight_u, c.weight_v)]


def _stage(remat: bool):
    """How a forward runs a stage ``fn(*args)``: one region, or a plain call."""
    return checkpoint_call if remat else lambda fn, *args: fn(*args)


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

    def sn_convs(self) -> list[SNConv2d]:
        """The spectral convs in forward order."""
        return [self.conv0[0], self.conv0[2],
                *(getattr(self, f"conv{i}").model[0] for i in range(1, 5)),
                *(getattr(self, f"up{i}").model[0] for i in range(1, 5)),
                self.final_conv[0], self.final_conv[2]]

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                remat: bool = False) -> torch.Tensor:
        """Boundaries under ``remat``: x0..x4 and the up-stages' concatenations
        (the JAX ``d_stage`` tags); the concatenations run outside the regions."""
        convs = self.sn_convs()
        uv = _spectral(convs, update_stats)
        stage = _stage(remat)

        def chain(lo, hi, act_last=True):
            """convs[lo:hi], each but an un-activated last one followed by the leaky relu."""
            def run(t, *vecs):
                for j, conv in enumerate(convs[lo:hi]):
                    t = conv.conv(t, vecs[2 * j], vecs[2 * j + 1], self.dtype)
                    if act_last or j < hi - lo - 1:
                        t = _lrelu(t)
                return t
            return lambda t: stage(run, t, *uv[2 * lo:2 * hi])

        feats = [chain(0, 2)(x)]  # x0
        for i in range(2, 6):  # x1..x4
            feats.append(chain(i, i + 1)(feats[-1]))
        d = feats[-1]
        for i, skip in zip(range(6, 10), feats[3::-1]):
            y = chain(i, i + 1)(d)
            if y.shape[1:3] != skip.shape[1:3]:
                y = interpolate_bilinear(y, tuple(skip.shape[1:3]), align_corners=True)
            d = torch.cat([y, skip], dim=-1)
        return chain(10, 12, act_last=False)(d)


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

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                remat: bool = False) -> torch.Tensor:
        """Boundaries under ``remat``: x1..x6 (the JAX ``d_stage`` tags; the
        skip sums run outside the regions). The full-resolution x0 and the
        conv7 and conv8 outputs are not kept: x0 comes out of the first
        region beside x1 and feeds only the last skip sum, which saves
        nothing, and conv7/conv8 are the interior of the last region."""
        convs = [getattr(self, f"conv{i}") for i in range(1, 9)]
        uv = _spectral(convs, update_stats)
        stage = _stage(remat)
        dt = self.dtype

        def sn(i, t, vecs, up=False):
            if up:
                t = interpolate_bilinear(t, (t.shape[1] * 2, t.shape[2] * 2),
                                         align_corners=False)
            return _lrelu(convs[i - 1].conv(t, *vecs, dt))

        def first(t, u1, v1):
            x0 = _lrelu(self._plain(self.conv0, t))
            return x0, sn(1, x0, (u1, v1))

        def one(i, up=False):
            return lambda t, u, v: sn(i, t, (u, v), up)

        def last(t, u7, v7, u8, v8):
            return self._plain(self.conv9, sn(8, sn(7, t, (u7, v7)), (u8, v8)))

        def vecs(*idx):
            return [t for i in idx for t in uv[2 * (i - 1):2 * i]]

        x0, x1 = stage(first, x, *vecs(1))
        x2 = stage(one(2), x1, *vecs(2))
        x3 = stage(one(3), x2, *vecs(3))
        x4 = stage(one(4, up=True), x3, *vecs(4))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = stage(one(5, up=True), x4, *vecs(5))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = stage(one(6, up=True), x5, *vecs(6))
        if self.skip_connection:
            x6 = x6 + x0
        return stage(last, x6, *vecs(7, 8))
