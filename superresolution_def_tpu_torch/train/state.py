"""Train states of the SwinIR GAN and the HAT-Real hybrid GAN (the JAX ``train/state.py``).

One object holds what the reference spreads across DDP modules, optimizers
and ModelEMA (train_swin.py:147-169): the generator and discriminator
(fp32 master parameters), both AdamW optimizers, the EMA copy of the
generator and, inside the discriminator, its spectral (u, v) buffers.
Reference optimizer configs: AdamW(lr=1e-4, betas=(0.9, 0.99), eps=1e-8)
for G and D, with weight_decay 0 for swin (train_swin.py:160-161) and
torch's default 0.01 for hat (train_hat.py:152-153).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import functional_call

from ..kernels import make_fused_hybrid_train, make_fused_swinir
from ..models import (
    HybridHATRealESRGAN,
    SwinIR,
    UNetDiscriminatorSNHAT,
    UNetDiscriminatorSNSwin,
)
from .ema import ema_init


@dataclasses.dataclass
class SwinTrainState:
    g: SwinIR
    d: UNetDiscriminatorSNSwin
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    ema: SwinIR
    g_forward: Callable[[torch.Tensor], torch.Tensor]    # G's forward, in the compute dtype
    ema_forward: Callable[[torch.Tensor], torch.Tensor]  # the same for the EMA copy
    step: int = 0


def generator_forward(model: SwinIR, dtype: torch.dtype, fused: bool, backward: str = "split"):
    """NHWC forward of ``model`` computing in ``dtype`` with gradients reaching
    its fp32 parameters: the fused blocks (K2/K3/K4, K1 under no_grad; with
    ``backward="recompute"`` K1 and K4b) when ``fused``, else the
    ``nn.Module`` with its parameters cast inside autograd."""
    if fused:
        return make_fused_swinir(model, dtype=dtype, differentiable=True, backward=backward)
    if dtype == torch.float32:
        return model

    def forward(x):
        params = {k: v.to(dtype) for k, v in model.named_parameters()}
        return functional_call(model, params, (x.to(dtype),))

    return forward


def _adamw(module: torch.nn.Module, weight_decay: float = 0.0) -> torch.optim.AdamW:
    return torch.optim.AdamW(module.parameters(), lr=1e-4, betas=(0.9, 0.99), eps=1e-8,
                             weight_decay=weight_decay)


def create_swin_train_state(
    generator: torch.Generator,
    *,
    img_size: int = 128,
    upscale: int = 4,
    embed_dim: int = 180,
    depths=(6,) * 6,
    num_heads=(6,) * 6,
    window_size: int = 8,
    # reference-EFFECTIVE value: train_swin.py:149 passes 2 but the torch
    # constructor swallows it and blocks default to 4
    mlp_ratio: float = 4.0,
    dtype: torch.dtype = torch.float32,
    fused: bool = False,
    device: torch.device | str = "cuda",
    backward: str = "split",
) -> SwinTrainState:
    """Reference swin train config (train_swin.py:147-156), parameters drawn
    from ``generator`` (G first, then D).

    ``fused=True`` routes the generator's forward and backward through the
    fused-block kernels; on a CUDA device they take bf16 only, so fp32 with
    ``fused`` there raises. ``backward`` picks the generator's fused
    backward: ``"split"`` (K2 forward keeping h, K3 + K4) or ``"recompute"``
    (K1 forward keeping x only, K4b recomputing the forward).
    """
    device = torch.device(device)
    if fused and device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError("the fused generator runs in bfloat16 on CUDA; pass dtype=bfloat16")
    g = SwinIR(img_size=img_size, in_chans=1, embed_dim=embed_dim, depths=tuple(depths),
               num_heads=tuple(num_heads), window_size=window_size, mlp_ratio=mlp_ratio,
               upscale=upscale, generator=generator).to(device)
    d = UNetDiscriminatorSNSwin(num_in_ch=1, num_feat=64, dtype=dtype,
                                generator=generator).to(device)
    ema = ema_init(g)
    return SwinTrainState(
        g=g, d=d, g_opt=_adamw(g), d_opt=_adamw(d), ema=ema,
        g_forward=generator_forward(g, dtype, fused, backward),
        ema_forward=generator_forward(ema, dtype, fused),  # no_grad: K1 either way
    )


@dataclasses.dataclass
class HATTrainState:
    g: HybridHATRealESRGAN
    d: UNetDiscriminatorSNHAT
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    ema: HybridHATRealESRGAN
    # G's forward (x, deterministic, generator) in the compute dtype
    g_forward: Callable[..., torch.Tensor]
    step: int = 0


def hybrid_forward(model: HybridHATRealESRGAN, dtype: torch.dtype, fused: bool,
                   fused_hab: bool = False):
    """NHWC ``forward(x, deterministic=True, generator=None)`` of ``model``
    computing in ``dtype`` with gradients reaching its fp32 parameters: the
    RRDB trunk through K7/K8 when ``fused`` (:func:`make_fused_hybrid_train`),
    with ``fused_hab`` also the HAT backbone's HABs and OCAB tails through
    K9a-c and K10a-b, else the ``nn.Module`` with its parameters cast inside
    autograd."""
    if fused:
        return make_fused_hybrid_train(model, dtype=dtype, fused_hab=fused_hab)
    if dtype == torch.float32:
        return model

    def forward(x, deterministic=True, generator=None):
        params = {k: v.to(dtype) for k, v in model.named_parameters()}
        return functional_call(model, params, (x.to(dtype), deterministic, generator))

    return forward


def create_hat_train_state(
    generator: torch.Generator,
    *,
    img_size: int = 128,
    embed_dim: int = 90,
    depths=(6, 6, 6, 6),
    num_heads=(6, 6, 6, 6),
    window_size: int = 8,
    num_rrdb: int = 12,
    num_feat: int = 48,
    num_grow_ch: int = 24,
    dtype: torch.dtype = torch.float32,
    fused: bool = False,
    fused_hab: bool = False,
    drop_path_rate: float = 0.1,
    device: torch.device | str = "cuda",
) -> HATTrainState:
    """Reference 'Soft' hybrid config (train_hat.py:132-136), parameters
    drawn from ``generator`` (G first, then D); AdamW with weight decay 0.01.

    ``fused=True`` routes the RRDB trunk's forward and backward through the
    dense-block kernels (K7/K8) at every trunk width; the HAT backbone, the
    heads and D stay ``nn.Module``s, as the JAX fused state leaves them to
    XLA. ``fused_hab`` (with ``fused``) also routes the backbone's HABs and
    OCAB tails through their training kernels (K9a-c, K10a-b), the JAX
    package's opt-in ``fused_hab`` path. On a CUDA device the kernels take
    bf16 only, so fp32 with ``fused`` there raises; on the CPU the same
    structure runs through the kernels' plain versions.
    """
    device = torch.device(device)
    if fused_hab and not fused:
        raise ValueError("fused_hab routes the fused generator's backbone; pass fused=True")
    if fused and device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError("the fused trunk runs in bfloat16 on CUDA; pass dtype=bfloat16")
    g = HybridHATRealESRGAN(img_size=img_size, in_chans=1, embed_dim=embed_dim,
                            depths=tuple(depths), num_heads=tuple(num_heads),
                            window_size=window_size, num_rrdb=num_rrdb, num_feat=num_feat,
                            num_grow_ch=num_grow_ch, drop_path_rate=drop_path_rate,
                            generator=generator).to(device)
    d = UNetDiscriminatorSNHAT(num_in_ch=1, num_feat=64, dtype=dtype,
                               generator=generator).to(device)
    return HATTrainState(
        g=g, d=d, g_opt=_adamw(g, 0.01), d_opt=_adamw(d, 0.01),
        ema=ema_init(g),
        g_forward=hybrid_forward(g, dtype, fused, fused_hab),
    )
