from .discriminators import UNetDiscriminatorSNHAT, UNetDiscriminatorSNSwin
from .hat import DrawShard, DropPath, injected_drop_masks
from .hat import HAT
from .hybrid import HybridHATRealESRGAN
from .spectral_norm import SNConv2d
from .srvgg import SRVGGNetCompact
from .swinir import SwinIR, SwinTransformerBlock, WindowAttention
from .weights import (
    detect_hybrid_params,
    detect_swinir_params,
    discriminator_hat_state_dict_from_jax,
    discriminator_swin_state_dict_from_jax,
    hat_state_dict_from_jax,
    hybrid_state_dict_from_jax,
    srvgg_state_dict_from_jax,
    vgg19_state_dict_from_jax,
    load_torch_state_dict,
    swinir_state_dict_from_jax,
    unwrap_state_dict,
)

__all__ = [
    "DrawShard",
    "DropPath",
    "HAT",
    "HybridHATRealESRGAN",
    "detect_hybrid_params",
    "hat_state_dict_from_jax",
    "hybrid_state_dict_from_jax",
    "SNConv2d",
    "SRVGGNetCompact",
    "srvgg_state_dict_from_jax",
    "UNetDiscriminatorSNHAT",
    "UNetDiscriminatorSNSwin",
    "discriminator_hat_state_dict_from_jax",
    "discriminator_swin_state_dict_from_jax",
    "injected_drop_masks",
    "vgg19_state_dict_from_jax",
    "SwinIR",
    "SwinTransformerBlock",
    "WindowAttention",
    "detect_swinir_params",
    "load_torch_state_dict",
    "swinir_state_dict_from_jax",
    "unwrap_state_dict",
]
