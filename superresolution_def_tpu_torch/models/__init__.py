from .discriminators import UNetDiscriminatorSNSwin
from .spectral_norm import SNConv2d
from .swinir import SwinIR, SwinTransformerBlock, WindowAttention
from .weights import (
    detect_swinir_params,
    discriminator_swin_state_dict_from_jax,
    vgg19_state_dict_from_jax,
    load_torch_state_dict,
    swinir_state_dict_from_jax,
    unwrap_state_dict,
)

__all__ = [
    "SNConv2d",
    "UNetDiscriminatorSNSwin",
    "discriminator_swin_state_dict_from_jax",
    "vgg19_state_dict_from_jax",
    "SwinIR",
    "SwinTransformerBlock",
    "WindowAttention",
    "detect_swinir_params",
    "load_torch_state_dict",
    "swinir_state_dict_from_jax",
    "unwrap_state_dict",
]
