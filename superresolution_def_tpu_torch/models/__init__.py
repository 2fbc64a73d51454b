from .swinir import SwinIR, SwinTransformerBlock, WindowAttention
from .weights import (
    detect_swinir_params,
    load_torch_state_dict,
    swinir_state_dict_from_jax,
    unwrap_state_dict,
)

__all__ = [
    "SwinIR",
    "SwinTransformerBlock",
    "WindowAttention",
    "detect_swinir_params",
    "load_torch_state_dict",
    "swinir_state_dict_from_jax",
    "unwrap_state_dict",
]
