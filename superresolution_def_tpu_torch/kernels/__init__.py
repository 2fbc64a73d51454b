from .swin_block import (
    FusedSwinBlockFn,
    fused_swin_block,
    make_fused_swinir,
    swin_block_bwd_attn,
    swin_block_bwd_attn_reference,
    swin_block_bwd_mlp,
    swin_block_bwd_mlp_reference,
    swin_block_fwd_h,
    swin_block_fwd_h_reference,
    swin_block_reference,
)

__all__ = [
    "FusedSwinBlockFn",
    "fused_swin_block",
    "make_fused_swinir",
    "swin_block_bwd_attn",
    "swin_block_bwd_attn_reference",
    "swin_block_bwd_mlp",
    "swin_block_bwd_mlp_reference",
    "swin_block_fwd_h",
    "swin_block_fwd_h_reference",
    "swin_block_reference",
]
