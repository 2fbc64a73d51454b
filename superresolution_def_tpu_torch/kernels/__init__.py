from .swin_block import fused_swin_block, make_fused_swinir, swin_block_reference

__all__ = ["fused_swin_block", "make_fused_swinir", "swin_block_reference"]
