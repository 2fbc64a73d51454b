from .fused_hat import make_fused_hat, make_fused_hybrid, make_fused_hybrid_train
from .fused_rdb_cm import fused_rdb_cm, fused_rrdb_trunk_cm, rdb_cm_reference
from .fused_rdb_cm_bwd import (
    DenseBlockFn,
    fused_rdb_cm_bwd,
    fused_rrdb_trunk_cm_ad,
    rdb_cm_bwd_reference,
)
from .hab_block import fused_hab_block, hab_block_reference
from .ocab import fused_ocab_block, ocab_block_reference
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
    "DenseBlockFn",
    "FusedSwinBlockFn",
    "fused_hab_block",
    "fused_ocab_block",
    "fused_rdb_cm",
    "fused_rdb_cm_bwd",
    "fused_rrdb_trunk_cm",
    "fused_rrdb_trunk_cm_ad",
    "fused_swin_block",
    "hab_block_reference",
    "make_fused_hat",
    "make_fused_hybrid",
    "make_fused_hybrid_train",
    "make_fused_swinir",
    "ocab_block_reference",
    "rdb_cm_bwd_reference",
    "rdb_cm_reference",
    "swin_block_bwd_attn",
    "swin_block_bwd_attn_reference",
    "swin_block_bwd_mlp",
    "swin_block_bwd_mlp_reference",
    "swin_block_fwd_h",
    "swin_block_fwd_h_reference",
    "swin_block_reference",
]
