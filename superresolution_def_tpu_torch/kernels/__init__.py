from .fused_hat import (
    make_fused_hat,
    make_fused_hat_train,
    make_fused_hybrid,
    make_fused_hybrid_train,
)
from .fused_rdb import fused_rdb, fused_rrdb_trunk, rdb_nhwc_reference
from .fused_rdb_cm import fused_rdb_cm, fused_rrdb_trunk_cm, rdb_cm_reference
from .fused_rdb_cm_bwd import (
    DenseBlockFn,
    fused_rdb_cm_bwd,
    fused_rrdb_trunk_cm_ad,
    rdb_cm_bwd_reference,
)
from .hab_block import fused_hab_block, hab_block_reference, hab_fwd_h_reference
from .hab_train import (
    HabCoreFn,
    hab_bwd_attn,
    hab_bwd_attn_reference,
    hab_bwd_mlp,
    hab_bwd_mlp_reference,
    hab_fwd_h,
)
from .ocab import fused_ocab_block, ocab_block_reference, ocab_fwd_h_reference
from .ocab_train import (
    OcabTailFn,
    ocab_bwd_attn,
    ocab_bwd_attn_reference,
    ocab_fwd_h,
    ocab_train,
)
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
from .window_attention import (
    window_attention,
    window_attention_masked,
    window_attention_nomask,
    window_attention_reference,
)

__all__ = [
    "DenseBlockFn",
    "FusedSwinBlockFn",
    "HabCoreFn",
    "OcabTailFn",
    "fused_hab_block",
    "fused_ocab_block",
    "fused_rdb",
    "fused_rdb_cm",
    "fused_rdb_cm_bwd",
    "fused_rrdb_trunk",
    "fused_rrdb_trunk_cm",
    "fused_rrdb_trunk_cm_ad",
    "fused_swin_block",
    "hab_block_reference",
    "hab_bwd_attn",
    "hab_bwd_attn_reference",
    "hab_bwd_mlp",
    "hab_bwd_mlp_reference",
    "hab_fwd_h",
    "hab_fwd_h_reference",
    "make_fused_hat",
    "make_fused_hat_train",
    "make_fused_hybrid",
    "make_fused_hybrid_train",
    "make_fused_swinir",
    "ocab_block_reference",
    "ocab_bwd_attn",
    "ocab_bwd_attn_reference",
    "ocab_fwd_h",
    "ocab_fwd_h_reference",
    "ocab_train",
    "rdb_cm_bwd_reference",
    "rdb_cm_reference",
    "rdb_nhwc_reference",
    "swin_block_bwd_attn",
    "swin_block_bwd_attn_reference",
    "swin_block_bwd_mlp",
    "swin_block_bwd_mlp_reference",
    "swin_block_fwd_h",
    "swin_block_fwd_h_reference",
    "swin_block_reference",
    "window_attention",
    "window_attention_masked",
    "window_attention_nomask",
    "window_attention_reference",
]
