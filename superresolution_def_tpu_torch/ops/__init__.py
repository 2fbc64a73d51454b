from .windows import (
    window_partition,
    window_reverse,
    relative_position_index_sa,
    relative_position_bias,
    relative_position_index_oca,
    relative_position_bias_oca,
    shift_mask,
    shift_window_attn_mask,
    overlap_windows,
)
from .pixelshuffle import pixel_shuffle
from .padding import reflect_pad_2d
from .metrics import psnr, ssim, TrainMetrics
from .resize import interpolate_bilinear, resize_nearest

__all__ = [
    "window_partition",
    "window_reverse",
    "relative_position_index_sa",
    "relative_position_bias",
    "relative_position_index_oca",
    "relative_position_bias_oca",
    "shift_mask",
    "shift_window_attn_mask",
    "overlap_windows",
    "pixel_shuffle",
    "reflect_pad_2d",
    "psnr",
    "ssim",
    "TrainMetrics",
    "interpolate_bilinear",
    "resize_nearest",
]
