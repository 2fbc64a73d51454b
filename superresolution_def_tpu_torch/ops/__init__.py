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
from .pixelshuffle import pixel_shuffle, pixel_unshuffle
from .padding import reflect_pad_2d
from .metrics import psnr, ssim, TrainMetrics, gaussian_window
from .resize import interpolate_bilinear, interpolate_nearest, resize_nearest
from .normalize import log_stretch_normalize, robust_minmax, quantize_u16

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
    "pixel_unshuffle",
    "reflect_pad_2d",
    "psnr",
    "ssim",
    "TrainMetrics",
    "gaussian_window",
    "interpolate_bilinear",
    "interpolate_nearest",
    "resize_nearest",
    "log_stretch_normalize",
    "robust_minmax",
    "quantize_u16",
]
