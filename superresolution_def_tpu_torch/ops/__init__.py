from .windows import (
    window_partition,
    window_reverse,
    relative_position_index_sa,
    relative_position_bias,
)
from .pixelshuffle import pixel_shuffle
from .padding import reflect_pad_2d
from .metrics import psnr, ssim, TrainMetrics
from .resize import interpolate_bilinear

__all__ = [
    "window_partition",
    "window_reverse",
    "relative_position_index_sa",
    "relative_position_bias",
    "pixel_shuffle",
    "reflect_pad_2d",
    "psnr",
    "ssim",
    "TrainMetrics",
    "interpolate_bilinear",
]
