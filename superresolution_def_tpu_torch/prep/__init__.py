"""Dataset prep, steps 1-4 and the split (the JAX ``prep`` package).

FITS/WCS handling is numpy; every reprojection, percentile and
normalization runs on a ``device`` argument, the card unless the caller
asks for the CPU. Step 2 and the staged path's debug cards import
matplotlib when they draw.
"""

from .fits import read_fits, write_fits, FITSImage
from .wcs import TanWCS, angular_separation_deg
from .reproject import reproject_bilinear, reproject_batch
from .astap import find_astap_path, solve_with_astap
from .register import process_step1_folder, main_registration, extract_wcs_info
from .mosaic import mosaic_check
from .patches import extract_patches, calculate_stride_for_target
from .normalize_pipeline import calculate_robust_stats, normalize_target
from .fused import fused_prep_target
from .splits import prepare_full_dataset
from .logging_util import make_prep_logger

__all__ = [
    "read_fits",
    "write_fits",
    "FITSImage",
    "TanWCS",
    "angular_separation_deg",
    "reproject_bilinear",
    "reproject_batch",
    "find_astap_path",
    "solve_with_astap",
    "process_step1_folder",
    "main_registration",
    "extract_wcs_info",
    "mosaic_check",
    "extract_patches",
    "calculate_stride_for_target",
    "calculate_robust_stats",
    "normalize_target",
    "fused_prep_target",
    "prepare_full_dataset",
    "make_prep_logger",
]
