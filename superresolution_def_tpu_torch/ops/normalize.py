"""Dataset normalization on tensors (the JAX ``ops/normalize.py``).

The reference's two-pass pipeline takes the P4.0 / P99.99 percentiles of
log1p-stretched valid pixels, then maps each image by log1p ->
(x - min) / (max - min + 1e-8) -> clip [0, 1] -> uint16
(misc/Dataset_step4_normalization.py:22-28, 51-93, 159-177).

Each function takes numpy arrays or tensors and runs on ``device`` (the
tensor's own when none is given). Percentiles are a sort of the masked
values, never ``torch.quantile``: that refuses more than 2**24 elements,
and one 4096² frame is already that many.
"""

from __future__ import annotations

import numpy as np
import torch

BLACK_CLIP_PERCENTILE = 4.0
WHITE_CLIP_PERCENTILE = 99.99
MIN_VALID_PIXEL = 1e-5


def as_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (``x``'s own device by default)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = torch.as_tensor(x, dtype=torch.float32)
    return x if device is None else x.to(device)


def log_stretch(x: torch.Tensor) -> torch.Tensor:
    """log1p(max(x, 0)) — the reference's USE_LOG_STRETCH path."""
    return torch.log1p(torch.clamp_min(x, 0.0))


def masked_percentiles(v: torch.Tensor, mask: torch.Tensor, pcts) -> list[torch.Tensor]:
    """np.percentile('linear') over ``v[mask]``, as 0-d tensors on ``v``'s device.

    The masked-out values sort to +inf; the position is (n - 1) * p / 100 in
    float32, as the JAX ``prep/fused.py::_masked_percentiles`` computes it
    (numpy's float64 position picks other interpolation points at millions
    of values), and nothing here waits for the device.
    """
    flat = torch.where(mask, v, torch.inf).reshape(-1)
    srt = torch.sort(flat).values
    n = mask.sum()
    last = flat.numel() - 1
    out = []
    for p in pcts:
        pos = (n - 1).to(torch.float32) * torch.tensor(p / 100.0, dtype=torch.float32,
                                                         device=v.device)
        lo_i = torch.floor(pos).to(torch.int64).clamp(0, last)
        hi_i = (lo_i + 1).clamp(0, last)
        frac = pos - lo_i.to(torch.float32)
        lo_v = srt.take(lo_i)  # take, not srt[i]: a 0-d tensor index waits for the device
        hi_v = torch.where(hi_i < n, srt.take(hi_i), lo_v)  # don't touch the infs
        out.append(lo_v + (hi_v - lo_v) * frac)
    return out


def robust_minmax(
    x,
    black_pct: float = BLACK_CLIP_PERCENTILE,
    white_pct: float = WHITE_CLIP_PERCENTILE,
    use_log_stretch: bool = True,
    *,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (min, max) percentiles over pixels > MIN_VALID_PIXEL, as 0-d tensors."""
    x = as_tensor(x, device)
    v = log_stretch(x) if use_log_stretch else x
    lo, hi = masked_percentiles(v, x > MIN_VALID_PIXEL, (black_pct, white_pct))
    return lo, hi


def log_stretch_normalize(
    x,
    global_min,
    global_max,
    use_log_stretch: bool = True,
    *,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """log1p -> affine by global stats -> clip [0, 1] (float32).

    Stats given as Python floats keep ``max - min + 1e-8`` in double, as
    jax does with Python scalars; tensor stats compute it in float32."""
    x = as_tensor(x, device)
    v = log_stretch(x) if use_log_stretch else x
    if not isinstance(global_min, (int, float)):
        global_min = as_tensor(global_min, x.device)
    if not isinstance(global_max, (int, float)):
        global_max = as_tensor(global_max, x.device)
    return torch.clamp((v - global_min) / (global_max - global_min + 1e-8), 0.0, 1.0)


def quantize_u16(x01, *, device: torch.device | str | None = None) -> torch.Tensor:
    """[0, 1] float -> the reference's uint16 code (x * 65535, truncated).

    torch has almost no uint16 arithmetic: the codes are int32 in
    [0, 65535]; ``.cpu().numpy().astype(np.uint16)`` makes the TIFF's pixels.
    """
    x01 = as_tensor(x01, device)
    return (torch.clamp(x01, 0.0, 1.0) * 65535.0).to(torch.int32)
