"""PSNR / SSIM with the reference's numerics, NHWC (mirrors the JAX ``ops/metrics.py``).

  PSNR = 10 * log10(1 / (MSE + 1e-8)), inputs clamped to [0, 1], MSE per
         sample over (H, W, C).
  SSIM = single scale, 11x11 Gaussian window (sigma 1.5) applied as two 1-D
         'valid' passes, C1 = 0.01**2, C2 = 0.03**2, mean over the batch map.

:class:`TrainMetrics` accumulates PSNR as a per-sample sum and SSIM as the
batch mean times the batch size.
"""

from __future__ import annotations

import dataclasses
import functools
from math import exp

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array(
        [exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2)) for x in range(window_size)],
        dtype=np.float32,
    )
    return g / g.sum()


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The normalized separable Gaussian as a (ws, ws) float32 window."""
    g = gaussian_1d(window_size, sigma)
    return np.outer(g, g).astype(np.float32)


@functools.cache
def _gaussian_on(window_size: int, device: torch.device) -> torch.Tensor:
    """:func:`gaussian_1d` on ``device``, uploaded once: a train step's SSIM
    copies nothing from the host."""
    return torch.from_numpy(gaussian_1d(window_size)).to(device)


def _blur_valid_separable(x: torch.Tensor, g1d: torch.Tensor) -> torch.Tensor:
    """Depthwise 'valid' Gaussian blur of NCHW ``x``, rows then columns."""
    c = x.shape[1]
    ws = g1d.shape[0]
    kh = g1d.reshape(1, 1, ws, 1).expand(c, 1, ws, 1)
    kw = g1d.reshape(1, 1, 1, ws).expand(c, 1, 1, ws)
    return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Scalar SSIM over the whole NHWC batch, computed in float32."""
    img1 = img1.float().permute(0, 3, 1, 2)
    img2 = img2.float().permute(0, 3, 1, 2)
    g1 = _gaussian_on(window_size, img1.device)
    c = img1.shape[1]
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1)
    blurred = _blur_valid_separable(stack, g1)
    mu1, mu2 = blurred[:, 0:c], blurred[:, c : 2 * c]
    sigma1_sq = blurred[:, 2 * c : 3 * c] - mu1 * mu1
    sigma2_sq = blurred[:, 3 * c : 4 * c] - mu2 * mu2
    sigma12 = blurred[:, 4 * c : 5 * c] - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample PSNR (B,), inputs clamped to [0, 1]."""
    p = pred.float().clamp(0.0, 1.0)
    t = target.float().clamp(0.0, 1.0)
    mse = ((p - t) ** 2).mean(dim=tuple(range(1, p.ndim)))
    return 10.0 * torch.log10(1.0 / (mse + 1e-8))


@dataclasses.dataclass
class TrainMetrics:
    """Streaming PSNR/SSIM accumulator (reference TrainMetrics semantics)."""

    psnr: float = 0.0
    ssim: float = 0.0
    count: int = 0

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        b = pred.shape[0]
        p = pred.float().clamp(0.0, 1.0)
        t = target.float().clamp(0.0, 1.0)
        self.psnr += float(psnr(p, t).sum())
        self.ssim += float(ssim(p, t)) * b
        self.count += b

    def compute(self) -> dict:
        if not self.count:
            return {"psnr": 0.0, "ssim": 0.0}
        return {"psnr": self.psnr / self.count, "ssim": self.ssim / self.count}
