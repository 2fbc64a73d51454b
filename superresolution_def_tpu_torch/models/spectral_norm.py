"""Spectral-normalised conv with torch-compatible power-iteration semantics.

The JAX ``models/spectral_norm.py`` as an ``nn.Module``. Like
``torch.nn.utils.spectral_norm`` it stores the parameter ``weight_orig`` and
the buffers ``weight_u`` and ``weight_v`` (the reference's state-dict
names); unlike it, the power iteration runs only when the caller passes
``update_stats=True`` (the JAX argument), never as a hidden hook, so a train
step can snapshot and restore (u, v) around a phase.

A training forward runs one power iteration without grad and computes
sigma = u^T W v with the new, detached vectors; gradients flow through W in
sigma. The 2-D view of the weight is torch's: O-first, (I, kh, kw)
flattened; a transposed conv keeps torch's (I, O, kh, kw) weight and views
it through its dim 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class SNConv2d(nn.Module):
    """Spectral-normalised NHWC conv (or transposed conv), no bias.

    Parameters are drawn from ``generator``: the weight U(+-1/sqrt(fan_in))
    with fan_in = in_ch * k * k, (u, v) normalised standard normals.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, *, transpose: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.transpose = stride, padding, transpose
        shape = (in_ch, out_ch, k, k) if transpose else (out_ch, in_ch, k, k)
        bound = 1.0 / math.sqrt(in_ch * k * k)
        self.weight_orig = nn.Parameter(
            torch.empty(shape).uniform_(-bound, bound, generator=generator))
        self.register_buffer("weight_u", _l2norm(torch.randn(out_ch, generator=generator)))
        self.register_buffer("weight_v", _l2norm(torch.randn(in_ch * k * k, generator=generator)))

    def weight_mat(self) -> torch.Tensor:
        w = self.weight_orig
        if self.transpose:
            w = w.transpose(0, 1)
        return w.reshape(w.shape[0], -1)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        w2d = self.weight_mat()
        if update_stats:
            with torch.no_grad():
                v = _l2norm(w2d.T @ self.weight_u)
                u = _l2norm(w2d @ v)
            # new tensors, not in-place: the graph of an earlier forward
            # keeps the vectors it used
            self.weight_u, self.weight_v = u, v
        sigma = self.weight_u @ (w2d @ self.weight_v)
        w = (self.weight_orig / sigma).to(dtype)
        x = x.to(dtype).permute(0, 3, 1, 2)
        if self.transpose:
            y = F.conv_transpose2d(x, w, stride=self.stride, padding=self.padding)
        else:
            y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)
