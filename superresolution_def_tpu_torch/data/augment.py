"""Paired augmentation with the reference's distribution (the JAX ``data/augment.py``).

Reference (astronomical_dataset_swin.py:57-67, train split only): per sample,
independent p=0.5 horizontal flip, p=0.5 vertical flip, and k ~ U{0..3}
rot90, applied identically to the LR and HR patch. The draws are explicit
tensors so tests can feed both packages the same ones; :func:`draw_augment`
makes them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch


def draw_augment(batch: int, generator: torch.Generator):
    """Per-sample draws ``(do_h, do_v, k)``: two bool (B,) and one int64 (B,) in 0..3."""
    do_h = torch.rand(batch, generator=generator) < 0.5
    do_v = torch.rand(batch, generator=generator) < 0.5
    k = torch.randint(0, 4, (batch,), generator=generator)
    return do_h, do_v, k


def augment_pair_batch(lr: torch.Tensor, hr: torch.Tensor, draws):
    """hflip, then vflip, then rot90 k times on axes (H, W), per sample, to the
    NHWC ``lr`` (B, h, w, C) and ``hr`` (B, H, W, C) alike (square patches)."""
    do_h, do_v, k = (d.tolist() for d in draws)

    def one(img, i):
        if do_h[i]:
            img = img.flip(1)
        if do_v[i]:
            img = img.flip(0)
        return torch.rot90(img, k[i], dims=(0, 1))

    return (torch.stack([one(lr[i], i) for i in range(lr.shape[0])]),
            torch.stack([one(hr[i], i) for i in range(hr.shape[0])]))
