"""The attention window kernel's weight packing (K4/K9c), walked back into
products on the CPU.

``attn_pack_reference`` is the plain form of ``attn_pack_kernel``, which
``chip_smoke.py`` holds it against bit for bit on the card. Here the packed
tiles are read back by the byte formula the kernel's descriptors use and
applied as the kernel applies them: q, k, v = xn . tile (MN-major B), dxn +=
dqkv_h . tile^T (K-major B), do_h = dh . wproj tile; the results must be the
plain xn . wqkv, dqkv . wqkv^T and dh . wproj^T."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels.swin_block import attn_head_width, attn_pack_reference


def _tiles(packed: np.ndarray, c: int, heads: int) -> np.ndarray:
    """(heads, 4, ck, hp) from the flat packing: element (c, j) of a tile at
    (c // 8) hp*8 + (j // 8) 64 + (c % 8) 8 + j % 8."""
    hp = attn_head_width(c, heads)
    ck = -(-c // 64) * 64
    cc, jj = np.meshgrid(np.arange(ck), np.arange(hp), indexing="ij")
    pos = (cc // 8) * hp * 8 + (jj // 8) * 64 + (cc % 8) * 8 + jj % 8
    tiles = packed.reshape(heads * 4, ck * hp)[:, pos]
    return tiles.reshape(heads, 4, ck, hp)


@pytest.mark.parametrize("c,heads", [(180, 6), (96, 6), (36, 6), (96, 3)])
def test_packed_weights_compute_the_products(c, heads):
    rng = np.random.default_rng(c + heads)
    bf = torch.bfloat16
    wqkv = torch.from_numpy(rng.standard_normal((c, 3 * c)).astype(np.float32)).to(bf)
    wproj = torch.from_numpy(rng.standard_normal((c, c)).astype(np.float32)).to(bf)
    packed = attn_pack_reference(wqkv, wproj, heads)
    hd, hp = c // heads, attn_head_width(c, heads)
    ck = -(-c // 64) * 64
    assert packed.dtype == bf and packed.numel() == heads * 4 * ck * hp
    tiles = _tiles(packed.double().numpy(), c, heads)
    wq, wp = wqkv.double().numpy(), wproj.double().numpy()
    # zero past C and past each head's hd columns
    assert not tiles[:, :, c:].any() and not tiles[..., hd:].any()

    xn = rng.standard_normal((64, ck))
    xn[:, c:] = 0.0  # the kernel's xn is zero past C
    dh = rng.standard_normal((64, ck))
    dh[:, c:] = 0.0
    dqkv = rng.standard_normal((64, 3 * c))
    qkv = np.zeros((64, 3 * c))
    do = np.zeros((64, c))
    dxn = np.zeros((64, ck))
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        for which in range(3):
            out = xn @ tiles[h, 1 + which]  # (64, hp): the head's padded columns
            qkv[:, which * c:(which + 1) * c][:, cols] = out[:, :hd]
            assert not out[:, hd:].any()
            d = np.zeros((64, hp))
            d[:, :hd] = dqkv[:, which * c:(which + 1) * c][:, cols]
            dxn += d @ tiles[h, 1 + which].T
        do[:, cols] = (dh @ tiles[h, 0])[:, :hd]
    np.testing.assert_allclose(qkv, xn[:, :c] @ wq, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(dxn[:, :c], dqkv @ wq.T, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(do, dh[:, :c] @ wp.T, rtol=1e-12, atol=1e-9)
    assert not dxn[:, c:].any()
