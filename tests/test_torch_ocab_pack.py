"""K6's and K10a's weight operands on the CPU: the OCAB tail's weights at
HAT's widths padded (``pad_ocab_operands``) and packed into the wgmma
kernel's tiles (``pack_ocab_weights`` on a CPU tensor: ``attn_pack_reference``
on wproj's rows moved to the gather's slots, ``mlp_pack_reference``), then
read back by the byte formulas the kernel's descriptors use and applied as
the kernel applies them: per head proj += o_h . tile^T (K-major B), where
o_h holds the head's hd attention channels at slots o .. o + hd - 1 (o =
(h hd) % 2, as the 4-byte gather leaves them) and its neighbours' columns
in the other slots; u = hn . w1 tile (MN-major B), y += g . w2 tile^T
(K-major B). The products must be the unpadded ones on the real columns,
exactly: every operand is a small multiple of a power of two, so fp32 sums
them without rounding in any order. The padded columns must be zero, and
so must the wq, wk and wv tiles, which the kernels never stream. Also: the
wrappers' ``packed`` keyword on CPU tensors still gives the plain
version's result."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels import (
    fused_ocab_block,
    ocab_block_reference,
    ocab_fwd_h,
    ocab_fwd_h_reference,
    pack_ocab_weights,
)
from superresolution_def_tpu_torch.kernels.ocab import pad_ocab_operands, slot_rows

# HAT's widths (head_dim 15 in 16 slots), a narrow one (5 in 16) and the
# flagship's (30 in 32)
HAT_WIDTHS = [(90, 6, 360), (30, 6, 60), (180, 6, 720)]
# 14 heads of 9 in 10 slots each: the slot rows (140) outrun the padded
# width's 64-column chunks (128), and the packing cuts them to the kernel's
ODD_WIDTHS = [(126, 14, 252)]


def _exact(rng, *shape, scale):
    """Values k / scale with small integers k: exact in bf16, and their
    products' sums exact in fp32."""
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32) / scale)


def _tail_weights(rng, c, hidden):
    """The OCAB tail's eight weight operands at width c, weights bf16."""
    bf = torch.bfloat16
    return (_exact(rng, c, c, scale=8).to(bf), _exact(rng, c, scale=64),
            1 + _exact(rng, c, scale=64), _exact(rng, c, scale=64),
            _exact(rng, c, hidden, scale=8).to(bf), _exact(rng, hidden, scale=64),
            _exact(rng, hidden, c, scale=8).to(bf), _exact(rng, c, scale=64))


def _tiles(packed, rows, cols):
    """(tiles, rows, cols) from a packing of rows x cols tiles: element (r,
    j) at (r // 8) cols*8 + (j // 8) 64 + (r % 8) 8 + j % 8, the interleaved
    layout the kernel's descriptors read."""
    rr, jj = torch.meshgrid(torch.arange(rows), torch.arange(cols), indexing="ij")
    pos = (rr // 8) * cols * 8 + (jj // 8) * 64 + (rr % 8) * 8 + jj % 8
    return packed.reshape(-1, rows * cols)[:, pos]


@pytest.mark.parametrize("c,heads,hidden", HAT_WIDTHS + ODD_WIDTHS)
def test_packed_weights_compute_the_unpadded_products(c, heads, hidden):
    rng = np.random.default_rng(c + heads + hidden)
    weights = _tail_weights(rng, c, hidden)
    padded = pad_ocab_operands(*weights)
    wproj, w1, w2 = (weights[i].float() for i in (0, 4, 6))
    cp = -(-c // 16) * 16
    hd = c // heads
    ck, hp, nj = -(-cp // 64) * 64, 16 if hd <= 16 else 32, -(-hidden // 64)
    packed = pack_ocab_weights(padded, num_heads=heads, channels=c)
    na = heads * 4 * ck * hp
    assert packed.dtype == torch.bfloat16 and packed.numel() == na + nj * 2 * ck * 64
    at = _tiles(packed[:na].float(), ck, hp).reshape(heads, 4, ck, hp)
    mt = _tiles(packed[na:].float(), ck, 64).reshape(nj, 2, ck, 64)
    assert not at[:, 1:].any()  # wq, wk, wv: never streamed

    def pad_cols(t, width):  # the kernel's operands: zero past the real columns
        return torch.cat([t, t.new_zeros(t.shape[0], width - t.shape[1])], 1)

    # proj: head h's slots s hold attention channel base + s (base = h hd
    # rounded down to even, zero past c), as the gather of v leaves P . v
    o = _exact(rng, 64, c, scale=4)
    op = pad_cols(o, c + hp)
    proj = torch.zeros(64, ck)
    for h in range(heads):
        base, first = (h * hd) & ~1, (h * hd) % 2
        proj += op[:, base:base + hp] @ at[h, 0].T
        # the tile's rows (slots) outside the head's are zero
        live = torch.zeros(hp, dtype=torch.bool)
        live[first:first + hd] = True
        assert not at[h, 0][:, ~live].any(), h
    assert torch.equal(proj[:, :c], o @ wproj) and not proj[:, c:].any()
    slots = slot_rows(c, heads)
    assert len(set(slots.tolist())) == c and slots.max() < heads * (hd + hd % 2)

    # the MLP, 64 hidden columns a chunk: u = hn . w1, y = g . w2
    hn = _exact(rng, 64, c, scale=4)
    u = torch.cat([pad_cols(hn, ck) @ mt[j, 0] for j in range(nj)], 1)
    assert torch.equal(u[:, :hidden], hn @ w1) and not u[:, hidden:].any()
    g = _exact(rng, 64, hidden, scale=4)
    gp = pad_cols(g, nj * 64)
    y = sum(gp[:, j * 64:(j + 1) * 64] @ mt[j, 1].T for j in range(nj))
    assert torch.equal(y[:, :c], g @ w2) and not y[:, c:].any()
    # the tiles' rows past the padded width are zero
    assert not at[:, :, cp:].any() and not mt[:, :, cp:].any()


def _ocab_args(rng, bw, c, heads, hidden):
    bf = torch.bfloat16
    x, q = (torch.from_numpy(rng.standard_normal((bw, 64, c)).astype(np.float32)).to(bf)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bw, 144, c)).astype(np.float32)).to(bf)
            for _ in range(2))
    k[:, :14] = 0  # the overlap gather's out-of-image keys
    v[:, :14] = 0
    return (x, q, k, v, _exact(rng, heads, 64, 144, scale=16), *_tail_weights(rng, c, hidden))


@pytest.mark.parametrize("store_h", [False, True])
def test_ocab_wrappers_with_packed_weights_on_cpu_are_the_plain_version(store_h):
    rng = np.random.default_rng(5 + store_h)
    c, heads, hidden = 90, 6, 360
    args = _ocab_args(rng, 3, c, heads, hidden)
    kw = dict(num_heads=heads, scale=15**-0.5)
    padded = pad_ocab_operands(*args[5:])
    packed = pack_ocab_weights(padded, num_heads=heads, channels=c)
    if store_h:
        before = ocab_fwd_h.launches
        got = ocab_fwd_h(*args, **kw, padded=padded, packed=packed)
        want = ocab_fwd_h_reference(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert ocab_fwd_h.launches == before
    else:
        before = fused_ocab_block.launches
        got = fused_ocab_block(*args, **kw, padded=padded, packed=packed)
        assert torch.equal(got, ocab_block_reference(*args, **kw))
        assert fused_ocab_block.launches == before
