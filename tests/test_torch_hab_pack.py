"""K5's weight operands on the CPU: HAT's C = 90 weights padded
(``pad_hab_operands``) and packed into the wgmma kernel's tiles
(``attn_pack_reference``, ``mlp_pack_reference``; ``pack_hab_weights`` on a
CPU tensor), then read back by the byte formulas the kernel's descriptors
use and applied as the kernel applies them: q, k, v = xn . tile (MN-major
B), proj += o_h . tile^T (K-major B), u = hn . w1 tile (MN-major B), y +=
g . w2 tile^T (K-major B). The products must be the unpadded ones on the
real columns, exactly: every operand is a small multiple of a power of two,
so fp32 sums them without rounding in any order. The padded columns must be
zero. Also: the wrappers' ``packed`` keyword on CPU tensors still gives the
plain version's result."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels import (
    fused_hab_block,
    fused_swin_block,
    hab_block_reference,
    make_fused_swinir,
    pack_hab_weights,
    pack_swin_block_weights,
    swin_block_reference,
)
from superresolution_def_tpu_torch.kernels.hab_block import pad_hab_operands, padded_head_dim
from superresolution_def_tpu_torch.kernels.swin_block import (
    attn_head_width,
    attn_pack_reference,
    mlp_pack_reference,
)
from superresolution_def_tpu_torch.models import SwinIR

# HAT's widths (head_dim 15 padded to 16), a narrow one (5 to 6) and the
# flagship's (30 to 32)
HAT_WIDTHS = [(90, 6, 360), (30, 6, 60), (180, 6, 720)]


def _exact(rng, *shape, scale):
    """Values k / scale with small integers k: exact in bf16, and their
    products' sums exact in fp32."""
    return torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32) / scale)


def _hab_weights(rng, c, hidden):
    """The twelve HAB weight operands at width c, weights bf16."""
    bf = torch.bfloat16
    return (1 + _exact(rng, c, scale=64), _exact(rng, c, scale=64),
            _exact(rng, c, 3 * c, scale=8).to(bf), _exact(rng, 3 * c, scale=64),
            _exact(rng, c, c, scale=8).to(bf), _exact(rng, c, scale=64),
            1 + _exact(rng, c, scale=64), _exact(rng, c, scale=64),
            _exact(rng, c, hidden, scale=8).to(bf), _exact(rng, hidden, scale=64),
            _exact(rng, hidden, c, scale=8).to(bf), _exact(rng, c, scale=64))


def _attn_tiles(packed, c, heads):
    """(heads, 4, ck, hp) from the attention packing: element (c, j) of a tile
    at (c // 8) hp*8 + (j // 8) 64 + (c % 8) 8 + j % 8."""
    hp, ck = attn_head_width(c, heads), -(-c // 64) * 64
    cc, jj = torch.meshgrid(torch.arange(ck), torch.arange(hp), indexing="ij")
    pos = (cc // 8) * hp * 8 + (jj // 8) * 64 + (cc % 8) * 8 + jj % 8
    return packed.reshape(heads * 4, ck * hp)[:, pos].reshape(heads, 4, ck, hp)


def _mlp_tiles(packed, c, hidden):
    """(chunks, 2, ck, 64) from the MLP packing: element (c, jj) of a tile at
    (c // 8) 512 + (jj // 8) 64 + (c % 8) 8 + jj % 8."""
    ck, nj = -(-c // 64) * 64, -(-hidden // 64)
    cc, jj = torch.meshgrid(torch.arange(ck), torch.arange(64), indexing="ij")
    pos = (cc // 8) * 512 + (jj // 8) * 64 + (cc % 8) * 8 + jj % 8
    return packed.reshape(nj * 2, ck * 64)[:, pos].reshape(nj, 2, ck, 64)


@pytest.mark.parametrize("c,heads,hidden", HAT_WIDTHS)
def test_padded_packed_weights_compute_the_unpadded_products(c, heads, hidden):
    rng = np.random.default_rng(c + heads + hidden)
    weights = _hab_weights(rng, c, hidden)
    padded = pad_hab_operands(*weights, num_heads=heads)
    wqkv, wproj, w1, w2 = (weights[i].float() for i in (2, 4, 8, 10))
    cp = heads * padded_head_dim(c // heads, heads)
    hd = c // heads
    ck, hp, nj = -(-cp // 64) * 64, attn_head_width(cp, heads), -(-hidden // 64)
    packed = pack_hab_weights(padded, num_heads=heads)
    attn = attn_pack_reference(padded[2], padded[4], heads)
    mlp = mlp_pack_reference(padded[8], padded[10])
    assert torch.equal(packed, torch.cat([attn, mlp]))
    assert attn.numel() == heads * 4 * ck * hp and mlp.numel() == nj * 2 * ck * 64
    at = _attn_tiles(attn.float(), cp, heads)
    mt = _mlp_tiles(mlp.float(), cp, hidden)

    def pad_cols(t, width):  # the kernel's operands: zero past the real columns
        return torch.cat([t, t.new_zeros(t.shape[0], width - t.shape[1])], 1)

    # qkv: the LN1 output is zero past cio; each head's hdp columns, then zeros
    xn = _exact(rng, 64, c, scale=4)
    qkv = torch.zeros(64, 3 * c)
    for h in range(heads):
        for which in range(3):
            out = pad_cols(xn, ck) @ at[h, 1 + which]  # (64, hp)
            assert not out[:, hd:].any(), (h, which)
            qkv[:, which * c + h * hd: which * c + (h + 1) * hd] = out[:, :hd]
    assert torch.equal(qkv, xn @ wqkv)

    # proj: each head's output (zero past hd, as v is) against its wproj tile
    o = _exact(rng, 64, c, scale=4)
    proj = sum(pad_cols(o[:, h * hd:(h + 1) * hd], hp) @ at[h, 0].T for h in range(heads))
    assert torch.equal(proj[:, :c], o @ wproj) and not proj[:, c:].any()

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


def test_fused_swin_block_with_packed_weights_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(1)
    c, heads, hidden = 16, 2, 32
    bf = torch.bfloat16
    args = [torch.from_numpy(rng.standard_normal((3, 64, c)).astype(np.float32)).to(bf),
            1 + _exact(rng, c, scale=64), _exact(rng, c, scale=64),
            _exact(rng, c, 3 * c, scale=32).to(bf), _exact(rng, 3 * c, scale=64),
            _exact(rng, 2, 64, 64, scale=16), _exact(rng, c, c, scale=32).to(bf),
            _exact(rng, c, scale=64), 1 + _exact(rng, c, scale=64), _exact(rng, c, scale=64),
            _exact(rng, c, hidden, scale=32).to(bf), _exact(rng, hidden, scale=64),
            _exact(rng, hidden, c, scale=32).to(bf), _exact(rng, c, scale=64)]
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    packed = pack_swin_block_weights(args[3], args[6], args[10], args[12], num_heads=heads)
    assert torch.equal(packed, torch.cat([attn_pack_reference(args[3], args[6], heads),
                                          mlp_pack_reference(args[10], args[12])]))
    before = fused_swin_block.launches
    got = fused_swin_block(*args, **kw, packed=packed)
    assert torch.equal(got, swin_block_reference(*args, **kw))
    assert fused_swin_block.launches == before


@pytest.mark.parametrize("shifted", [False, True])
def test_fused_hab_block_with_packed_weights_on_cpu_is_the_plain_version(shifted):
    rng = np.random.default_rng(2 + shifted)
    c, heads, hidden, bw = 90, 6, 360, 4
    weights = _hab_weights(rng, c, hidden)
    bias = _exact(rng, heads, 64, 64, scale=16)
    mask = (torch.from_numpy((rng.random((2, 64, 64)) < 0.2).astype(np.float32)) * -100.0
            if shifted else None)
    x, convx = (torch.from_numpy(rng.standard_normal((bw, 64, c)).astype(np.float32))
                .to(torch.bfloat16) for _ in range(2))
    operands = (*weights[:4], bias, *weights[4:])
    kw = dict(num_heads=heads, scale=15**-0.5, conv_scale=0.01)
    padded = pad_hab_operands(*weights, num_heads=heads)
    before = fused_hab_block.launches
    got = fused_hab_block(x, convx, mask, *operands, **kw, padded=padded,
                          packed=pack_hab_weights(padded, num_heads=heads))
    assert torch.equal(got, hab_block_reference(x, convx, mask, *operands, **kw))
    assert fused_hab_block.launches == before


def test_fused_swinir_inference_closure_on_cpu_runs_the_plain_blocks():
    """The inference closure (weights frozen, packed only on the card) and
    the differentiable one under no_grad (live weights) run the same plain
    blocks on CPU tensors: the same bits."""
    model = SwinIR(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
                   window_size=8, mlp_ratio=2.0, upscale=4,
                   generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(4).random((2, 16, 16, 1), dtype=np.float32))
    before = fused_swin_block.launches
    got = make_fused_swinir(model)(x)
    with torch.no_grad():
        want = make_fused_swinir(model, differentiable=True)(x)
    assert got.shape == (2, 64, 64, 1) and torch.equal(got, want)
    assert fused_swin_block.launches == before
