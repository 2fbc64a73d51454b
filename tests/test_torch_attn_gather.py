"""The bf16 window-attention kernel's gather (K11, ``csrc/window_attention.cu``),
emulated on the CPU.

The kernel copies each (window, head) of q, k and v by 4-byte ``cp.async``
into ``hp`` slots: slot pair (2s, 2s + 1) of a row from the two elements at
the head's first element moved back to an even address, plus 2s; slots from
``o + d`` on (``o`` the head's parity) and key rows past nk read as zero
(``fetch_head`` in ``csrc/swin_pack.cuh``). q's copy is then scaled, rounded
and masked to the head's slots ``[o, o + d)`` (``scaled_q``), the scores run
over every slot, and output column c is P.V's slot ``o_v + c``. The
emulation below follows that mapping, built from the wrapper's own helpers
(``gather_plan``, ``head_parity``, ``repack_heads``), on the strided views
the modules pass, views whose heads start at odd elements, and views with
odd row strides (which the plan repacks), and is held against
``window_attention_reference``: relative L2 <= 1e-3 in bf16, the card's
bound (the two round at the same points; the kernel multiplies by one
reciprocal a row where the reference divides, and sums in another order).
"""

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels.window_attention import (
    gather_plan,
    head_parity,
    repack_heads,
    window_attention_reference,
)

torch.set_num_threads(1)
BF = torch.bfloat16


def _views(seed, layout, bw, heads, hd, nk):
    """bf16 q, k, v: "qkv" the SwinIR/HAB modules' views of one (Bw, 64, 3,
    heads, hd) tensor (nk = 64), "ocab" the OCAB module's (q of its own, k
    and v halves of one (Bw, nk, 2, heads, hd)), "shifted" each one element
    into a buffer of even rows, "contiguous" (Bw, heads, rows, hd) each."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF)

    if layout == "qkv":
        qkv = t(bw, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]
    if layout == "ocab":
        kv = t(bw, nk, 2, heads, hd).permute(2, 0, 3, 1, 4)
        return t(bw, 64, heads, hd).transpose(1, 2), kv[0], kv[1]
    if layout == "shifted":
        return tuple(t(bw, heads, n, hd + 2 - hd % 2)[..., 1:hd + 1] for n in (64, nk, nk))
    return tuple(t(bw, heads, n, hd) for n in (64, nk, nk))


def _parity(t):
    """(Bw, heads) parity of each head's first element, from head_parity."""
    p0, pb, ph = head_parity(t)
    bw, heads = t.shape[:2]
    return (p0 + torch.arange(bw)[:, None] * pb + torch.arange(heads)[None] * ph) % 2


def _stage(t, hp, total):
    """The (Bw, heads, total, hp) slots the kernel's gather fills from t, and
    whether every 4-byte copy it makes starts at an even element address."""
    bw, heads, rows, hd = t.shape
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
    o = _parity(t)[:, :, None, None]
    b = torch.arange(bw)[:, None, None, None]
    h = torch.arange(heads)[None, :, None, None]
    r = torch.arange(total)[None, None, :, None]
    s = torch.arange(hp)[None, None, None, :]
    start = t.storage_offset() + b * t.stride(0) + h * t.stride(1) - o + r * t.stride(2)
    live = (r < rows) & (s < o + hd)  # a pair reaching past the head copies 2 bytes
    vals = flat[torch.where(live, start + s, 0)]
    base = t.data_ptr() // t.element_size() - t.storage_offset()  # element address of flat[0]
    aligned = bool((((base + start) % 2 == 0) | (r >= rows)).all())
    return torch.where(live, vals, torch.zeros((), dtype=t.dtype)), aligned


def _kernel_emulation(q, k, v, bias, mask, scale):
    """The bf16 kernel's function on the slots its gather fills, after the
    wrapper's plan: out (Bw, heads, 64, hd) bf16, the slots, the plan."""
    plan = gather_plan(q, k, v)
    q, k, v = (repack_heads(t) if rep else t for t, rep in zip((q, k, v), plan.repack))
    hp, hd, nk = plan.hp, q.shape[-1], k.shape[2]
    keys = 64 if nk <= 64 else 144
    (qs, qa), (ks, ka), (vs, va) = _stage(q, hp, 64), _stage(k, hp, keys), _stage(v, hp, keys)
    assert qa and ka and va, "a 4-byte copy starts at an odd element"
    oq, ov = _parity(q)[:, :, None, None], _parity(v)[:, :, None, None]
    assert torch.equal(oq, _parity(k)[:, :, None, None]), "q's and k's heads at other slots"
    slot = torch.arange(hp)
    in_head = (slot >= oq) & (slot < oq + hd)
    sq = torch.tensor(scale, dtype=BF)
    qf = torch.where(in_head, qs * sq, torch.zeros((), dtype=BF))  # scaled_q: bf16(q * s)
    s = qf.float() @ ks.float().transpose(-1, -2)
    start = torch.full((q.shape[1], 64, keys), -torch.inf)
    start[..., :nk] = bias
    s = s + start
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(-1, nw, *s.shape[1:]) + torch.nn.functional.pad(
            mask, (0, keys - nk))[None, :, None]).reshape(s.shape)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e * (1 / e.sum(-1, keepdim=True))).to(BF)  # one reciprocal a row
    acc = p.float() @ vs.float()  # (Bw, heads, 64, hp)
    cols = (ov + torch.arange(hd)).expand(*acc.shape[:3], hd)
    return torch.gather(acc, -1, cols).to(BF), (qs, ks, vs, oq, ov), plan


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout,heads,hd,nk", [
    ("qkv", 2, 30, 64),        # SwinIR's head width, even head offsets
    ("qkv", 3, 6, 64),         # row stride 54: even rows and head offsets
    ("qkv", 2, 15, 64),        # HAT's head width: odd heads land at slots 1 .. 15
    ("ocab", 2, 15, 144),      # OCAB's 144 keys, odd heads at slots 1 .. 15
    ("ocab", 3, 5, 100),       # q's rows odd (15): q repacked; keys short of a stage
    ("shifted", 2, 31, 64),    # every head at an odd element: 32 slots
    ("shifted", 1, 32, 144),   # 33 slots would be needed: repacked
    ("contiguous", 2, 5, 64),  # odd rows: all three repacked
    ("contiguous", 2, 8, 144),
])
def test_gather_emulation_matches_reference(layout, heads, hd, nk, masked):
    bw = 4
    q, k, v = _views(hd + nk, layout, bw, heads, hd, nk)
    rng = np.random.default_rng(nk)
    bias = torch.from_numpy(0.5 * rng.standard_normal((heads, 64, nk)).astype(np.float32))
    mask = None
    if masked:
        mask = torch.from_numpy(-100.0 * (rng.random((2, 64, nk)) < 0.3)).float()
    scale = hd**-0.5
    got, (qs, ks, vs, oq, ov), _ = _kernel_emulation(q, k, v, bias, mask, scale)
    want = window_attention_reference(q, k, v, bias, mask, scale=scale)
    assert got.shape == want.shape == (bw, heads, 64, hd)
    assert _rel_l2(got, want) <= 1e-3, _rel_l2(got, want)
    # the slots hold the heads at [o, o + hd), key rows past nk zero
    idx = oq.expand(*qs.shape[:3], 1) + torch.arange(hd)
    assert torch.equal(torch.gather(qs, -1, idx), q)
    idx = oq.expand(*ks.shape[:2], nk, 1) + torch.arange(hd)
    assert torch.equal(torch.gather(ks[:, :, :nk], -1, idx), k)
    idx = ov.expand(*vs.shape[:2], nk, 1) + torch.arange(hd)
    assert torch.equal(torch.gather(vs[:, :, :nk], -1, idx), v)
    assert not ks[:, :, nk:].any() and not vs[:, :, nk:].any()


@pytest.mark.parametrize("layout,heads,hd,nk,hp,repack", [
    ("qkv", 6, 30, 64, 32, (False, False, False)),   # SwinIR: rows of 540
    ("qkv", 6, 15, 64, 16, (False, False, False)),   # HAB: rows of 270, odd heads at 1 .. 15
    ("ocab", 6, 15, 144, 16, (False, False, False)),  # OCAB: q rows of 90, k and v of 180
    ("shifted", 2, 15, 64, 16, (False, False, False)),
    ("shifted", 2, 16, 64, 32, (False, False, False)),  # 17 slots
    ("shifted", 2, 32, 64, 32, (True, True, True)),     # 33 slots
    ("contiguous", 3, 15, 64, 16, (True, True, True)),  # rows of 15
    ("contiguous", 3, 16, 64, 16, (False, False, False)),
    # q rows of 15: q repacked, and k with it (its heads alternate parity)
    ("ocab", 3, 5, 144, 16, (True, True, False)),
])
def test_gather_plan(layout, heads, hd, nk, hp, repack):
    """hp and the repacks the wrapper chooses; the modules' flagship views
    (SwinIR C = 180, HAT's HAB and OCAB at C = 90) are gathered in place."""
    q, k, v = _views(0, layout, 2, heads, hd, nk)
    assert gather_plan(q, k, v) == (hp, repack)


def test_gather_plan_repacks_q_and_k_at_other_parities():
    """q's heads at odd elements and k's at even ones: both repacked, as the
    scores pair q's slot j with k's; v keeps its own parity."""
    q, k, v = _views(1, "shifted", 2, 2, 15, 64)
    kc = torch.randn(2, 2, 64, 16, generator=torch.Generator().manual_seed(1)).to(BF)[..., :15]
    assert gather_plan(q, kc, v) == (16, (True, True, False))
    got, _, _ = _kernel_emulation(q, kc, v, torch.zeros(2, 64, 64), None, 15**-0.5)
    want = window_attention_reference(q, kc, v, torch.zeros(2, 64, 64), None, scale=15**-0.5)
    assert _rel_l2(got, want) <= 1e-3


def test_odd_row_strides_are_not_4_byte_aligned():
    """Why an odd row stride is repacked: alternate rows' first elements sit
    at odd addresses, where no 4-byte copy can start."""
    q, k, v = _views(2, "contiguous", 2, 2, 15, 64)
    o = _parity(q)[:, :, None]
    rows = q.data_ptr() // 2 + torch.arange(2)[:, None, None] * q.stride(0) + torch.arange(
        2)[None, :, None] * q.stride(1) - o + torch.arange(64) * q.stride(2)
    assert (rows % 2 == 1).any()
    assert gather_plan(q, k, v).repack == (True, True, True)
    r = repack_heads(q)
    assert torch.equal(r, q) and r.stride(2) == 16 and head_parity(r) == (0, 0, 0)
