"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA device.
The machine with the card has no jax, and this suite's conftest imports it,
so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Each kernel is checked at widths that take each of its code paths: one, two,
three and four 64-column chunks of the residual, an odd head count, head_dim
30 padded to 32, a hidden width that is not a tile multiple. The HAT kernels
K5 (HAB, shifted and unshifted) and K6 (OCAB tail) run at C = 90 (head_dim
15, padded to 16), 30 (head_dim 5) and 180 with six heads; K7 (dense block)
at F/G = 48/24, 64/32 and 16/8, on images 256 and 64 wide whose height is
not a multiple of the kernel's tile. K5, K6 and K7 are held to K1's bound.
The HAB and OCAB training kernels K9a-c and K10a-b run at the same three
HAT widths, K9 shifted and unshifted, with per-window drop-path scales that
drop one sample: K9a/K10a held to K1's bound, the backwards (K9b, K9c, K10b)
to K3/K4's, and each backward twice to the same bits; K9a (K5's wgmma kernel
with the h store and the scales) also at 3, 7 and 9 windows, shifted and
not, with and without scales, twice to the same bits, and refusing a conv_x
that is not 16-byte aligned. K11 (standalone
window attention) runs at head_dim 5, 15, 30 and 32, 64 and 144 keys, with
and without the shift mask, in bf16 (relative L2 <= 1e-3 to its plain
version: both keep the Pallas rounding points, fp32 scores, bias and
softmax, and differ by fp32 summation order; scores rounded to bf16 as the
XLA path does would land near 3e-3) and fp32 (max |kernel - plain| <= 1e-5: the same fp32 arithmetic in
another summation order), on q, k and v that are strided views of one qkv
tensor; and at 1, 3, 133 and 265 windows of 1, 6 and 14 heads (with and
without a mask of nW < Bw windows, twice to the same bits) on the modules'
views, on views whose heads all start at odd elements and on contiguous
ones (odd rows, which the bf16 kernel's gather repacks first, and even);
the modules' flagship views go in with no copy (no repack, no allocation
beyond out). K12 (the dense block, NHWC) runs at F/G = 48/24, 64/32 and 16/8 and
on a 40 x 24 image, held to K1's bound against its plain version, and
gives K7's bits (it runs K7's conv kernels on K7's packing, x read in
place). K10b (the OCAB attention backward) also runs at 1, 7, 133 and 512
windows (below, off and above one persistent wave of blocks) and at an odd
width with an odd head count and fewer keys, against its plain version and
twice to the same bits. K1, K2, K5, K6 and K10a are one wgmma
kernel (K2 with the store of h, K5 with HAB's mask, conv branch and padded
widths; K6 and K10a its OCAB mode): K2 is held to K1's bound against its
plain version and against K1's out, and runs at 1, 3 and 7 windows twice to
the same bits; K1 runs at 1, 3, 7 and 768 windows, K5 at 3, 7 and 9
(shifted by a mask of nW windows, nW dividing Bw, and unshifted) and K6
and K10a at 1, 7, 133 and 2048 (the first 14 keys zero, as the overlap
gather leaves an edge window's) twice to the same bits and, on weights
packed once, to the bits of a call that packs them itself;
K7 runs at B = 1 and 3 on odd sizes with and without the stash, twice to
the same bits. K4b (the block's backward from
x and dout, the forward recomputed, in three phases on K2's, K3's and K4's
wgmma kernels) runs at K1-K4's five width sets and at 1, 3, 7 and 263
windows, held to K3/K4's bound against its plain version and against K3 +
K4 on K2's h (the two differ by where they round: LN2 on the fp32 h and an
fp32 dh against K2's bf16 h and K3's bf16 dh), twice to the same bits; the
recompute SwinIR's gradients are held as the split one's. K13 (the
stage-ablation block, C in 129..192: K1's wgmma kernel with a stage taken
out or the activation swapped) runs each of its nine modes at the
flagship widths, held to K1's bound and to 5e-4 relative L2, its stage
modes also at 1, 3, 7 and 263 windows twice to the same bits, with
``mlp_tanhgelu`` equal to K1 bit for bit (it launches K1's instantiation),
``allheads`` equal to ``full`` bit for bit (one instantiation) and every
mode on weights packed once giving the bits of a per-call packing; its
activations, and a polygelu with zeroed coefficients, lie further apart
than that.

Bounds. K1 and K2: bf16 io rounds the output to 8 significant bits, and
kernel and plain version sum in different orders, so max |kernel - plain|
<= 3e-2 * max(1, max |plain|) (the bound ``chip_smoke.py`` holds K1 to).
K3 and K4: every output's relative L2 distance to the plain version <= 2e-2:
the products take bf16 operands (2**-9 relative rounding), an intermediate
that lands on the other side of a bf16 rounding step in the kernel's fp32
sum order moves everything computed from it, and the weight gradients sum
fp32 partials in another order. The fused backward of a 2-stage SwinIR
against autograd of the fp32 module: bf16 forward and backward through 4
blocks and the convs move the gradients by a few percent (the fp32 path is
exact: tests/test_torch_swin_block_train.py), so each checked gradient's
relative L2 distance is held to 2x that of autograd through the bf16
``nn.Module``, or 2e-2, whichever is larger.
"""

import copy

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels import (
    fused_hab_block,
    swin_block_bwd,
    swin_block_bwd_reference,
    swin_stage_block,
    swin_stage_block_reference,
    hab_bwd_attn,
    hab_bwd_attn_reference,
    hab_bwd_mlp,
    hab_bwd_mlp_reference,
    hab_fwd_h,
    hab_fwd_h_reference,
    make_fused_hat_train,
    ocab_bwd_attn,
    ocab_bwd_attn_reference,
    ocab_fwd_h,
    ocab_fwd_h_reference,
    fused_rdb_cm_bwd,
    fused_ocab_block,
    fused_rdb,
    fused_rdb_cm,
    fused_swin_block,
    hab_block_reference,
    make_fused_hybrid,
    make_fused_hybrid_train,
    make_fused_swinir,
    swin_block_bwd_attn,
    swin_block_bwd_attn_reference,
    swin_block_bwd_mlp,
    swin_block_bwd_mlp_reference,
    swin_block_fwd_h,
    swin_block_fwd_h_reference,
    ocab_block_reference,
    pack_hab_weights,
    pack_ocab_weights,
    pack_swin_block_weights,
    rdb_cm_bwd_reference,
    rdb_cm_reference,
    rdb_nhwc_reference,
    swin_block_reference,
    window_attention,
    window_attention_masked,
    window_attention_nomask,
    window_attention_reference,
)
from superresolution_def_tpu_torch.kernels.fused_rdb_cm import dense_block_sources
from superresolution_def_tpu_torch.kernels.hab_block import pad_hab_operands
from superresolution_def_tpu_torch.kernels.ocab import pad_ocab_operands
from superresolution_def_tpu_torch.kernels.swin_stage_ablation import MODES
from superresolution_def_tpu_torch.kernels.window_attention import gather_plan
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
from superresolution_def_tpu_torch.ops import shift_window_attn_mask

pytestmark = pytest.mark.cuda

K1_TOL = 3e-2
BWD_REL_L2 = 2e-2
FUSED_GRAD_REL_L2 = 2e-2
# K13 against its plain version, relative L2: sums in another order only
# (the H100 reads 1e-4..3.4e-4 at the flagship widths), under the 8e-4
# between the erf and tanh GELUs' blocks, the closest activations it must
# tell apart
K13_REL_L2 = 5e-4

WIDTHS = [
    (8, 16, 2, 32),      # one residual chunk, head_dim 8
    (5, 96, 3, 384),     # two chunks, an odd head count
    (3, 180, 6, 720),    # the flagship widths: three chunks, head_dim 30
    (2, 256, 8, 1024),   # four chunks, the widest C the kernels take
    (4, 60, 2, 100),     # C and hidden both off the 64-wide tiles
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    # the plain versions are the fp32 reference: no TF32 in their products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _operands(seed, bw, c, heads, hidden, device):
    """x and the 13 block parameters, numpy-seeded; x and weights bf16."""
    rng = np.random.default_rng(seed)

    def t(a, bf16=False):
        out = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
        return out.to(torch.bfloat16) if bf16 else out

    def u(*shape, fan_in):
        return rng.uniform(-1, 1, shape) / np.sqrt(fan_in)

    return [
        t(rng.standard_normal((bw, 64, c)), bf16=True),
        t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
        t(u(c, 3 * c, fan_in=c), bf16=True), t(u(3 * c, fan_in=c)),
        t(0.5 * rng.standard_normal((heads, 64, 64))),
        t(u(c, c, fan_in=c), bf16=True), t(u(c, fan_in=c)),
        t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
        t(u(c, hidden, fan_in=c), bf16=True), t(u(hidden, fan_in=c)),
        t(u(hidden, c, fan_in=hidden), bf16=True), t(u(c, fan_in=hidden)),
    ]


def _rel_l2(got, want):
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bw,c,heads,hidden", WIDTHS)
def test_kernel_matches_plain_version(device, bw, c, heads, hidden):
    args = _operands(c + heads, bw, c, heads, hidden, device)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = fused_swin_block.launches
    got = fused_swin_block(*args, **kw)
    torch.cuda.synchronize()
    assert fused_swin_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (bw, 64, c)
    want = swin_block_reference(*args, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("bw,c,heads,hidden", WIDTHS)
def test_fwd_h_matches_plain_version_and_k1(device, bw, c, heads, hidden):
    args = _operands(c + heads + 1, bw, c, heads, hidden, device)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = swin_block_fwd_h.launches
    out, h = swin_block_fwd_h(*args, **kw)
    torch.cuda.synchronize()
    assert swin_block_fwd_h.launches == before + 1
    want_out, want_h = swin_block_fwd_h_reference(*args, **kw)
    # K1 computes K2's out in another kernel: the same rounding points, the
    # products summed in another order
    k1 = fused_swin_block(*args, **kw)
    for got, want in ((out, want_out), (h, want_h), (out, k1)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("bw", [1, 3, 7])
def test_fwd_h_at_odd_window_counts(device, bw):
    """K2 at window counts that leave its two-window blocks a dead
    warpgroup (1, 3, 7): out and h within K1's bound of the plain version,
    and two runs to the same bits."""
    args = _operands(bw + 11, bw, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    out, h = swin_block_fwd_h(*args, **kw)
    out2, h2 = swin_block_fwd_h(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(h, h2)
    for got, want in zip((out, h), swin_block_fwd_h_reference(*args, **kw)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.float().abs().max().item()), err


@pytest.mark.parametrize("bw", [1, 3, 7, 768])
def test_kernel_at_odd_window_counts_and_packed_once(device, bw):
    """K1 on its two-window wgmma blocks at window counts that leave a dead
    warpgroup (1, 3, 7) and at batch 3's 768: twice to the same bits, on
    weights packed once (as the inference forward passes them) to the bits
    of a call that packs them itself, within K1's bound of the plain
    version."""
    args = _operands(bw + 17, bw, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    before = fused_swin_block.launches
    got = fused_swin_block(*args, **kw)
    again = fused_swin_block(*args, **kw)
    packed = pack_swin_block_weights(args[3], args[6], args[10], args[12], num_heads=6)
    once = fused_swin_block(*args, **kw, packed=packed)
    torch.cuda.synchronize()
    assert fused_swin_block.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, once)
    want = swin_block_reference(*args, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("bw,c,heads,hidden", WIDTHS)
def test_bwd_kernels_match_plain_versions(device, bw, c, heads, hidden):
    args = _operands(c + heads + 2, bw, c, heads, hidden, device)
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = args
    gen = torch.Generator().manual_seed(c)
    h = torch.randn(bw, 64, c, generator=gen).to(device, torch.bfloat16)
    dout = (1e-2 * torch.randn(bw, 64, c, generator=gen)).to(device, torch.bfloat16)
    before = (swin_block_bwd_mlp.launches, swin_block_bwd_attn.launches)
    mlp = swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1, w2)
    attn = swin_block_bwd_attn(x, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                               num_heads=heads, scale=(c // heads) ** -0.5)
    torch.cuda.synchronize()
    assert (swin_block_bwd_mlp.launches, swin_block_bwd_attn.launches) == (
        before[0] + 1, before[1] + 1)
    want_mlp = swin_block_bwd_mlp_reference(h, dout, ln2_w, ln2_b, w1, b1, w2)
    want_attn = swin_block_bwd_attn_reference(x, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                                              num_heads=heads, scale=(c // heads) ** -0.5)
    names = ["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2",
             "dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    for name, got, want in zip(names, (*mlp, *attn), (*want_mlp, *want_attn)):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.isfinite(got).all(), name
        assert _rel_l2(got, want) <= BWD_REL_L2, (name, _rel_l2(got, want))


def test_bwd_kernels_are_reproducible(device):
    """Fixed summation order: two runs give the same bits."""
    args = _operands(7, 16, 180, 6, 720, device)
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj = args[:7]
    dh = (1e-2 * torch.randn(16, 64, 180, generator=torch.Generator().manual_seed(0))).to(
        device, torch.bfloat16)
    kw = dict(num_heads=6, scale=30**-0.5)
    first = swin_block_bwd_attn(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    second = swin_block_bwd_attn(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_kernel_raises_on_what_it_does_not_take(device):
    args = _operands(0, 2, 16, 2, 32, device)
    kw = dict(num_heads=2, scale=8**-0.5)
    before = (fused_swin_block.launches, swin_block_fwd_h.launches,
              swin_block_bwd_mlp.launches, swin_block_bwd_attn.launches)
    for fn in (fused_swin_block, swin_block_fwd_h):
        with pytest.raises(TypeError, match="bfloat16"):
            fn(args[0].float(), *args[1:], **kw)
        with pytest.raises(ValueError, match="N=64"):
            fn(args[0][:, :49].contiguous(), *args[1:], **kw)
        with pytest.raises(ValueError, match="device"):
            fn(*args[:5], args[5].cpu(), *args[6:], **kw)
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = args
    with pytest.raises(TypeError, match="bfloat16"):
        swin_block_bwd_mlp(x, x.float(), ln2_w, ln2_b, w1, b1, w2)
    with pytest.raises(ValueError, match="device"):
        swin_block_bwd_mlp(x, x, ln2_w.cpu(), ln2_b, w1, b1, w2)
    with pytest.raises(ValueError, match="N=64"):
        swin_block_bwd_attn(x[:, :49].contiguous(), x[:, :49].contiguous(), ln1_w, ln1_b, wqkv,
                            bqkv, bias, wproj, **kw)
    with pytest.raises(ValueError, match="w"):
        swin_block_bwd_attn(x, x, ln1_w, ln1_b, wqkv.float(), bqkv, bias, wproj, **kw)
    assert (fused_swin_block.launches, swin_block_fwd_h.launches,
            swin_block_bwd_mlp.launches, swin_block_bwd_attn.launches) == before


CFG = dict(img_size=32, in_chans=1, embed_dim=60, depths=(2, 2), num_heads=(2, 2),
           window_size=8, mlp_ratio=4.0, upscale=4)


def test_fused_swinir_matches_module(device):
    """bf16 fused forward against the fp32 module, the bound of chip_smoke.py."""
    model = SwinIR(**CFG, generator=torch.Generator().manual_seed(0)).to(device).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32, 1), dtype=np.float32))
    x = x.to(device)
    fused = make_fused_swinir(model)
    before = fused_swin_block.launches
    with torch.no_grad():
        want = model(x)
        got = fused(x).float()
    assert fused_swin_block.launches == before + 4
    assert got.shape == want.shape == (2, 128, 128, 1)
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= 2e-2


def test_differentiable_fused_swinir_backward_matches_module(device):
    """Gradients of the bf16 fused forward (K2 forward, K3 + K4 backward)
    against autograd of the fp32 module, through 2 stages of 2 blocks."""
    model = SwinIR(**CFG, generator=torch.Generator().manual_seed(1)).to(device)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((2, 32, 32, 1), dtype=np.float32)).to(device)
    probe = torch.from_numpy(rng.standard_normal((2, 128, 128, 1)).astype(np.float32))
    probe = probe.to(device)
    fused = make_fused_swinir(model, differentiable=True)
    checked = ["conv_first.weight", "layers.0.0.attn.qkv.weight",
               "layers.1.1.attn.relative_position_bias_table", "layers.1.0.mlp.fc1.weight",
               "layers.0.1.norm2.weight"]

    model16 = copy.deepcopy(model).to(torch.bfloat16)

    def grads(forward, net, dtype=torch.float32):
        xi = x.clone().to(dtype).requires_grad_()
        net.zero_grad()
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    want = grads(model, model)
    ref16 = grads(model16, model16, torch.bfloat16)
    counts = (swin_block_fwd_h.launches, swin_block_bwd_mlp.launches,
              swin_block_bwd_attn.launches, fused_swin_block.launches)
    got = grads(fused, model)
    assert (swin_block_fwd_h.launches, swin_block_bwd_mlp.launches,
            swin_block_bwd_attn.launches, fused_swin_block.launches) == (
        counts[0] + 4, counts[1] + 4, counts[2] + 4, counts[3])
    for name, g, w, r in zip(["input", *checked], got, want, ref16):
        assert torch.isfinite(g).all(), name
        err, err16 = _rel_l2(g, w), _rel_l2(r, w)
        print(f"{name}: fused bf16 {err:.4e}, nn.Module bf16 {err16:.4e}")
        assert err <= max(FUSED_GRAD_REL_L2, 2 * err16), (name, err, err16)
    with torch.no_grad():  # evaluation under no_grad goes through K1
        fused(x)
    assert fused_swin_block.launches == counts[3] + 4


def _hat_operands(seed, bw, c, heads, hidden, device, nk=None):
    """K5 operands (x, conv_x, then the 13 block parameters) or, with nk, K6
    operands (x, q, k, v, bias, then proj/LN2/MLP), numpy-seeded."""
    rng = np.random.default_rng(seed)

    def t(a, bf16=False):
        out = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
        return out.to(torch.bfloat16) if bf16 else out

    def u(*shape, fan_in):
        return rng.uniform(-1, 1, shape) / np.sqrt(fan_in)

    tail = [t(u(c, c, fan_in=c), bf16=True), t(u(c, fan_in=c)),
            t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
            t(u(c, hidden, fan_in=c), bf16=True), t(u(hidden, fan_in=c)),
            t(u(hidden, c, fan_in=hidden), bf16=True), t(u(c, fan_in=hidden))]
    if nk is not None:
        return [t(rng.standard_normal((bw, 64, c)), bf16=True),
                t(rng.standard_normal((bw, 64, c)), bf16=True),
                t(rng.standard_normal((bw, nk, c)), bf16=True),
                t(rng.standard_normal((bw, nk, c)), bf16=True),
                t(0.5 * rng.standard_normal((heads, 64, nk)))] + tail
    return [t(rng.standard_normal((bw, 64, c)), bf16=True),
            t(rng.standard_normal((bw, 64, c)), bf16=True),
            t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)),
            t(u(c, 3 * c, fan_in=c), bf16=True), t(u(3 * c, fan_in=c)),
            t(0.5 * rng.standard_normal((heads, 64, 64)))] + tail


HAT_WIDTHS = [
    (16, 90, 6, 360),   # HAT's widths: head_dim 15, padded to 16
    (8, 30, 6, 60),     # head_dim 5, padded to 6
    (4, 180, 6, 720),   # head_dim 30, padded to 32
]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("bw,c,heads,hidden", HAT_WIDTHS)
def test_hab_kernel_matches_plain_version(device, bw, c, heads, hidden, shifted):
    x, convx, *params = _hat_operands(c + heads, bw, c, heads, hidden, device)
    # the mask of one 16x16 image: four windows, so Bw holds several images
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device) if shifted else None
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5, conv_scale=0.01)
    before = fused_hab_block.launches
    got = fused_hab_block(x, convx, mask, *params, **kw)
    torch.cuda.synchronize()
    assert fused_hab_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (bw, 64, c)
    want = hab_block_reference(x, convx, mask, *params, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("bw,nw", [(3, 3), (7, 7), (9, 3)])
def test_hab_kernel_at_odd_window_counts(device, bw, nw, shifted):
    """K5 at HAT's widths (C = 90, heads of 15) on window counts that leave
    its two-window blocks a dead warpgroup, shifted with a mask of nW
    windows (nW dividing Bw, window w taking mask[w mod nW]) and unshifted:
    twice to the same bits, packed once to the bits of a call that pads and
    packs itself, within K1's bound of the plain version."""
    x, convx, *params = _hat_operands(bw + 31, bw, 90, 6, 360, device)
    rng = np.random.default_rng(bw)
    mask = (torch.from_numpy(np.where(rng.random((nw, 64, 64)) < 0.25, -100.0, 0.0)
                             .astype(np.float32)).to(device) if shifted else None)
    kw = dict(num_heads=6, scale=15**-0.5, conv_scale=0.01)
    before = fused_hab_block.launches
    got = fused_hab_block(x, convx, mask, *params, **kw)
    again = fused_hab_block(x, convx, mask, *params, **kw)
    padded = pad_hab_operands(*params[:4], *params[5:], num_heads=6)
    once = fused_hab_block(x, convx, mask, *params, **kw, padded=padded,
                           packed=pack_hab_weights(padded, num_heads=6))
    torch.cuda.synchronize()
    assert fused_hab_block.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, once)
    want = hab_block_reference(x, convx, mask, *params, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


def test_packed_weights_are_checked(device):
    """K1's, K5's and K6's ``packed`` must be the packing of their widths: a
    wrong size or dtype raises before any launch."""
    args = _operands(3, 2, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    packed = pack_swin_block_weights(args[3], args[6], args[10], args[12], num_heads=6)
    x, convx, *params = _hat_operands(4, 2, 90, 6, 360, device)
    hkw = dict(num_heads=6, scale=15**-0.5)
    padded = pad_hab_operands(*params[:4], *params[5:], num_heads=6)
    hpacked = pack_hab_weights(padded, num_heads=6)
    before = (fused_swin_block.launches, fused_hab_block.launches)
    with pytest.raises(ValueError, match="packed"):
        fused_swin_block(*args, **kw, packed=packed[:-8])
    with pytest.raises(ValueError, match="packed"):
        fused_swin_block(*args, **kw, packed=packed.float())
    with pytest.raises(ValueError, match="packed"):
        fused_hab_block(x, convx, None, *params, **hkw, padded=padded, packed=packed)
    with pytest.raises(ValueError, match="packed"):
        fused_hab_block(x, convx, None, *params, **hkw, padded=padded, packed=hpacked.cpu())
    oargs = _hat_operands(5, 2, 90, 6, 360, device, nk=144)
    opadded = pad_ocab_operands(*oargs[5:])
    opacked = pack_ocab_weights(opadded, num_heads=6, channels=90)
    before6 = fused_ocab_block.launches
    with pytest.raises(ValueError, match="packed"):
        fused_ocab_block(*oargs, **hkw, padded=opadded, packed=opacked[:-8])
    with pytest.raises(ValueError, match="packed"):
        fused_ocab_block(*oargs, **hkw, padded=opadded, packed=opacked.float())
    assert (fused_swin_block.launches, fused_hab_block.launches) == before
    assert fused_ocab_block.launches == before6


# and 14 heads of 9: odd heads land one slot in, and the heads' slots (14 x
# 16) outrun the residual's 128 columns
@pytest.mark.parametrize("bw,c,heads,hidden", HAT_WIDTHS + [(5, 126, 14, 252)])
def test_ocab_kernel_matches_plain_version(device, bw, c, heads, hidden):
    """K6 within K1's bound of its plain version, with the first 14 keys
    zero as the overlap gather leaves an edge window's; twice to the same
    bits, and on weights padded and packed once to the bits of a call that
    packs them itself."""
    args = _hat_operands(c + heads + 1, bw, c, heads, hidden, device, nk=144)
    args[2][:, :14] = 0
    args[3][:, :14] = 0
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = fused_ocab_block.launches
    got = fused_ocab_block(*args, **kw)
    again = fused_ocab_block(*args, **kw)
    padded = pad_ocab_operands(*args[5:])
    once = fused_ocab_block(*args, **kw, padded=padded,
                            packed=pack_ocab_weights(padded, num_heads=heads, channels=c))
    torch.cuda.synchronize()
    assert fused_ocab_block.launches == before + 3
    assert got.dtype == torch.bfloat16 and got.shape == (bw, 64, c)
    assert torch.equal(got, again) and torch.equal(got, once)
    want = ocab_block_reference(*args, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("store_h", [False, True])
@pytest.mark.parametrize("bw", [1, 7, 133, 2048])
def test_ocab_kernels_at_window_counts(device, bw, store_h):
    """K6 (and K10a, ``store_h``) at HAT's widths on window counts below,
    off and above one persistent wave of two-window blocks (2048: the
    hybrid's batch 8), the first 14 keys zero: within K1's bound of the
    plain version, twice to the same bits, and on weights packed once to the
    bits of a call that packs them itself."""
    args = _hat_operands(bw + 17, bw, 90, 6, 360, device, nk=144)
    args[2][:, :14] = 0
    args[3][:, :14] = 0
    kw = dict(num_heads=6, scale=15**-0.5)
    fn = ocab_fwd_h if store_h else fused_ocab_block
    padded = pad_ocab_operands(*args[5:])
    packed = pack_ocab_weights(padded, num_heads=6, channels=90)
    before = fn.launches
    runs = [fn(*args, **kw), fn(*args, **kw), fn(*args, **kw, padded=padded, packed=packed)]
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    runs = [r if store_h else (r,) for r in runs]
    assert all(torch.equal(a, b) for other in runs[1:] for a, b in zip(runs[0], other))
    wants = ocab_fwd_h_reference(*args, **kw)
    for got, want in zip(runs[0], wants):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


def _rdb_operands(seed, b, f, g, h, w, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(0.5 * rng.standard_normal((b, f, h * w)).astype(np.float32))
    ks = [torch.from_numpy((rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                            * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32)).to(device)
          for i in range(5)]
    bs = [torch.from_numpy((0.05 * rng.standard_normal(g if i < 4 else f)).astype(np.float32))
          .to(device) for i in range(5)]
    return x.to(device, torch.bfloat16), ks, bs


@pytest.mark.parametrize("f,g,h,w", [
    (48, 24, 20, 256),   # the hybrid's widths, a height off the 16-pixel tile
    (48, 24, 64, 64),
    (64, 32, 30, 64),    # the reference default widths (12-pixel tiles)
    (16, 8, 20, 256),
])
def test_rdb_kernel_matches_plain_version(device, f, g, h, w):
    x, ks, bs = _rdb_operands(f + h + w, 2, f, g, h, w, device)
    before = fused_rdb_cm.launches
    got = fused_rdb_cm(x, ks, bs, h=h, w=w)
    torch.cuda.synchronize()
    assert fused_rdb_cm.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = rdb_cm_reference(x, ks, bs, h=h, w=w).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


def test_hat_kernels_raise_on_what_they_do_not_take(device):
    x, convx, *params = _hat_operands(0, 4, 90, 6, 360, device)
    kw = dict(num_heads=6, scale=15**-0.5)
    oargs = _hat_operands(1, 4, 90, 6, 360, device, nk=144)
    xr, ks, bs = _rdb_operands(2, 1, 48, 24, 16, 16, device)
    before = (fused_hab_block.launches, fused_ocab_block.launches, fused_rdb_cm.launches)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_hab_block(x.float(), convx, None, *params, **kw)
    with pytest.raises(ValueError, match="N=64"):
        fused_hab_block(x[:, :49].contiguous(), convx[:, :49].contiguous(), None, *params, **kw)
    with pytest.raises(ValueError, match="mask"):
        fused_hab_block(x, convx, torch.zeros(3, 64, 64, device=device), *params, **kw)
    with pytest.raises(ValueError, match="device"):
        fused_hab_block(x, convx, None, *params[:4], params[4].cpu(), *params[5:], **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_ocab_block(oargs[0], oargs[1].float(), *oargs[2:], **kw)
    with pytest.raises(ValueError, match="144"):
        fused_ocab_block(*oargs[:2], torch.cat([oargs[2]] * 2, 1), torch.cat([oargs[3]] * 2, 1),
                         *oargs[4:], **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_rdb_cm(xr.float(), ks, bs, h=16, w=16)
    with pytest.raises(ValueError, match="not compiled"):
        fused_rdb_cm(xr[:, :40].contiguous(), [k[:, :, 8:] for k in ks], bs, h=16, w=16)
    with pytest.raises(ValueError, match="device"):
        fused_rdb_cm(xr, ks[:4] + [ks[4].cpu()], bs, h=16, w=16)
    assert (fused_hab_block.launches, fused_ocab_block.launches,
            fused_rdb_cm.launches) == before


HYBRID = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2, 2), num_heads=(6, 6),
              window_size=8, num_rrdb=2, num_feat=48, num_grow_ch=24)


def test_fused_hybrid_matches_module(device):
    """bf16 fused hybrid (K5, K6, K7) against the fp32 module: relative L2
    within max(2e-2, 2x the bf16 module's own distance)."""
    model = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 16, 32, 1), dtype=np.float32))
    x = x.to(device)
    fused = make_fused_hybrid(model)
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    before = (fused_hab_block.launches, fused_ocab_block.launches, fused_rdb_cm.launches)
    with torch.no_grad():
        want = model(x)
        got = fused(x).float()
        ref16 = model16(x.to(torch.bfloat16)).float()
    assert (fused_hab_block.launches, fused_ocab_block.launches, fused_rdb_cm.launches) == (
        before[0] + 4, before[1] + 2, before[2] + 6)
    assert got.shape == want.shape == (2, 64, 128, 1)
    assert torch.isfinite(got).all()
    err, err16 = _rel_l2(got, want), _rel_l2(ref16, want)
    print(f"fused bf16 {err:.4e}, nn.Module bf16 {err16:.4e}")
    assert err <= max(2e-2, 2 * err16), (err, err16)


def _k8_operands(seed, f, g, h, w, device):
    x, ks, bs = _rdb_operands(seed, 2, f, g, h, w, device)
    dy = 1e-2 * torch.randn(2, f, h * w, generator=torch.Generator().manual_seed(seed))
    return x, dy.to(device, torch.bfloat16), ks, bs


def _stashed(x, ks, bs, h, w):
    g = ks[0].shape[-1]
    stash = torch.empty(x.shape[0], h * w, x.shape[1] + 4 * g, dtype=torch.bfloat16,
                        device=x.device)
    return fused_rdb_cm(x, ks, bs, h=h, w=w, stash=stash), stash


@pytest.mark.parametrize("f,g,h,w", [
    (48, 24, 20, 256),   # the hybrid's widths, a height off the 16-pixel tile
    (48, 24, 64, 64),
    (64, 32, 30, 64),    # the reference default widths (8-pixel chain tiles)
    (16, 8, 20, 256),
])
def test_rdb_bwd_kernel_matches_plain_version(device, f, g, h, w):
    """K7's stash is x, x1..x4 and leaves its output as it was; K8's dx, dW and
    db each within BWD_REL_L2 of the plain version (relative L2), the bound
    of K3/K4: bf16 operands, and x1..x4 rounded from fp32 sums in another
    order than the plain version's convs."""
    x, dy, ks, bs = _k8_operands(f + h + w, f, g, h, w, device)
    out, stash = _stashed(x, ks, bs, h, w)
    assert torch.equal(out, fused_rdb_cm(x, ks, bs, h=h, w=w))
    srcs, _ = dense_block_sources(x, ks, bs, h=h, w=w)
    assert torch.equal(stash[..., :f], x.transpose(1, 2))
    want_stash = torch.cat(srcs[1:], 1).reshape(2, 4 * g, h * w).transpose(1, 2)
    assert _rel_l2(stash[..., f:], want_stash) <= BWD_REL_L2
    before = fused_rdb_cm_bwd.launches
    dx, dks, dbs = fused_rdb_cm_bwd(x, dy, ks, bs, h=h, w=w, stash=stash)
    torch.cuda.synchronize()
    assert fused_rdb_cm_bwd.launches == before + 1
    wdx, wdks, wdbs = rdb_cm_bwd_reference(x, dy, ks, bs, h=h, w=w)
    names = ["dx"] + [f"dW{i}" for i in range(1, 6)] + [f"db{i}" for i in range(1, 6)]
    for name, got, want in zip(names, (dx, *dks, *dbs), (wdx, *wdks, *wdbs)):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.isfinite(got).all(), name
        print(name, _rel_l2(got, want))
        assert _rel_l2(got, want) <= BWD_REL_L2, (name, _rel_l2(got, want))


def test_rdb_bwd_kernel_is_reproducible(device):
    """No atomics, the partial sums reduced in a fixed order: two runs give
    the same bits."""
    x, dy, ks, bs = _k8_operands(5, 48, 24, 64, 96, device)
    _, stash = _stashed(x, ks, bs, 64, 96)
    first = fused_rdb_cm_bwd(x, dy, ks, bs, h=64, w=96, stash=stash)
    second = fused_rdb_cm_bwd(x, dy, ks, bs, h=64, w=96, stash=stash)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1] + first[2], second[1] + second[2]))


def test_rdb_bwd_kernel_raises_on_what_it_does_not_take(device):
    x, dy, ks, bs = _k8_operands(6, 48, 24, 16, 16, device)
    _, stash = _stashed(x, ks, bs, 16, 16)
    before = fused_rdb_cm_bwd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fused_rdb_cm_bwd(x, dy.float(), ks, bs, h=16, w=16, stash=stash)
    with pytest.raises(ValueError, match="stash"):
        fused_rdb_cm_bwd(x, dy, ks, bs, h=16, w=16)
    with pytest.raises(ValueError, match="stash"):
        fused_rdb_cm_bwd(x, dy, ks, bs, h=16, w=16, stash=stash[:, :, :96].contiguous())
    with pytest.raises(ValueError, match="not compiled"):
        fused_rdb_cm_bwd(x[:, :40].contiguous(), dy[:, :40].contiguous(),
                         [k[:, :, 8:] for k in ks], bs, h=16, w=16, stash=stash)
    with pytest.raises(ValueError, match="device"):
        fused_rdb_cm_bwd(x, dy, ks[:4] + [ks[4].cpu()], bs, h=16, w=16, stash=stash)
    assert fused_rdb_cm_bwd.launches == before


def test_fused_hybrid_train_backward_matches_module(device):
    """Gradients of the differentiable fused hybrid (bf16 HAT module, K7/K8
    trunk) against autograd of the fp32 module: each checked gradient's
    relative L2 within max(2e-2, 2x the bf16 module's own distance)."""
    model = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(1)).to(device)
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 16, 32, 1), dtype=np.float32))
    probe = torch.randn(2, 64, 128, 1, generator=torch.Generator().manual_seed(2)).to(device)
    checked = ["hat.conv_first.weight", "conv_adapt.weight", "rrdb_trunk.0.rdb1.conv1.weight",
               "rrdb_trunk.1.rdb3.conv5.bias", "conv_last.weight"]

    def grads(forward, net, dtype):
        xi = x.to(device, dtype).requires_grad_()
        net.zero_grad(set_to_none=True)
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    before = (fused_rdb_cm.launches, fused_rdb_cm_bwd.launches)
    got = grads(make_fused_hybrid_train(model), model, torch.float32)
    assert (fused_rdb_cm.launches, fused_rdb_cm_bwd.launches) == (before[0] + 6, before[1] + 6)
    want = grads(model, model, torch.float32)
    ref16 = grads(model16, model16, torch.bfloat16)
    for name, g, w, r in zip(["input", *checked], got, want, ref16):
        err, err16 = _rel_l2(g, w), _rel_l2(r, w)
        print(name, err, err16)
        assert torch.isfinite(g).all() and err <= max(2e-2, 2 * err16), (name, err, err16)


def test_fused_hybrid_train_step_runs_the_kernels(device):
    """A tiny GAN step and a warmup step with the fused trunk: K7 and K8 run
    3 x num_rrdb times per micro-batch, the losses are finite, G moves, and
    D moves only in the GAN step."""
    from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step

    state = create_hat_train_state(torch.Generator().manual_seed(0), img_size=16, embed_dim=30,
                                   depths=(2,), num_heads=(6,), num_rrdb=2, num_feat=48,
                                   num_grow_ch=24, dtype=torch.bfloat16, fused=True,
                                   device=device)
    step = make_hat_train_step(state, accum_steps=2)
    rng = np.random.default_rng(0)
    batch = {"lr": rng.integers(0, 65535, (2, 2, 16, 16, 1), dtype=np.uint16),
             "hr": rng.integers(0, 65535, (2, 2, 64, 64, 1), dtype=np.uint16)}
    key = "rrdb_trunk.0.rdb1.conv1.weight"
    for warmup in (True, False):
        g0 = state.g.state_dict()[key].clone()
        d0 = {k: v.clone() for k, v in state.d.state_dict().items()}
        before = (fused_rdb_cm.launches, fused_rdb_cm_bwd.launches)
        m = step(batch, 1e-4, 1e-4, warmup=warmup)
        assert (fused_rdb_cm.launches, fused_rdb_cm_bwd.launches) == (before[0] + 12,
                                                                      before[1] + 12)
        assert all(np.isfinite(float(v)) for v in m.values()), m
        assert not torch.equal(state.g.state_dict()[key], g0)
        d_same = all(torch.equal(v, d0[k]) for k, v in state.d.state_dict().items())
        assert d_same == warmup


def _dp(bw, device, drop=1):
    """Per-window branch scales of images of 4 windows: image ``drop`` is
    dropped, the others kept and scaled by 1 / 0.9."""
    per_image = torch.full((bw // 4,), 1 / 0.9)
    per_image[drop] = 0.0
    return per_image.repeat_interleave(4).to(device)


def _windows(seed, bw, c, n, device, std=1e-2):
    g = torch.Generator().manual_seed(seed)
    return (std * torch.randn(bw, n, c, generator=g)).to(device, torch.bfloat16)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("bw,c,heads,hidden", HAT_WIDTHS)
def test_hab_train_kernels_match_plain_versions(device, bw, c, heads, hidden, shifted):
    """K9a's (out, h) within K1's bound, K9b's and K9c's outputs within
    BWD_REL_L2 (relative L2) of their plain versions; the dropped image's
    windows pass the cotangent through unchanged (dh = dout, dx = dh)."""
    bw = max(bw, 8)  # two images at least: one kept, one dropped
    x, convx, *params = _hat_operands(c + heads + 7, bw, c, heads, hidden, device)
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device) if shifted else None
    dp1, dp2 = _dp(bw, device, 1), _dp(bw, device, 0)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = (hab_fwd_h.launches, hab_bwd_mlp.launches, hab_bwd_attn.launches)
    out, h = hab_fwd_h(x, convx, mask, dp1, dp2, *params, **kw, conv_scale=0.01)
    torch.cuda.synchronize()
    want_out, want_h = hab_fwd_h_reference(x, convx, mask, dp1, dp2, *params, **kw,
                                           conv_scale=0.01)
    for got, want in ((out, want_out), (h, want_h)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.float().abs().max().item()), err
    ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = params
    dout = _windows(bw, bw, c, 64, device)
    mlp = hab_bwd_mlp(h, dout, dp2, ln2_w, ln2_b, w1, b1, w2)
    want_mlp = hab_bwd_mlp_reference(h, dout, dp2, ln2_w, ln2_b, w1, b1, w2)
    attn = hab_bwd_attn(x, mlp[0], mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    want_attn = hab_bwd_attn_reference(x, mlp[0], mask, dp1, ln1_w, ln1_b, wqkv, bqkv, bias,
                                       wproj, **kw)
    torch.cuda.synchronize()
    assert (hab_fwd_h.launches, hab_bwd_mlp.launches, hab_bwd_attn.launches) == tuple(
        b + 1 for b in before)
    names = ["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2",
             "dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    for name, got, want in zip(names, (*mlp, *attn), (*want_mlp, *want_attn)):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.isfinite(got).all(), name
        print(name, _rel_l2(got, want))
        assert _rel_l2(got, want) <= BWD_REL_L2, (name, _rel_l2(got, want))
    assert torch.equal(mlp[0][:4], dout[:4])        # image 0's MLP branch dropped
    assert torch.equal(attn[0][4:8], mlp[0][4:8])   # image 1's attention branch dropped


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("bw,nw", [(3, 3), (7, 7), (9, 3)])
def test_hab_fwd_h_at_odd_window_counts(device, bw, nw, shifted, scaled):
    """K9a at HAT's widths on window counts that leave its two-window blocks
    a dead warpgroup, shifted by a mask of nW windows and unshifted, with no
    branch scales and with per-window ones (zero on dropped windows, 1 / 0.9
    on kept ones): (out, h) within K1's bound of the plain version, twice to
    the same bits; a window whose MLP branch is dropped has out = h."""
    x, convx, *params = _hat_operands(bw + 61, bw, 90, 6, 360, device)
    rng = np.random.default_rng(bw + 1)
    mask = (torch.from_numpy(np.where(rng.random((nw, 64, 64)) < 0.25, -100.0, 0.0)
                             .astype(np.float32)).to(device) if shifted else None)
    dp1 = dp2 = None
    if scaled:
        keep = rng.random((2, bw)) < 0.6
        keep[:, 0] = [True, False]  # window 0: attention kept, MLP dropped
        dp1, dp2 = (torch.from_numpy(np.where(k, 1 / 0.9, 0.0).astype(np.float32)).to(device)
                    for k in keep)
    kw = dict(num_heads=6, scale=15**-0.5, conv_scale=0.01)
    before = hab_fwd_h.launches
    out, h = hab_fwd_h(x, convx, mask, dp1, dp2, *params, **kw)
    out2, h2 = hab_fwd_h(x, convx, mask, dp1, dp2, *params, **kw)
    torch.cuda.synchronize()
    assert hab_fwd_h.launches == before + 2
    assert torch.equal(out, out2) and torch.equal(h, h2)
    wants = hab_fwd_h_reference(x, convx, mask, dp1, dp2, *params, **kw)
    for got, want in zip((out, h), wants):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.abs().max().item()), err
    if scaled:
        assert torch.equal(out[0], h[0])


@pytest.mark.parametrize("bw,c,heads,hidden", HAT_WIDTHS)
def test_ocab_train_kernels_match_plain_versions(device, bw, c, heads, hidden):
    """K10a's (out, h) within K1's bound and K10b's outputs within BWD_REL_L2
    of their plain versions, with the first 14 keys zero as the overlap
    gather's padding leaves them."""
    args = _hat_operands(c + heads + 8, bw, c, heads, hidden, device, nk=144)
    args[2][:, :14] = 0
    args[3][:, :14] = 0
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = (ocab_fwd_h.launches, ocab_bwd_attn.launches)
    out, h = ocab_fwd_h(*args, **kw)
    torch.cuda.synchronize()
    for got, want in zip((out, h), ocab_fwd_h_reference(*args, **kw)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.float().abs().max().item()), err
    dh = _windows(bw + 1, bw, c, 64, device)
    q, k, v, bias, wproj = args[1], args[2], args[3], args[4], args[5]
    got = ocab_bwd_attn(q, k, v, dh, bias, wproj, **kw)
    torch.cuda.synchronize()
    assert (ocab_fwd_h.launches, ocab_bwd_attn.launches) == tuple(b + 1 for b in before)
    want = ocab_bwd_attn_reference(q, k, v, dh, bias, wproj, **kw)
    for name, g, w in zip(["dq", "dk", "dv", "dbias", "dwproj", "dbproj"], got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        print(name, _rel_l2(g, w))
        assert _rel_l2(g, w) <= BWD_REL_L2, (name, _rel_l2(g, w))


@pytest.mark.parametrize("bw,c,heads,nk", [
    (1, 90, 6, 144),     # one block
    (7, 90, 6, 144),     # one window a block
    (133, 90, 6, 144),   # two windows a block, the last block with one
    (512, 90, 6, 144),   # the fused-HAB step's windows
    (5, 45, 3, 120),     # an odd width (a zero channel added), an odd head count, fewer keys
])
def test_ocab_bwd_attn_over_window_counts(device, bw, c, heads, nk):
    """K10b's persistent blocks at window counts below, off and above one
    wave of the card's SMs: every output within BWD_REL_L2 of the plain
    version, twice to the same bits."""
    args = _hat_operands(bw + c + nk, bw, c, heads, 4 * c, device, nk=nk)
    args[2][:, :14] = 0
    args[3][:, :14] = 0
    q, k, v, bias, wproj = args[1], args[2], args[3], args[4], args[5]
    dh = _windows(bw + 2, bw, c, 64, device)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    before = ocab_bwd_attn.launches
    got = ocab_bwd_attn(q, k, v, dh, bias, wproj, **kw)
    again = ocab_bwd_attn(q, k, v, dh, bias, wproj, **kw)
    torch.cuda.synchronize()
    assert ocab_bwd_attn.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ocab_bwd_attn_reference(q, k, v, dh, bias, wproj, **kw)
    for name, g, w in zip(["dq", "dk", "dv", "dbias", "dwproj", "dbproj"], got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= BWD_REL_L2, (name, _rel_l2(g, w))


def test_hab_and_ocab_backwards_are_reproducible(device):
    """No atomics, the per-window sums reduced in a fixed order: two runs of
    K9b, K9c and K10b give the same bits."""
    x, convx, *params = _hat_operands(40, 16, 90, 6, 360, device)
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device)
    dp = _dp(16, device)
    ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = params
    h = _windows(41, 16, 90, 64, device, std=1.0)
    dout = _windows(42, 16, 90, 64, device)
    oargs = _hat_operands(43, 16, 90, 6, 360, device, nk=144)
    runs = [(*hab_bwd_mlp(h, dout, dp, ln2_w, ln2_b, w1, b1, w2),
             *hab_bwd_attn(x, dout, mask, dp, ln1_w, ln1_b, wqkv, bqkv, bias, wproj,
                           num_heads=6, scale=15**-0.5),
             *ocab_bwd_attn(*oargs[1:4], dout, *oargs[4:6], num_heads=6, scale=15**-0.5))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_hab_train_kernels_raise_on_what_they_do_not_take(device):
    x, convx, *params = _hat_operands(50, 8, 90, 6, 360, device)
    ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = params
    oargs = _hat_operands(51, 8, 90, 6, 360, device, nk=144)
    kw = dict(num_heads=6, scale=15**-0.5)
    dp = _dp(8, device)
    before = (hab_fwd_h.launches, hab_bwd_mlp.launches, hab_bwd_attn.launches,
              ocab_fwd_h.launches, ocab_bwd_attn.launches)
    with pytest.raises(TypeError, match="bfloat16"):
        hab_fwd_h(x.float(), convx, None, dp, dp, *params, **kw)
    with pytest.raises(ValueError, match="branch scale"):
        hab_fwd_h(x, convx, None, dp[:4], dp, *params, **kw)
    # K9a copies conv_x as whole 16-byte runs: a window tensor 2 bytes off is
    # refused, not copied
    shifted_convx = torch.empty(convx.numel() + 1, dtype=torch.bfloat16,
                                device=device)[1:].view(convx.shape)
    shifted_convx.copy_(convx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hab_fwd_h(x, shifted_convx, None, dp, dp, *params, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        hab_bwd_mlp(x, x.float(), dp, ln2_w, ln2_b, w1, b1, w2)
    with pytest.raises(ValueError, match="branch scale"):
        hab_bwd_mlp(x, x, dp.cpu(), ln2_w, ln2_b, w1, b1, w2)
    with pytest.raises(ValueError, match="unsupported width"):  # 90 is not 4 heads' multiple
        hab_bwd_attn(x, x, None, dp, ln1_w, ln1_b, wqkv, bqkv, bias[:4], wproj, num_heads=4,
                     scale=1.0)
    with pytest.raises(ValueError, match="mask"):
        hab_bwd_attn(x, x, torch.zeros(3, 64, 64, device=device), dp, ln1_w, ln1_b, wqkv, bqkv,
                     bias, wproj, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        ocab_fwd_h(oargs[0].float(), *oargs[1:], **kw)
    with pytest.raises(ValueError, match="144"):
        ocab_bwd_attn(oargs[1], torch.cat([oargs[2]] * 2, 1), torch.cat([oargs[3]] * 2, 1),
                      oargs[0], oargs[4], oargs[5], **kw)
    with pytest.raises(ValueError, match="device"):
        ocab_bwd_attn(*oargs[1:4], oargs[0], oargs[4].cpu(), oargs[5], **kw)
    assert (hab_fwd_h.launches, hab_bwd_mlp.launches, hab_bwd_attn.launches,
            ocab_fwd_h.launches, ocab_bwd_attn.launches) == before


def test_fused_hab_hybrid_train_step_runs_the_kernels(device):
    """A tiny GAN step with the fused HAB and OCAB training path: per
    micro-batch K9a, K9c once per HAB, K9b once per HAB and OCAB, K10a and
    K10b once per OCAB, K7/K8 3 x num_rrdb times; the losses are finite and
    G's backbone moves. Then the same hybrid's fused-HAB gradients against
    the module's: each within max(2e-2, 2x the bf16 module's distance)."""
    from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step

    state = create_hat_train_state(torch.Generator().manual_seed(0), img_size=16, embed_dim=90,
                                   depths=(2, 2), num_heads=(6, 6), num_rrdb=1, num_feat=48,
                                   num_grow_ch=24, dtype=torch.bfloat16, fused=True,
                                   fused_hab=True, device=device)
    step = make_hat_train_step(state, accum_steps=2)
    rng = np.random.default_rng(0)
    batch = {"lr": rng.integers(0, 65535, (2, 2, 16, 16, 1), dtype=np.uint16),
             "hr": rng.integers(0, 65535, (2, 2, 64, 64, 1), dtype=np.uint16)}
    counters = (hab_fwd_h, hab_bwd_mlp, hab_bwd_attn, ocab_fwd_h, ocab_bwd_attn, fused_rdb_cm,
                fused_rdb_cm_bwd)
    before = [fn.launches for fn in counters]
    key = "hat.layers.0.residual_group.blocks.1.attn.qkv.weight"
    g0 = state.g.state_dict()[key].clone()
    m = step(batch, 1e-4, 1e-4)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [8, 12, 8, 4, 4, 6, 6]
    assert all(np.isfinite(float(v)) for v in m.values()), m
    assert not torch.equal(state.g.state_dict()[key], g0)

    model = state.g
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    x = torch.from_numpy(rng.random((2, 16, 32, 1), dtype=np.float32))
    probe = torch.randn(2, 64, 128, 1, generator=torch.Generator().manual_seed(2)).to(device)
    checked = ["hat.conv_first.weight", key, "hat.layers.1.residual_group.overlap_attn.qkv.weight",
               "hat.layers.0.residual_group.blocks.0.attn.relative_position_bias_table",
               "conv_adapt.weight"]

    def grads(forward, net, dtype):
        xi = x.to(device, dtype).requires_grad_()
        net.zero_grad(set_to_none=True)
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    got = grads(make_fused_hybrid_train(model, fused_hab=True), model, torch.float32)
    want = grads(model, model, torch.float32)
    ref16 = grads(model16, model16, torch.bfloat16)
    for name, g, w, r in zip(["input", *checked], got, want, ref16):
        err, err16 = _rel_l2(g, w), _rel_l2(r, w)
        print(name, err, err16)
        assert torch.isfinite(g).all() and err <= max(2e-2, 2 * err16), (name, err, err16)


def _attention_views(seed, layout, bw, heads, hd, nk, dtype, device):
    """q, k, v and a (heads, 64, nk) bias, q, k and v laid out as ``layout``
    says: "qkv" the modules' views of one (Bw, 64, 3, heads, hd) tensor (nk =
    64), "ocab" q of its own (Bw, 64, heads, hd) and k, v the halves of one
    (Bw, nk, 2, heads, hd), "shifted" each a view one element into a buffer of
    even rows (every head at an odd element), "contiguous" (Bw, heads, rows,
    hd) each."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)

    if layout == "qkv":
        qkv = t(bw, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    elif layout == "ocab":
        q = t(bw, 64, heads, hd).transpose(1, 2)
        kv = t(bw, nk, 2, heads, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    elif layout == "shifted":
        q, k, v = (t(bw, heads, n, hd + 2 - hd % 2)[..., 1:hd + 1] for n in (64, nk, nk))
    else:
        q, k, v = (t(bw, heads, n, hd) for n in (64, nk, nk))
    bias = torch.from_numpy(0.5 * rng.standard_normal((heads, 64, nk)).astype(np.float32))
    return q, k, v, bias.to(device)


def _attention_operands(seed, bw, heads, hd, nk, dtype, device):
    """q, k, v as strided views: for nk = 64 the three slices of one (Bw, 64,
    3, heads, hd) qkv tensor, as the modules pass them; for nk = 144 q of its
    own and k, v the two halves of one (Bw, 144, 2, heads, hd) tensor."""
    return _attention_views(seed, "qkv" if nk == 64 else "ocab", bw, heads, hd, nk, dtype, device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nk", [64, 144])
@pytest.mark.parametrize("hd", [5, 15, 30, 32])
def test_window_attention_kernel_matches_plain_version(device, hd, nk, masked, dtype):
    bw, heads = 8, 3
    q, k, v, bias = _attention_operands(hd + nk, bw, heads, hd, nk, dtype, device)
    mask = None
    if masked:  # two (or, at 144 keys, one) windows' worth of 0 / -100 entries
        mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device)
        mask = torch.cat([mask] * 3, -1)[..., :nk].contiguous()
    fn = window_attention_masked if masked else window_attention_nomask
    before = fn.launches
    with torch.no_grad():
        got = window_attention(q, k, v, bias, mask, scale=hd**-0.5, impl="pallas")
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == dtype and got.shape == (bw, heads, 64, hd) and got.is_contiguous()
    want = window_attention_reference(q, k, v, bias, mask, scale=hd**-0.5)
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:
        assert _rel_l2(got, want) <= 1e-3, _rel_l2(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-5


def test_window_attention_kernel_raises_on_what_it_does_not_take(device):
    q, k, v, bias = _attention_operands(0, 8, 3, 15, 64, torch.bfloat16, device)
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device)
    kw = dict(scale=15**-0.5)
    before = (window_attention_nomask.launches, window_attention_masked.launches)
    with pytest.raises(RuntimeError, match="forward-only"):
        window_attention(q.requires_grad_(), k, v, bias, impl="pallas", **kw)
    q = q.detach()
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        window_attention_nomask(q.half(), k.half(), v.half(), bias, **kw)
    with pytest.raises(ValueError, match="Nq=64"):
        window_attention_nomask(q[:, :, :49], k, v, bias[:, :49], **kw)
    with pytest.raises(ValueError, match="Nk<=144"):
        window_attention_nomask(q, torch.cat([k] * 3, 2), torch.cat([v] * 3, 2),
                                torch.cat([bias] * 3, 2), **kw)
    with pytest.raises(ValueError, match="mask"):
        window_attention_masked(q[:6], k[:6], v[:6], bias, mask, **kw)
    with pytest.raises(ValueError, match="device"):
        window_attention_nomask(q, k, v, bias.cpu(), **kw)
    assert (window_attention_nomask.launches, window_attention_masked.launches) == before


# the window counts: one, a few, and counts that divide neither by the 132
# SMs nor by a block's consumers; nW a divisor below Bw where there is one
ATTN_NW = {1: 1, 3: 1, 133: 7, 265: 5}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["qkv", "ocab", "shifted", "contiguous"])
@pytest.mark.parametrize("heads,hd", [(1, 31), (6, 15), (14, 6)])
@pytest.mark.parametrize("bw", sorted(ATTN_NW))
def test_window_attention_kernel_at_window_and_head_counts(device, bw, heads, hd, layout, dtype):
    """K11 with and without a mask of nW | Bw windows against its plain
    version, twice to the same bits, on views with even and odd row strides
    and heads at odd elements; the bf16 gather repacks exactly the operands
    gather_plan names (none with even rows)."""
    nk = 64 if layout == "qkv" else 144
    q, k, v, bias = _attention_views(bw + heads + hd, layout, bw, heads, hd, nk, dtype, device)
    mrng = np.random.default_rng(bw)
    mask = torch.from_numpy(-100.0 * (mrng.random((ATTN_NW[bw], 64, nk)) < 0.3)).float()
    mask = mask.to(device)
    plan = gather_plan(q, k, v)
    if dtype == torch.bfloat16 and layout != "contiguous" and (layout == "shifted" or (
            heads * hd) % 2 == 0):
        assert plan.repack == (False, False, False), plan
    for fn, m in ((window_attention_nomask, None), (window_attention_masked, mask)):
        before = (fn.launches, fn.repacks)
        args = (q, k, v, bias) + (() if m is None else (m,))
        got = fn(*args, scale=hd**-0.5)
        again = fn(*args, scale=hd**-0.5)
        torch.cuda.synchronize()
        repacked = sum(plan.repack) if dtype == torch.bfloat16 else 0
        assert (fn.launches, fn.repacks) == (before[0] + 2, before[1] + 2 * repacked)
        assert got.dtype == dtype and got.shape == (bw, heads, 64, hd) and got.is_contiguous()
        assert torch.equal(got, again)
        want = window_attention_reference(q, k, v, bias, m, scale=hd**-0.5)
        assert torch.isfinite(got).all()
        if dtype == torch.bfloat16:
            assert _rel_l2(got, want) <= 1e-3, _rel_l2(got, want)
        else:
            assert (got - want).abs().max().item() <= 1e-5


def test_window_attention_flagship_views_take_no_copy(device):
    """The modules' views at the flagship widths (SwinIR's C = 180, HAT's
    HAB and OCAB at C = 90, 6 heads) reach the 4-byte gather as they are: no
    repack and no allocation beyond out; and the attention modules' forwards
    repack nothing."""
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)).to(device)
    for layout, hd, nk, m in (("qkv", 30, 64, None), ("qkv", 15, 64, None), ("qkv", 15, 64, mask),
                              ("ocab", 15, 144, None)):
        q, k, v, bias = _attention_views(hd, layout, 16, 6, hd, nk, torch.bfloat16, device)
        assert gather_plan(q, k, v) == (32 if hd > 15 else 16, (False, False, False))
        fn = window_attention_nomask if m is None else window_attention_masked
        args = (q, k, v, bias) + (() if m is None else (m,))
        fn(*args, scale=hd**-0.5)
        torch.cuda.synchronize()
        before = (fn.repacks, torch.cuda.memory_stats(device)["allocation.all.allocated"])
        fn(*args, scale=hd**-0.5)
        torch.cuda.synchronize()
        assert (fn.repacks, torch.cuda.memory_stats(device)["allocation.all.allocated"]) == (
            before[0], before[1] + 1)
    swin_cfg = dict(img_size=16, embed_dim=60, depths=(2,), num_heads=(6,), window_size=8,
                    upscale=4)
    x = torch.rand(2, 16, 32, 1, device=device, dtype=torch.bfloat16)
    for cls, cfg in ((SwinIR, swin_cfg), (HybridHATRealESRGAN, HYBRID)):
        model = cls(**cfg, attn_impl="pallas").to(device, torch.bfloat16).eval()
        before = [(fn.launches, fn.repacks) for fn in (window_attention_nomask,
                                                       window_attention_masked)]
        with torch.no_grad():
            model(x)
        after = [(fn.launches, fn.repacks) for fn in (window_attention_nomask,
                                                      window_attention_masked)]
        assert after[0][0] > before[0][0]
        assert [a[1] for a in after] == [b[1] for b in before], cls.__name__


@pytest.mark.parametrize("f,g,h,w", [
    (48, 24, 20, 256),   # the hybrid's widths, a height off the 16-pixel tile
    (48, 24, 40, 24),    # neither side a tile multiple
    (64, 32, 30, 64),    # the reference default widths (12-pixel tiles)
    (16, 8, 20, 256),
])
def test_rdb_nhwc_kernel_matches_plain_version_and_k7(device, f, g, h, w):
    xf, ks, bs = _rdb_operands(f + h + w + 1, 2, f, g, h, w, device)
    x = xf.reshape(2, f, h, w).permute(0, 2, 3, 1).contiguous()
    before = fused_rdb.launches
    got = fused_rdb(x, ks, bs)
    torch.cuda.synchronize()
    assert fused_rdb.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = rdb_nhwc_reference(x, ks, bs).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err
    # K12 runs K7's conv kernels on K7's packing, only x read in place: the
    # same products in the same order
    k7 = fused_rdb_cm(xf, ks, bs, h=h, w=w).reshape(2, f, h, w).permute(0, 2, 3, 1)
    err = (got.float() - k7.float()).abs().max().item()
    assert err <= K1_TOL * max(1.0, k7.float().abs().max().item()), err
    assert torch.equal(got, k7)


def test_rdb_nhwc_kernel_raises_on_what_it_does_not_take(device):
    xf, ks, bs = _rdb_operands(3, 1, 48, 24, 16, 16, device)
    x = xf.reshape(1, 48, 16, 16).permute(0, 2, 3, 1).contiguous()
    before = fused_rdb.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fused_rdb(x.float(), ks, bs)
    with pytest.raises(ValueError, match="not compiled"):
        fused_rdb(x[..., :40].contiguous(), [k[:, :, 8:] for k in ks], bs)
    with pytest.raises(ValueError, match="device"):
        fused_rdb(x, ks[:4] + [ks[4].cpu()], bs)
    assert fused_rdb.launches == before


def test_attention_modules_run_the_window_attention_kernel(device):
    """bf16 SwinIR and hybrid nn.Modules with attn_impl="pallas" against the
    fp32 "xla" modules: relative L2 within max(2e-2, 2x the bf16 "xla"
    module's own distance), and the launches a forward makes."""
    x = torch.from_numpy(np.random.default_rng(1).random((2, 16, 32, 1), dtype=np.float32))
    x = x.to(device)
    swin_cfg = dict(img_size=16, embed_dim=60, depths=(2, 2), num_heads=(6, 6), window_size=8,
                    upscale=4)
    cases = [(SwinIR, swin_cfg, {"nomask": 4, "masked": 0}),
             # per stage: the unshifted HAB (no mask), the shifted one, the OCAB
             (HybridHATRealESRGAN, HYBRID, {"nomask": 4, "masked": 2})]
    for cls, cfg, launches in cases:
        ref = cls(**cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
        pallas16 = cls(**cfg, attn_impl="pallas").to(device, torch.bfloat16).eval()
        pallas16.load_state_dict(ref.state_dict())
        xla16 = copy.deepcopy(ref).to(torch.bfloat16)
        before = (window_attention_nomask.launches, window_attention_masked.launches)
        with torch.no_grad():
            want = ref(x)
            got = pallas16(x.to(torch.bfloat16)).float()
            ref16 = xla16(x.to(torch.bfloat16)).float()
        assert (window_attention_nomask.launches - before[0],
                window_attention_masked.launches - before[1]) == (
            launches["nomask"], launches["masked"])
        assert torch.isfinite(got).all() and got.shape == want.shape
        err, err16 = _rel_l2(got, want), _rel_l2(ref16, want)
        print(cls.__name__, f"pallas bf16 {err:.4e}, xla bf16 {err16:.4e}")
        assert err <= max(2e-2, 2 * err16), (cls.__name__, err, err16)


def test_fused_hybrid_kernel_trunk_matches_cm_trunk(device):
    """make_fused_hybrid(trunk_impl="kernel") (K12) and the default K7
    trunk, each held to the fp32 module at max(2e-2, 2x the bf16 module's
    own distance), as chip_smoke.py's phases 14 and 29 hold them."""
    model = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    x = torch.from_numpy(np.random.default_rng(2).random((2, 16, 24, 1), dtype=np.float32))
    x = x.to(device)
    before = (fused_rdb.launches, fused_rdb_cm.launches)
    got = make_fused_hybrid(model, trunk_impl="kernel")(x)
    mid = (fused_rdb.launches, fused_rdb_cm.launches)
    cm = make_fused_hybrid(model)(x)
    assert mid == (before[0] + 6, before[1])
    assert fused_rdb_cm.launches == before[1] + 6
    with torch.no_grad():
        want = model(x)
        ref16 = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    err16 = _rel_l2(ref16, want)
    for name, out in (("K12 trunk", got), ("K7 trunk", cm)):
        err = _rel_l2(out, want)
        print(f"{name}: rel L2 to fp32 {err:.3e}, nn.Module bf16 {err16:.3e}")
        assert torch.isfinite(out).all() and err <= max(2e-2, 2 * err16), (name, err, err16)


BWD_NAMES = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj", "dln2_w",
             "dln2_b", "dw1", "db1", "dw2", "db2"]


# K4b at window counts that leave its two-window blocks a dead warpgroup,
# and at 263, whose last wave of the persistent phases is ragged
ODD_BW = [(1, 180, 6, 720), (3, 180, 6, 720), (7, 180, 6, 720), (263, 180, 6, 720)]


@pytest.mark.parametrize("bw,c,heads,hidden", WIDTHS + ODD_BW)
def test_block_bwd_kernel_matches_plain_version_and_split(device, bw, c, heads, hidden):
    args = _operands(c + heads + 3, bw, c, heads, hidden, device)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5)
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = args
    gen = torch.Generator().manual_seed(c + 1)
    dout = (1e-2 * torch.randn(bw, 64, c, generator=gen)).to(device, torch.bfloat16)
    before = swin_block_bwd.launches
    got = swin_block_bwd(x, dout, *args[1:], **kw)
    torch.cuda.synchronize()
    assert swin_block_bwd.launches == before + 1
    want = swin_block_bwd_reference(x, dout, *args[1:], **kw)
    _, h = swin_block_fwd_h(*args, **kw)
    dh, dln2_w, dln2_b, dw1, db1, dw2, db2 = swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1,
                                                                w2)
    dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj = swin_block_bwd_attn(
        x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    split = (dx, dln1_w, dln1_b, dwqkv, dbqkv, dbias, dwproj, dbproj, dln2_w, dln2_b, dw1, db1,
             dw2, db2)
    for name, g, w, sp in zip(BWD_NAMES, got, want, split):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= BWD_REL_L2, (name, _rel_l2(g, w))
        assert _rel_l2(g, sp) <= BWD_REL_L2, (name, "vs K3 + K4", _rel_l2(g, sp))


@pytest.mark.parametrize("bw", [16, 1, 3, 7, 263])
def test_block_bwd_kernel_is_reproducible(device, bw):
    """Fixed summation order, no atomics: two runs give the same bits."""
    args = _operands(8, bw, 180, 6, 720, device)
    dout = (1e-2 * torch.randn(bw, 64, 180, generator=torch.Generator().manual_seed(1))).to(
        device, torch.bfloat16)
    kw = dict(num_heads=6, scale=30**-0.5)
    first = swin_block_bwd(args[0], dout, *args[1:], **kw)
    second = swin_block_bwd(args[0], dout, *args[1:], **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_block_bwd_kernel_raises_on_what_it_does_not_take(device):
    args = _operands(0, 2, 16, 2, 32, device)
    kw = dict(num_heads=2, scale=8**-0.5)
    x = args[0]
    before = swin_block_bwd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        swin_block_bwd(x.float(), x.float(), *args[1:], **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        swin_block_bwd(x, x.float(), *args[1:], **kw)
    with pytest.raises(ValueError, match="device"):
        swin_block_bwd(x, x, *args[1:5], args[5].cpu(), *args[6:], **kw)
    with pytest.raises(ValueError, match="device"):
        swin_block_bwd(x, x.cpu(), *args[1:], **kw)
    with pytest.raises(ValueError, match="N=64"):
        short = x[:, :49].contiguous()
        swin_block_bwd(short, short, *args[1:], **kw)
    with pytest.raises(ValueError, match="wqkv"):
        swin_block_bwd(x, x, *args[1:3], args[3][:, :40].contiguous(), *args[4:], **kw)
    with pytest.raises(ValueError, match="unsupported width"):
        swin_block_bwd(x, x, *args[1:], num_heads=3, scale=1.0)
    assert swin_block_bwd.launches == before


def test_recompute_fused_swinir_backward_matches_module(device):
    """Gradients of the bf16 fused forward with backward="recompute" (K1
    forward, K4b backward) against autograd of the fp32 module, held as the
    split backward is; no K2, K3 or K4 launch."""
    model = SwinIR(**CFG, generator=torch.Generator().manual_seed(2)).to(device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, 32, 32, 1), dtype=np.float32)).to(device)
    probe = torch.from_numpy(rng.standard_normal((2, 128, 128, 1)).astype(np.float32))
    probe = probe.to(device)
    fused = make_fused_swinir(model, differentiable=True, backward="recompute")
    checked = ["conv_first.weight", "layers.0.0.attn.qkv.weight",
               "layers.1.1.attn.relative_position_bias_table", "layers.1.0.mlp.fc1.weight",
               "layers.0.1.norm2.weight"]
    model16 = copy.deepcopy(model).to(torch.bfloat16)

    def grads(forward, net, dtype=torch.float32):
        xi = x.clone().to(dtype).requires_grad_()
        net.zero_grad()
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    want = grads(model, model)
    ref16 = grads(model16, model16, torch.bfloat16)
    counters = (fused_swin_block, swin_block_bwd, swin_block_fwd_h, swin_block_bwd_mlp,
                swin_block_bwd_attn)
    counts = [fn.launches for fn in counters]
    got = grads(fused, model)
    assert [fn.launches - n for fn, n in zip(counters, counts)] == [4, 4, 0, 0, 0]
    for name, g, w, r in zip(["input", *checked], got, want, ref16):
        assert torch.isfinite(g).all(), name
        err, err16 = _rel_l2(g, w), _rel_l2(r, w)
        print(f"{name}: fused bf16 recompute {err:.4e}, nn.Module bf16 {err16:.4e}")
        assert err <= max(FUSED_GRAD_REL_L2, 2 * err16), (name, err, err16)


@pytest.mark.parametrize("mode", MODES)
def test_stage_kernel_matches_plain_version(device, mode):
    args = _operands(MODES.index(mode), 16, 180, 6, 720, device)
    kw = dict(mode=mode, num_heads=6, scale=30**-0.5)
    before = swin_stage_block.launches
    got = swin_stage_block(*args, **kw)
    torch.cuda.synchronize()
    assert swin_stage_block.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (16, 64, 180)
    want = swin_stage_block_reference(*args, **kw).float()
    err = (got.float() - want).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), (mode, err)
    assert _rel_l2(got, want) <= K13_REL_L2, (mode, _rel_l2(got, want))


def test_stage_kernel_tells_its_activations_apart(device):
    """The activation modes, and mlp_polygelu with zero coefficients (erf
    read as 0: u / 2), each meet their plain version, and lie further apart
    from one another than that bound: a swapped activation, or
    coefficients that never reach the kernel, fail."""
    args = _operands(12, 64, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    runs = {m: dict(mode=m) for m in ("full", "mlp_tanhgelu", "mlp_siggelu", "mlp_nogelu")}
    runs["zeroed polygelu"] = dict(mode="mlp_polygelu", erf_coef=np.zeros(26, np.float32))
    outs = {}
    for name, how in runs.items():
        outs[name] = swin_stage_block(*args, **how, **kw)
        want = swin_stage_block_reference(*args, **how, **kw)
        assert _rel_l2(outs[name], want) <= K13_REL_L2, (name, _rel_l2(outs[name], want))
    names = list(outs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert _rel_l2(outs[a], outs[b]) > K13_REL_L2, (a, b, _rel_l2(outs[a], outs[b]))


def test_stage_kernel_tanhgelu_is_k1_and_allheads_is_full(device):
    """mlp_tanhgelu launches K1's own instantiation: K1's bits. allheads is
    full's instantiation: the same bits."""
    args = _operands(11, 32, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    assert torch.equal(swin_stage_block(*args, mode="mlp_tanhgelu", **kw),
                       fused_swin_block(*args, **kw))
    assert torch.equal(swin_stage_block(*args, mode="allheads", **kw),
                       swin_stage_block(*args, mode="full", **kw))


@pytest.mark.parametrize("bw", [1, 3, 7, 263])
@pytest.mark.parametrize("mode", ["full", "noattn", "attnonly", "mlponly"])
def test_stage_kernel_modes_at_odd_window_counts(device, mode, bw):
    """Each stage mode below, off and above one persistent wave of window
    pairs (an odd count leaves a block's second window idle): its plain
    version within K1's bound and K13_REL_L2, and twice the same bits."""
    args = _operands(20 + bw, bw, 180, 6, 720, device)
    kw = dict(mode=mode, num_heads=6, scale=30**-0.5)
    got = swin_stage_block(*args, **kw)
    again = swin_stage_block(*args, **kw)
    torch.cuda.synchronize()
    want = swin_stage_block_reference(*args, **kw).float()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), (mode, bw, err)
    assert _rel_l2(got, want) <= K13_REL_L2, (mode, bw, _rel_l2(got, want))


def test_stage_kernel_on_weights_packed_once_gives_the_same_bits(device):
    """Every mode on K1's weights packed once gives the bits of a call that
    packs them itself; a packing of the wrong size raises."""
    args = _operands(13, 7, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    packed = pack_swin_block_weights(args[3], args[6], args[10], args[12], num_heads=6)
    for mode in MODES:
        assert torch.equal(swin_stage_block(*args, mode=mode, **kw, packed=packed),
                           swin_stage_block(*args, mode=mode, **kw)), mode
    with pytest.raises(ValueError, match="packed"):
        swin_stage_block(*args, mode="full", **kw, packed=packed[:-8])


def test_stage_kernel_raises_on_what_it_does_not_take(device):
    args = _operands(0, 2, 180, 6, 720, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    before = swin_stage_block.launches
    with pytest.raises(TypeError, match="bfloat16"):
        swin_stage_block(args[0].float(), *args[1:], mode="full", **kw)
    with pytest.raises(ValueError, match="mode is one of"):
        swin_stage_block(*args, mode="packed", **kw)
    with pytest.raises(ValueError, match="device"):
        swin_stage_block(*args[:5], args[5].cpu(), *args[6:], mode="full", **kw)
    small = _operands(0, 2, 16, 2, 32, device)
    with pytest.raises(ValueError, match="129..192"):
        swin_stage_block(*small, mode="full", num_heads=2, scale=8**-0.5)
    assert swin_stage_block.launches == before


# ---- the edges of the Hopper redesigns: K8's stack, weight-gradient and dx
# kernels (8 x 16 and 16 x 8 pixel tiles, 16 x 16 chain tiles), K3's and
# K9b's window kernel (two windows a block) and the weight-gradient product
# K3, K4, K9b, K9c, K10b and K4b share (192 x 192 tiles, 64-token slabs)


@pytest.mark.parametrize("stashed", [False, True])
@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (3, 12, 40), (3, 7, 13)])
def test_rdb_kernel_at_odd_batches_and_sizes(device, b, h, w, stashed):
    """K7 at B = 1 and 3 on images whose sides are not multiples of its
    64 x 4 tile (13 x 7: not even of its 8-pixel runs), with and without
    the stash: within K1's bound of the plain version, two runs to the same
    bits, the same output either way, and the stash's x, x1..x4 K7's own."""
    f, g = 48, 24
    x, ks, bs = _rdb_operands(b + h + w + 5, b, f, g, h, w, device)
    if stashed:
        got, stash = _stashed(x, ks, bs, h, w)
        again, stash2 = _stashed(x, ks, bs, h, w)
        assert torch.equal(stash, stash2)
        assert torch.equal(stash[..., :f], x.transpose(1, 2))
        srcs, _ = dense_block_sources(x, ks, bs, h=h, w=w)
        want_stash = torch.cat(srcs[1:], 1).reshape(b, 4 * g, h * w).transpose(1, 2)
        assert _rel_l2(stash[..., f:], want_stash) <= BWD_REL_L2
    else:
        got, again = fused_rdb_cm(x, ks, bs, h=h, w=w), fused_rdb_cm(x, ks, bs, h=h, w=w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, fused_rdb_cm(x, ks, bs, h=h, w=w, stash=None if stashed else
                                         torch.empty(b, h * w, f + 4 * g, dtype=torch.bfloat16,
                                                     device=device)))
    want = rdb_cm_reference(x, ks, bs, h=h, w=w).float()
    err = (got.float() - want).abs().max().item()
    assert err <= K1_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("b,h,w", [(1, 20, 36), (3, 12, 40)])
def test_rdb_bwd_kernel_at_odd_batches_and_sizes(device, b, h, w):
    """K8 at B = 1 and 3 on images whose sides are multiples of neither the
    stack kernel's 16-pixel tile nor the 8 x 16 and 16 x 8 tiles of its
    weight-gradient and dx kernels: every output within BWD_REL_L2 of the
    plain version, and two runs to the same bits."""
    f, g = 48, 24
    x, ks, bs = _rdb_operands(b + h + w, b, f, g, h, w, device)
    dy = (1e-2 * torch.randn(b, f, h * w, generator=torch.Generator().manual_seed(b))).to(
        device, torch.bfloat16)
    _, stash = _stashed(x, ks, bs, h, w)
    first = fused_rdb_cm_bwd(x, dy, ks, bs, h=h, w=w, stash=stash)
    second = fused_rdb_cm_bwd(x, dy, ks, bs, h=h, w=w, stash=stash)
    torch.cuda.synchronize()
    got, again = [first[0], *first[1], *first[2]], [second[0], *second[1], *second[2]]
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want = rdb_cm_bwd_reference(x, dy, ks, bs, h=h, w=w)
    names = ["dx"] + [f"dW{i}" for i in range(1, 6)] + [f"db{i}" for i in range(1, 6)]
    for name, a, c in zip(names, got, [want[0], *want[1], *want[2]]):
        assert a.shape == c.shape and torch.isfinite(a).all(), name
        assert _rel_l2(a, c) <= BWD_REL_L2, (name, _rel_l2(a, c))


@pytest.mark.parametrize("bw", [1, 7])
def test_mlp_bwd_kernels_at_odd_window_counts(device, bw):
    """K3 (C = 180, hidden 720) and K9b (C = 90 padded, hidden 360, a
    drop-path scale per window) at window counts the kernel's two windows a
    block do not divide: within BWD_REL_L2 of their plain versions, twice to
    the same bits."""
    args = _operands(bw, bw, 180, 6, 720, device)
    ln2_w, ln2_b, w1, b1, w2 = args[8], args[9], args[10], args[11], args[12]
    gen = torch.Generator().manual_seed(bw)
    h = torch.randn(bw, 64, 180, generator=gen).to(device, torch.bfloat16)
    dout = (1e-2 * torch.randn(bw, 64, 180, generator=gen)).to(device, torch.bfloat16)
    first = swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1, w2)
    second = swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1, w2)
    want = swin_block_bwd_mlp_reference(h, dout, ln2_w, ln2_b, w1, b1, w2)
    _, _, *params = _hat_operands(bw + 60, bw, 90, 6, 360, device)
    hab = params[7:12]
    dp = torch.full((bw,), 1 / 0.9, device=device)
    dp[0] = 0.0
    h9 = _windows(bw + 61, bw, 90, 64, device, std=1.0)
    d9 = _windows(bw + 62, bw, 90, 64, device)
    first9 = hab_bwd_mlp(h9, d9, dp, *hab)
    second9 = hab_bwd_mlp(h9, d9, dp, *hab)
    want9 = hab_bwd_mlp_reference(h9, d9, dp, *hab)
    torch.cuda.synchronize()
    names = ["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2"]
    for got, again, ref in ((first, second, want), (first9, second9, want9)):
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        for name, a, c in zip(names, got, ref):
            assert a.shape == c.shape and torch.isfinite(a).all(), name
            assert _rel_l2(a, c) <= BWD_REL_L2, (name, _rel_l2(a, c))
    assert torch.equal(first9[0][:1], d9[:1])  # window 0's MLP branch dropped


@pytest.mark.parametrize("bw", [1, 3, 7])
def test_attn_bwd_kernels_at_odd_window_counts(device, bw):
    """K4 (C = 180, 6 heads) and K9c (C = 90 padded, the shift mask of one
    8 x 8*bw image, so that nW = bw windows, which neither the two windows a
    block nor a warpgroup's slice of windows divides, and window 0's branch
    dropped) at window counts the persistent kernel's blocks do not divide:
    within BWD_REL_L2 of their plain versions, twice to the same bits."""
    args = _operands(bw + 90, bw, 180, 6, 720, device)
    x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj = args[:7]
    dh = (1e-2 * torch.randn(bw, 64, 180, generator=torch.Generator().manual_seed(bw))).to(
        device, torch.bfloat16)
    kw = dict(num_heads=6, scale=30**-0.5)
    first = swin_block_bwd_attn(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    second = swin_block_bwd_attn(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    want = swin_block_bwd_attn_reference(x, dh, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
    x9, _, *params = _hat_operands(bw + 91, bw, 90, 6, 360, device)
    mask = torch.from_numpy(shift_window_attn_mask(8, 8 * bw, 8, 4)).to(device)
    dp = torch.full((bw,), 1 / 0.9, device=device)
    dp[0] = 0.0
    d9 = _windows(bw + 92, bw, 90, 64, device)
    args9 = (x9, d9, mask, dp, *params[:6])
    kw9 = dict(num_heads=6, scale=15**-0.5)
    first9, second9 = hab_bwd_attn(*args9, **kw9), hab_bwd_attn(*args9, **kw9)
    want9 = hab_bwd_attn_reference(*args9, **kw9)
    torch.cuda.synchronize()
    names = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    for got, again, ref in ((first, second, want), (first9, second9, want9)):
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        for name, a, c in zip(names, got, ref):
            assert a.shape == c.shape and torch.isfinite(a).all(), name
            assert _rel_l2(a, c) <= BWD_REL_L2, (name, _rel_l2(a, c))
    assert torch.equal(first9[0][:1], d9[:1])  # window 0's attention branch dropped


@pytest.mark.parametrize("t,m,n", [(337, 60, 100), (4160, 196, 36), (64, 8, 392)])
def test_weight_gradient_product_at_ragged_shapes(device, t, m, n):
    """The shared weight-gradient product a^T . b at M, N and T that its 192
    x 192 tiles and 64-token slabs do not divide (and M = 196 8-byte rows):
    within 1e-5 relative L2 of the fp32 product of the same bf16 operands
    (only the fp32 summation order differs), twice to the same bits."""
    from superresolution_def_tpu_torch.kernels.swin_block import _train_library, _wgrad

    gen = torch.Generator().manual_seed(t + m + n)
    a = torch.randn(t, m, generator=gen).to(device, torch.bfloat16)
    b = torch.randn(t, n, generator=gen).to(device, torch.bfloat16)
    lib = _train_library()
    got, again = _wgrad(lib, a, b), _wgrad(lib, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel_l2(got, a.float().T @ b.float()) <= 1e-5
