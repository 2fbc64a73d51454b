"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA device.
The machine with the card has no jax, and this suite's conftest imports it,
so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Each kernel is checked at widths that take each of its code paths: one, two,
three and four 64-column chunks of the residual, an odd head count, head_dim
30 padded to 32, a hidden width that is not a tile multiple.

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
    fused_swin_block,
    make_fused_swinir,
    swin_block_bwd_attn,
    swin_block_bwd_attn_reference,
    swin_block_bwd_mlp,
    swin_block_bwd_mlp_reference,
    swin_block_fwd_h,
    swin_block_fwd_h_reference,
    swin_block_reference,
)
from superresolution_def_tpu_torch.models import SwinIR

pytestmark = pytest.mark.cuda

K1_TOL = 3e-2
BWD_REL_L2 = 2e-2
FUSED_GRAD_REL_L2 = 2e-2

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
    assert torch.equal(out, fused_swin_block(*args, **kw))  # K1 plus one store
    want_out, want_h = swin_block_fwd_h_reference(*args, **kw)
    for got, want in ((out, want_out), (h, want_h)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL * max(1.0, want.float().abs().max().item()), err


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
