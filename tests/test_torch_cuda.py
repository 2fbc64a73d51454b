"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``cuda`` and skips on a host without a CUDA device.
The machine with the card has no jax, and this suite's conftest imports it,
so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K1 is checked at widths that take each of its code paths: one, two, three
and four 64-column chunks of the residual, an odd head count, head_dim 30
padded to 32, a hidden width that is not a tile multiple. The bound is the
one ``chip_smoke.py`` holds K1 to at the flagship shapes: bf16 io rounds the
output to 8 significant bits, and kernel and plain version sum in different
orders, so max |kernel - plain| <= 3e-2 * max(1, max |plain|).
"""

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels import (
    fused_swin_block,
    make_fused_swinir,
    swin_block_reference,
)
from superresolution_def_tpu_torch.models import SwinIR

pytestmark = pytest.mark.cuda

K1_TOL = 3e-2


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


@pytest.mark.parametrize(
    "bw,c,heads,hidden",
    [
        (8, 16, 2, 32),      # one residual chunk, head_dim 8
        (5, 96, 3, 384),     # two chunks, an odd head count
        (3, 180, 6, 720),    # the flagship widths: three chunks, head_dim 30
        (2, 256, 8, 1024),   # four chunks, the widest C the kernel takes
        (4, 60, 2, 100),     # C and hidden both off the 64-wide tiles
    ],
)
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


def test_kernel_raises_on_what_it_does_not_take(device):
    args = _operands(0, 2, 16, 2, 32, device)
    kw = dict(num_heads=2, scale=8**-0.5)
    before = fused_swin_block.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fused_swin_block(args[0].float(), *args[1:], **kw)
    with pytest.raises(ValueError, match="N=64"):
        fused_swin_block(args[0][:, :49].contiguous(), *args[1:], **kw)
    with pytest.raises(ValueError, match="device"):
        fused_swin_block(*args[:5], args[5].cpu(), *args[6:], **kw)
    assert fused_swin_block.launches == before


def test_fused_swinir_matches_module(device):
    """bf16 fused forward against the fp32 module, the bound of chip_smoke.py."""
    cfg = dict(img_size=32, in_chans=1, embed_dim=60, depths=(2, 2), num_heads=(2, 2),
               window_size=8, mlp_ratio=4.0, upscale=4)
    model = SwinIR(**cfg, generator=torch.Generator().manual_seed(0)).to(device).eval()
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
