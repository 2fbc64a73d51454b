"""K7's weight packing (``pack_rdb_cm_weights``), walked back into the convs
on the CPU.

The packing is plain PyTorch; the kernel reads it by wgmma descriptors: per
conv, per 16-channel k step, per tap, a ``cout x 16`` B operand whose
element (n, c) sits at ``(n // 8) 128 + (c // 8) 64 + (n % 8) 8 + c % 8``.
Here the packed weights are read back by that formula, the k steps laid
over their input channels (:func:`cm_k_starts`, the last step of a width off
16 moved back 8 channels), and the result must be each HWIO conv weight with
every input channel taken exactly once; then the implicit GEMM the kernel
runs on those operands (per tap, the shifted source's 16-channel slices
times the step's B) must give ``F.conv2d``. K12 runs the same convs on the
same packing with x read through a map of its own (``nhwc_k_steps``): its
steps must read only x's channels or the scratch channels written so far,
and take every input channel once."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from superresolution_def_tpu_torch.kernels.fused_rdb import nhwc_k_steps
from superresolution_def_tpu_torch.kernels.fused_rdb_cm import (
    KERNEL_WIDTHS,
    cm_k_starts,
    pack_rdb_cm_weights,
)


def _kernels(f: int, g: int, seed: int):
    rng = np.random.default_rng(seed)
    ks = [torch.from_numpy(rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                           .astype(np.float32)).to(torch.bfloat16) for i in range(5)]
    bs = [torch.from_numpy(rng.standard_normal(g if i < 4 else f).astype(np.float32))
          for i in range(5)]
    return ks, bs


def _steps(packed: np.ndarray, offset: int, cin: int, cout: int) -> np.ndarray:
    """(k steps, 9 taps, 16 channels, cout) B operands of one conv."""
    nn_, cc = np.meshgrid(np.arange(cout), np.arange(16), indexing="ij")
    pos = (nn_ // 8) * 128 + (cc // 8) * 64 + (nn_ % 8) * 8 + cc % 8   # (cout, 16)
    ks = len(cm_k_starts(cin))
    flat = packed[offset: offset + ks * 9 * 16 * cout].reshape(ks, 9, 16 * cout)
    return flat[:, :, pos].transpose(0, 1, 3, 2)                         # (ks, 9, 16, cout)


@pytest.mark.parametrize("f,g", sorted(KERNEL_WIDTHS))
def test_packed_weights_are_the_conv_weights(f, g):
    ks, bs = _kernels(f, g, f + g)
    packed, offsets, bias = pack_rdb_cm_weights(ks, bs, "cpu")
    assert packed.dtype == torch.bfloat16 and bias.dtype == torch.float32
    assert torch.equal(bias, torch.cat(bs))
    flat = packed.float().numpy()
    total = 0
    for i, k in enumerate(ks):
        cin, cout = k.shape[2], k.shape[3]
        starts = cm_k_starts(cin)
        # the kernel loads each conv's weights by 16-byte bulk copies
        assert offsets[i] == total and offsets[i] % 8 == 0
        total += len(starts) * 9 * 16 * cout
        steps = _steps(flat, offsets[i], cin, cout)
        back = np.zeros((9, cin, cout), np.float32)
        taken = np.zeros(cin, int)
        for s, start in enumerate(starts):
            assert start % 8 == 0 and start + 16 <= cin
            back[:, start:start + 16] += steps[s]
            # a channel an earlier step took reads as zero here
            fresh = np.arange(start, start + 16) >= 16 * s
            assert not steps[s][:, ~fresh].any()
            taken[start:start + 16] += fresh
        assert (taken == 1).all()
        np.testing.assert_array_equal(back, k.float().numpy().reshape(9, cin, cout))
    assert packed.numel() == total


@pytest.mark.parametrize("f,g", [(48, 24), (16, 8)])
def test_packed_weights_compute_the_convs(f, g):
    """The kernel's implicit GEMM on the packed operands: per tap (dy, dx),
    per k step, the source shifted by (dy, dx) (zero outside the image),
    its 16 channels from the step's start, times the step's B."""
    ks, bs = _kernels(f, g, f + 2 * g)
    packed, offsets, _ = pack_rdb_cm_weights(ks, bs, "cpu")
    flat = packed.float().numpy()
    rng = np.random.default_rng(3)
    h, w = 6, 9
    for i, k in enumerate(ks):
        cin, cout = k.shape[2], k.shape[3]
        src = torch.from_numpy(rng.standard_normal((1, cin, h, w)).astype(np.float32))
        padded = F.pad(src, (1, 1, 1, 1))
        steps = torch.from_numpy(_steps(flat, offsets[i], cin, cout))
        got = torch.zeros(1, cout, h, w)
        for s, start in enumerate(cm_k_starts(cin)):
            for tap in range(9):
                dy, dx = tap // 3 - 1, tap % 3 - 1
                a = padded[0, start:start + 16, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                got[0] += torch.einsum("chw,cn->nhw", a, steps[s, tap])
        want = F.conv2d(src, k.float().permute(3, 2, 0, 1), padding=1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("f,g", sorted(KERNEL_WIDTHS))
def test_nhwc_steps_read_each_input_channel_once(f, g):
    """K12's k steps over its two maps, x (F channels) and the x1..x4
    scratch (4G channels, of which conv i + 1 finds i G written), against
    K7's packed weights: a step reads whole 8-channel groups, each inside x,
    inside the written scratch, or (the scratch's channels -8..-1) zeros;
    every input channel of every conv comes from exactly one slot whose
    weights are that channel's, and every other slot's weights are zero."""
    ks, bs = _kernels(f, g, 3 * f + g)
    packed, offsets, _ = pack_rdb_cm_weights(ks, bs, "cpu")
    flat = packed.float().numpy()
    plan = nhwc_k_steps(f, g)
    assert [len(steps) for steps in plan] == [len(cm_k_starts(f + i * g)) for i in range(5)]
    for i, (k, steps) in enumerate(zip(ks, plan)):
        cin, cout = k.shape[2], k.shape[3]
        b = _steps(flat, offsets[i], cin, cout)                  # (steps, 9, 16, cout)
        hwio = k.float().numpy().reshape(9, cin, cout)
        taken = np.zeros(cin, int)
        for s, (src, c0) in enumerate(steps):
            assert c0 % 8 == 0
            if src == "x":
                assert 0 <= c0 and c0 + 16 <= f
            else:
                assert src == "scratch" and -8 <= c0 and c0 + 16 <= i * g
            for j in range(16):
                c = c0 + j
                ch = c if src == "x" else (f + c if c >= 0 else None)
                if ch is None or taken[ch]:
                    assert not b[s, :, j].any(), (i, s, j)
                else:
                    taken[ch] += 1
                    np.testing.assert_array_equal(b[s, :, j], hwio[:, ch])
        assert (taken == 1).all(), i
