"""K9a's entry point (``hab_fwd_h``) on CPU tensors at HAT's widths.

On the card K9a now reads the weights through ``padded=`` (the fused-HAB
step's cache of ``pad_hab_operands``) and packs them itself; on a CPU tensor
the entry point must still give its plain version, bit for bit, whether or
not it is handed ``padded``, shifted or not, with and without the two
branches' drop-path scales. A window whose MLP branch is dropped (dp2 = 0)
leaves with out = h, the property the kernel's skip of the MLP keeps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.kernels import hab_fwd_h, hab_fwd_h_reference
from superresolution_def_tpu_torch.kernels.hab_block import pad_hab_operands
from superresolution_def_tpu_torch.ops import shift_window_attn_mask

torch.set_num_threads(1)

BW, C, HEADS, HID = 8, 90, 6, 360


def _operands(seed):
    """x, conv_x and the 13 block parameters, numpy-seeded; windows and
    weights bf16."""
    rng = np.random.default_rng(seed)

    def t(a, bf16=False):
        out = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return out.to(torch.bfloat16) if bf16 else out

    def u(*shape, fan_in):
        return rng.uniform(-1, 1, shape) / np.sqrt(fan_in)

    return [t(rng.standard_normal((BW, 64, C)), True), t(rng.standard_normal((BW, 64, C)), True),
            t(1 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(u(C, 3 * C, fan_in=C), True), t(u(3 * C, fan_in=C)),
            t(0.5 * rng.standard_normal((HEADS, 64, 64))), t(u(C, C, fan_in=C), True),
            t(u(C, fan_in=C)), t(1 + 0.1 * rng.standard_normal(C)),
            t(0.1 * rng.standard_normal(C)), t(u(C, HID, fan_in=C), True),
            t(u(HID, fan_in=C)), t(u(HID, C, fan_in=HID), True), t(u(C, fan_in=HID))]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shifted", [False, True])
def test_fwd_h_with_padded_weights_on_cpu_is_the_plain_version(shifted, scaled):
    x, convx, *params = _operands(int(shifted) + 2 * int(scaled))
    mask = torch.from_numpy(shift_window_attn_mask(16, 16, 8, 4)) if shifted else None
    dp1 = dp2 = None
    if scaled:  # two images of four windows: image 0's MLP and image 1's attention dropped
        dp1 = torch.tensor([1 / 0.9, 0.0]).repeat_interleave(4)
        dp2 = torch.tensor([0.0, 1 / 0.9]).repeat_interleave(4)
    kw = dict(num_heads=HEADS, scale=(C // HEADS) ** -0.5, conv_scale=0.01)
    padded = pad_hab_operands(*params[:4], *params[5:], num_heads=HEADS)
    before = hab_fwd_h.launches
    got = hab_fwd_h(x, convx, mask, dp1, dp2, *params, **kw, padded=padded)
    plain = hab_fwd_h(x, convx, mask, dp1, dp2, *params, **kw)
    want = hab_fwd_h_reference(x, convx, mask, dp1, dp2, *params, **kw)
    assert hab_fwd_h.launches == before  # the plain version launches nothing
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.bfloat16 and g.shape == (BW, 64, C)
        assert torch.equal(g, w) and torch.equal(p, w)
    if scaled:
        assert torch.equal(got[0][:4], got[1][:4])
