"""Spectral-norm conv and the swin U-Net discriminator against the JAX package.

Weights and (u, v) bridge from the JAX init through
``discriminator_swin_state_dict_from_jax``; four training-mode forwards
follow in a row on both sides (each advances the power iteration), and the
outputs and (u, v) are compared after each. fp32: the same math in other
orders, so 1e-5 relative to each output's largest entry, (u, v) to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.models.discriminators import UNetDiscriminatorSNSwin as JaxD
from superresolution_def_tpu.models.spectral_norm import SNConv2d as JaxSN
from superresolution_def_tpu.models.torch_port import discriminator_swin_from_torch
from superresolution_def_tpu_torch.models import (
    SNConv2d,
    UNetDiscriminatorSNSwin,
    discriminator_swin_state_dict_from_jax,
)

# The suite runs in parallel worker processes on few cores, beside JAX tests
# whose CPU collectives abort when their threads starve: torch takes one
# thread per process (every worker imports this module at collection).
torch.set_num_threads(1)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("transpose", [False, True])
def test_sn_conv_matches_jax_over_four_training_forwards(transpose):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    mod = JaxSN(5, 4, 2, 1, transpose=transpose)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])  # (kh, kw, I, O)
    port = SNConv2d(6, 5, 4, 2, 1, transpose=transpose)
    perm = (2, 3, 0, 1) if transpose else (3, 2, 0, 1)
    port.load_state_dict({
        "weight_orig": torch.from_numpy(kernel.transpose(perm).copy()),
        "weight_u": torch.from_numpy(np.array(variables["spectral"]["u"])),
        "weight_v": torch.from_numpy(np.array(variables["spectral"]["v"])),
    })
    spectral = variables["spectral"]
    for i in range(4):
        want, upd = mod.apply({"params": variables["params"], "spectral": spectral},
                              jnp.asarray(x), True, mutable=["spectral"])
        spectral = upd["spectral"]
        got = port(torch.from_numpy(x), True)
        _close(got, want, f"forward {i}")
        np.testing.assert_allclose(port.weight_u.numpy(), np.asarray(spectral["u"]), atol=1e-5)
        np.testing.assert_allclose(port.weight_v.numpy(), np.asarray(spectral["v"]), atol=1e-5)
    # an eval forward reuses the stored vectors
    u = port.weight_u.clone()
    port(torch.from_numpy(x), False)
    assert torch.equal(port.weight_u, u)


@pytest.mark.parametrize("size", [64, 48])  # 48: the bilinear size fix at the bottom skip
def test_discriminator_matches_jax_over_four_training_forwards(size):
    rng = np.random.default_rng(size)
    xs = [rng.random((2, size, size, 1)).astype(np.float32) for _ in range(4)]
    jd = JaxD(num_in_ch=1, num_feat=16)
    variables = jd.init(jax.random.PRNGKey(1), jnp.asarray(xs[0]))
    params, spectral = variables["params"], variables["spectral"]
    port = UNetDiscriminatorSNSwin(1, 16)
    port.load_state_dict(discriminator_swin_state_dict_from_jax(_np_tree(params),
                                                                _np_tree(spectral)))
    for i, x in enumerate(xs):
        want, upd = jd.apply({"params": params, "spectral": spectral}, jnp.asarray(x), True,
                             mutable=["spectral"])
        spectral = upd["spectral"]
        got = port(torch.from_numpy(x), True)
        _close(got, want, f"forward {i}")
        want_sd = discriminator_swin_state_dict_from_jax(_np_tree(params), _np_tree(spectral))
        for k, v in port.state_dict().items():
            if k.endswith(("weight_u", "weight_v")):
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5,
                                           err_msg=f"{k} after forward {i}")


def test_reference_key_names_map_onto_the_jax_discriminator():
    """torch_port.discriminator_swin_from_torch reads the port's state dict."""
    port = UNetDiscriminatorSNSwin(1, 8, generator=torch.Generator().manual_seed(3))
    params, sn = discriminator_swin_from_torch(port.state_dict())
    jd = JaxD(num_in_ch=1, num_feat=8)
    ref = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    assert jax.tree_util.tree_structure(_np_tree(ref["params"])) == \
        jax.tree_util.tree_structure(params)
    for name, p in params.items():
        assert p["kernel"].shape == ref["params"][name]["kernel"].shape, name
    back = discriminator_swin_state_dict_from_jax(params, sn)
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
