"""One SwinIR GAN train step of the port against the JAX step.

Both packages start from the same bridged state (G, D with its spectral
(u, v), EMA, VGG19 features) at tiny widths (LR 16 -> HR 64, embed 16, one
stage of 2 blocks, 2 heads, mlp 2), take one step of micro 2 x accum 2 on
the same uint16 batch with augmentation off, in fp32, the JAX step with its
flax generator (``fused=False``).

Tolerances: the losses agree to 1e-5 relative and the (u, v) vectors to
1e-5 (fp32, the same math in other orders). AdamW's first step moves each
weight by lr * g / (|g| + eps), about lr * sign(g) = 1e-4, so a weight whose
gradient is near 0 may move by up to 2 lr apart in the two packages: every
weight agrees to 2.1e-4, and all but 2% of each tensor's entries to 1e-6
(the widest share, 1.03%, is in D's conv3, whose 4x4x256 fan-in leaves the
most gradients at the size of fp32 summation noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.train import create_swin_train_state as jax_state
from superresolution_def_tpu.train import make_swin_train_step as jax_step
from superresolution_def_tpu.train.losses import CombinedGANLoss as JaxCombined
from superresolution_def_tpu.train.losses import DiscriminatorLoss as JaxDLoss
from superresolution_def_tpu.train.vgg import VGG19Features as JaxVGG
from superresolution_def_tpu.train.vgg import init_vgg_params
from superresolution_def_tpu_torch.models import (
    discriminator_swin_state_dict_from_jax,
    swinir_state_dict_from_jax,
    vgg19_state_dict_from_jax,
)
from superresolution_def_tpu_torch.train import (
    CombinedGANLoss,
    DiscriminatorLoss,
    VGG19Features,
    create_swin_train_state,
    make_swin_train_step,
)

# The suite runs in parallel worker processes on few cores, beside JAX tests
# whose CPU collectives abort when their threads starve: torch takes one
# thread per process (every worker imports this module at collection).
torch.set_num_threads(1)

TINY = dict(img_size=16, upscale=4, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2.0)
ACCUM, MICRO = 2, 2


class NaNDLoss(JaxDLoss):
    def __call__(self, real_pred, fake_pred):
        bad = jnp.full((), jnp.nan) + jnp.mean(real_pred) * 0
        return bad, {"adversarial": bad, "total": bad}


class TorchNaNDLoss(DiscriminatorLoss):
    def __call__(self, real_pred, fake_pred):
        bad = torch.full((), float("nan")) + real_pred.mean() * 0
        return bad, {"adversarial": bad, "total": bad}


# NaN in one micro-batch: the one whose two samples are the same patch
# (``_batch(marked=)``). D's criterion sees it as two logit maps, G's as two
# HR patches, equal to rounding (XLA's CPU code may round the two samples'
# /65535 apart); the loss times NaN sends NaN gradients into the
# accumulation, which only a select (not a product with 0) drops.
def _jax_same(x):
    return jnp.max(jnp.abs(x[0] - x[1])) <= 1e-4 * jnp.max(jnp.abs(x))


def _torch_same(x):
    return (x[0] - x[1]).abs().max() <= 1e-4 * x.abs().max()


class MarkedNaNDLoss(JaxDLoss):
    def __call__(self, real_pred, fake_pred):
        loss, parts = super().__call__(real_pred, fake_pred)
        loss = loss * jnp.where(_jax_same(real_pred), jnp.nan, 1.0)
        return loss, {**parts, "total": loss}


class TorchMarkedNaNDLoss(DiscriminatorLoss):
    def __call__(self, real_pred, fake_pred):
        loss, parts = super().__call__(real_pred, fake_pred)
        loss = loss * torch.where(_torch_same(real_pred), float("nan"), 1.0)
        return loss, {**parts, "total": loss}


@dataclasses.dataclass(frozen=True)
class NaNGLoss(JaxCombined):
    every: bool = True

    def __call__(self, pred, target, real_pred=None, fake_pred=None):
        loss, parts = super().__call__(pred, target, real_pred, fake_pred)
        hit = True if self.every else _jax_same(target)
        loss = loss * jnp.where(hit, jnp.nan, 1.0)
        return loss, {**parts, "total": loss}


@dataclasses.dataclass(frozen=True)
class TorchNaNGLoss(CombinedGANLoss):
    every: bool = True

    def __call__(self, pred, target, real_pred=None, fake_pred=None):
        loss, parts = super().__call__(pred, target, real_pred, fake_pred)
        hit = torch.tensor(True) if self.every else _torch_same(target)
        loss = loss * torch.where(hit, float("nan"), 1.0)
        return loss, {**parts, "total": loss}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _batch(seed=0, marked=None):
    """uint16 (ACCUM, MICRO, H, W, 1) pairs; micro-batch ``marked`` holds its
    first patch twice."""
    rng = np.random.default_rng(seed)
    batch = {
        "lr": rng.integers(0, 65535, (ACCUM, MICRO, 16, 16, 1), dtype=np.uint16),
        "hr": rng.integers(0, 65535, (ACCUM, MICRO, 64, 64, 1), dtype=np.uint16),
    }
    if marked is not None:
        for v in batch.values():
            v[marked, 1:] = v[marked, :1]
    return batch


@pytest.fixture(scope="module")
def start():
    """The JAX state and VGG params, and a port state loaded from them."""
    state, bundle = jax_state(jax.random.PRNGKey(0), **TINY, dtype=jnp.float32)
    vgg_params = init_vgg_params(cutoff=35, seed=0)
    return state, bundle, vgg_params


def _port(start):
    state, _, vgg_params = start
    port = create_swin_train_state(torch.Generator().manual_seed(0), **TINY, device="cpu")
    g_sd = swinir_state_dict_from_jax(_np_tree(state.g_params))
    port.g.load_state_dict(g_sd)
    port.ema.load_state_dict(swinir_state_dict_from_jax(_np_tree(state.ema)))
    port.d.load_state_dict(discriminator_swin_state_dict_from_jax(
        _np_tree(state.d_params), _np_tree(state.spectral)))
    vgg = VGG19Features(35)
    vgg.load_state_dict(vgg19_state_dict_from_jax(_np_tree(vgg_params)))
    return port, vgg.requires_grad_(False)


def _jax_criterion(vgg_params, cls=JaxCombined, **kw):
    model = JaxVGG(cutoff=35)
    return cls(pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005,
               vgg_apply=lambda x: model.apply({"params": vgg_params}, x), **kw)


def _assert_weights(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].detach().numpy()
        w = w.numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2.1e-4, (what, k, diff.max())
        assert (diff > 1e-6).mean() <= 0.02, (what, k, (diff > 1e-6).mean())


def test_train_step_matches_jax(start):
    state, bundle, vgg_params = start
    batch = _batch()
    step = jax_step(bundle, accum_steps=ACCUM, augment=False,
                    criterion_g=_jax_criterion(vgg_params), donate=False)
    new, m = step(state, batch, 1e-4, 1e-4)

    port, vgg = _port(start)
    tstep = make_swin_train_step(
        port, accum_steps=ACCUM, augment=False,
        criterion_g=CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                    adversarial_weight=0.005, vgg_apply=vgg))
    tm = tstep(batch, 1e-4, 1e-4)

    assert float(tm["valid_batches"]) == float(m["valid_batches"]) == ACCUM
    np.testing.assert_allclose(float(tm["loss_g"]), float(m["loss_g"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss_d"]), float(m["loss_d"]), rtol=1e-5)
    want_d = discriminator_swin_state_dict_from_jax(_np_tree(new.d_params),
                                                    _np_tree(new.spectral))
    got_d = port.d.state_dict()
    for k in want_d:
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(got_d[k].numpy(), want_d[k].numpy(), atol=1e-5,
                                       err_msg=k)
    _assert_weights(got_d, want_d, "D")
    _assert_weights(port.g.state_dict(), swinir_state_dict_from_jax(_np_tree(new.g_params)),
                    "G")
    _assert_weights(port.ema.state_dict(), swinir_state_dict_from_jax(_np_tree(new.ema)),
                    "EMA")


# the NaN guard's cases: which loss is NaN, on every micro-batch (None) or
# on the marked one; each against the JAX step with the same criterion
GUARD_CASES = {"d-every": ("d", None), "g-every": ("g", None), "d-one": ("d", 1),
               "g-one": ("g", 1)}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_nan_guard_matches_jax(start, case):
    """The guard against the JAX step's selects. D-NaN: D's window is
    dropped and the G phase skipped, so (u, v) stay as the D phases left
    them; G-NaN: G's window is dropped, D's kept. On every micro-batch both
    networks keep their bits where their window is dropped (AdamW at zero
    gradient, swin's weight decay 0)."""
    which, marked = GUARD_CASES[case]
    state, bundle, vgg_params = start
    batch = _batch(1, marked)
    every = marked is None
    jax_d = {"d": NaNDLoss() if every else MarkedNaNDLoss(), "g": JaxDLoss()}[which]
    jax_g = _jax_criterion(vgg_params, *((NaNGLoss,) if which == "g" else ()),
                           **({"every": every} if which == "g" else {}))
    step = jax_step(bundle, accum_steps=ACCUM, augment=False, criterion_d=jax_d,
                    criterion_g=jax_g, donate=False)
    new, m = step(state, batch, 1e-4, 1e-4)

    port, vgg = _port(start)
    g_before = {k: v.clone() for k, v in port.g.state_dict().items()}
    d_before = {k: v.clone() for k, v in port.d.state_dict().items()
                if k.endswith("weight_orig")}
    torch_d = {"d": TorchNaNDLoss() if every else TorchMarkedNaNDLoss(),
               "g": DiscriminatorLoss()}[which]
    torch_g = (TorchNaNGLoss if which == "g" else CombinedGANLoss)(
        pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005, vgg_apply=vgg,
        **({"every": every} if which == "g" else {}))
    tstep = make_swin_train_step(port, accum_steps=ACCUM, augment=False, criterion_d=torch_d,
                                 criterion_g=torch_g)
    tm = tstep(batch, 1e-4, 1e-4)

    assert set(tm) == {"loss_g", "loss_d", "valid_batches"}
    for k, v in tm.items():  # 0-d tensors on the model's device, never read by the step
        assert isinstance(v, torch.Tensor) and v.shape == () and v.dtype == torch.float32, k
        assert v.device == next(port.g.parameters()).device, k
    assert float(tm["valid_batches"]) == float(m["valid_batches"]) == (0.0 if every else 1.0)
    for k in ("loss_g", "loss_d"):
        np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5, err_msg=k)
    if every:
        for k, v in g_before.items():
            assert torch.equal(port.g.state_dict()[k], v), k
        if which == "d":
            for k, v in d_before.items():
                assert torch.equal(port.d.state_dict()[k], v), k
    want_d = discriminator_swin_state_dict_from_jax(_np_tree(new.d_params),
                                                    _np_tree(new.spectral))
    got_d = port.d.state_dict()
    for k in want_d:
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(got_d[k].numpy(), want_d[k].numpy(), atol=1e-5,
                                       err_msg=k)
    _assert_weights(got_d, want_d, "D")
    _assert_weights(port.g.state_dict(), swinir_state_dict_from_jax(_np_tree(new.g_params)),
                    "G")
    _assert_weights(port.ema.state_dict(), swinir_state_dict_from_jax(_np_tree(new.ema)),
                    "EMA")
