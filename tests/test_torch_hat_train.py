"""The hybrid's training pieces of the port against the JAX package.

- ``UNetDiscriminatorSNHAT``: two training forwards, the spectral (u, v)
  they leave and an evaluation forward after them, from bridged weights, in
  fp32 (atol 1e-5, rtol 1e-4: the same convs and power iterations in another
  summation order).
- Drop-path: the HAT forward with ``deterministic=False`` against the flax
  HAT with the same keep-masks, which the test draws with numpy and hands
  to both: to the port through ``injected_drop_masks``, to flax through
  ``flax.linen.intercept_methods`` on ``DropPath`` (fp32, atol 1e-5, rtol
  1e-4).
- One ``make_hat_train_step`` step of micro 2 x accum 2 from bridged weights
  against the JAX step (``create_hat_train_state(fused=False)``), in GAN and
  in warmup mode, augmentation off, the drop-path masks fed as above, once
  with the port's fused trunk, whose ``autograd.Function`` runs the plain
  versions on the CPU, and once with the fused trunk and the fused HAB and
  OCAB training nodes (``fused_hab``, their plain versions on the CPU), whose
  drop-path takes the same masks through ``injected_drop_masks``. Tolerances are those of
  tests/test_torch_train_step.py: losses and metric sums to 1e-5 relative,
  (u, v) to 1e-5; AdamW's first step moves a weight by about lr * sign(g),
  so a weight whose gradient is near 0 may move by up to 2 lr apart in the
  two packages: every weight to 2.1e-4, all but 2% of each tensor's entries
  to 1e-6 (D's conv9 bias, whose gradient is 0 but for rounding noise, to
  2.1e-4 alone). The masks are constant over the micro-batches: the JAX step
  traces its scan body once.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.models.discriminators import UNetDiscriminatorSNHAT as JaxDHAT
from superresolution_def_tpu.models.hat import HAT as JaxHAT
from superresolution_def_tpu.models.hat import DropPath as JaxDropPath
from superresolution_def_tpu.train import create_hat_train_state as jax_state
from superresolution_def_tpu.train import make_hat_train_step as jax_step
from superresolution_def_tpu.train.losses import CombinedGANLoss as JaxCombined
from superresolution_def_tpu.train.vgg import VGG19Features as JaxVGG
from superresolution_def_tpu.train.vgg import init_vgg_params
from superresolution_def_tpu_torch.models import (
    HAT,
    UNetDiscriminatorSNHAT,
    discriminator_hat_state_dict_from_jax,
    hat_state_dict_from_jax,
    hybrid_state_dict_from_jax,
    injected_drop_masks,
    vgg19_state_dict_from_jax,
)
from superresolution_def_tpu_torch.train import (
    CombinedGANLoss,
    VGG19Features,
    create_hat_train_state,
    make_hat_train_step,
)

torch.set_num_threads(1)

TINY = dict(img_size=16, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8, num_rrdb=1,
            num_feat=16, num_grow_ch=8)
ACCUM, MICRO = 2, 2


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _masks(seed, blocks, batch):
    """Per (HAB index, call 0/1) a (batch, 1, 1) 0/1 keep-mask, both values present."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(blocks):
        for call in (0, 1):
            m = rng.integers(0, 2, (batch, 1, 1)).astype(np.float32)
            m[0], m[-1] = 1.0, 0.0
            out[i, call] = m
    return out


def _flax_masks(masks, depths):
    """An interceptor that gives each training-mode flax DropPath its mask."""
    starts = np.cumsum((0,) + tuple(depths))
    calls = {}

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        det = args[1] if len(args) > 1 else kwargs.get("deterministic", True)
        if not isinstance(mod, JaxDropPath) or mod.rate == 0.0 or det:
            return next_fun(*args, **kwargs)
        path = mod.scope.path
        layer = next(int(p.split("_")[1]) for p in path if p.startswith("layers_"))
        block = next(int(p.split("_")[1]) for p in path if p.startswith("blocks_"))
        call = calls.get(path, 0)
        calls[path] = call + 1
        x = args[0]
        keep = 1.0 - mod.rate
        mask = jnp.asarray(masks[int(starts[layer]) + block, call % 2], x.dtype)
        return x / keep * mask

    return fnn.intercept_methods(interceptor)


def _torch_masks(masks):
    return injected_drop_masks(
        lambda index, call, x: torch.from_numpy(masks[index, call]).to(x.device, x.dtype))


def test_hat_discriminator_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    model = JaxDHAT(num_in_ch=1, num_feat=16)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)))
    port = UNetDiscriminatorSNHAT(1, 16)
    port.load_state_dict(discriminator_hat_state_dict_from_jax(
        _np_tree(variables["params"]), _np_tree(variables["spectral"])))
    spectral = variables["spectral"]
    for _ in range(2):
        want, upd = model.apply({"params": variables["params"], "spectral": spectral}, x, True,
                                mutable=["spectral"])
        spectral = upd["spectral"]
        got = port(torch.from_numpy(x), True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    want_sd = discriminator_hat_state_dict_from_jax(_np_tree(variables["params"]),
                                                    _np_tree(spectral))
    for k, v in port.state_dict().items():
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)
    # an evaluation forward leaves (u, v) as they are
    want = model.apply({"params": variables["params"], "spectral": spectral}, x, False)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_hat_drop_path_matches_jax_with_the_same_masks():
    cfg = dict(img_size=16, in_chans=1, embed_dim=30, depths=(2, 2), num_heads=(6, 6),
               window_size=8, upscale=2, img_range=1.0)
    rng = np.random.default_rng(1)
    x = rng.random((3, 16, 16, 1)).astype(np.float32)
    model = JaxHAT(**cfg, upsampler="pixelshuffle", drop_path_rate=0.1)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))["params"]
    port = HAT(**cfg, drop_path_rate=0.1)
    port.load_state_dict(hat_state_dict_from_jax(_np_tree(params)))
    masks = _masks(2, 4, 3)
    with _flax_masks(masks, cfg["depths"]):
        want = model.apply({"params": params}, x, False, rngs={"droppath": jax.random.PRNGKey(1)})
    with _torch_masks(masks):
        got = port(torch.from_numpy(x), deterministic=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    # the masks change the result: a deterministic forward differs
    assert not np.allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                           atol=1e-4)
    # without the hook each sample is kept with probability keep, scaled by 1/keep
    dp = port.layers[0].residual_group.blocks[1].drop_path
    keep = 1.0 - dp.rate
    assert dp.rate == pytest.approx(0.1 / 3)
    y = dp(torch.ones(4000, 1, 1), False, torch.Generator().manual_seed(0))
    kept = y.numpy().ravel() > 0
    np.testing.assert_allclose(y.numpy().ravel()[kept], 1.0 / keep, rtol=1e-6)
    assert (y.numpy().ravel()[~kept] == 0).all() and abs(kept.mean() - keep) < 0.02


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"lr": rng.integers(0, 65535, (ACCUM, MICRO, 16, 16, 1), dtype=np.uint16),
            "hr": rng.integers(0, 65535, (ACCUM, MICRO, 64, 64, 1), dtype=np.uint16)}


@pytest.fixture(scope="module")
def start():
    state, bundle = jax_state(jax.random.PRNGKey(0), **TINY, dtype=jnp.float32)
    return state, bundle, init_vgg_params(cutoff=35, seed=0)


def _assert_weights(got: dict, want: dict, what: str, noise_only=()):
    """``noise_only``: tensors whose gradient is 0 in exact arithmetic, so
    that AdamW turns each package's rounding noise into a step of up to lr:
    they are held to the 2.1e-4 bound alone."""
    assert set(got) == set(want), what
    bad = {}
    for k, w in want.items():
        g = got[k].detach().numpy()
        diff = np.abs(g - w.numpy())
        if diff.max() > 2.1e-4 or (k not in noise_only and (diff > 1e-6).mean() > 0.02):
            bad[k] = (diff.max(), (diff > 1e-6).mean(), diff.size)
    assert not bad, (what, bad)


@pytest.mark.parametrize("mode,fused", [("gan", False), ("warmup", False), ("gan", True),
                                        ("gan", "hab")])
def test_hat_train_step_matches_jax(start, mode, fused):
    state, bundle, vgg_params = start
    warmup = mode == "warmup"
    batch = _batch(3 + warmup)
    masks = _masks(5, sum(TINY["depths"]), MICRO)
    vgg_model = JaxVGG(cutoff=35)
    criterion = JaxCombined(pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005,
                            vgg_apply=lambda x: vgg_model.apply({"params": vgg_params}, x))
    step = jax_step(bundle, accum_steps=ACCUM, augment=False, criterion_g=criterion,
                    donate=False)
    with _flax_masks(masks, TINY["depths"]):
        new, m = step(state, batch, 1e-4, 1e-4, warmup=warmup)

    port = create_hat_train_state(torch.Generator().manual_seed(0), **TINY, fused=bool(fused),
                                  fused_hab=fused == "hab", device="cpu")
    port.g.load_state_dict(hybrid_state_dict_from_jax(_np_tree(state.g_params)))
    port.ema.load_state_dict(hybrid_state_dict_from_jax(_np_tree(state.ema)))
    port.d.load_state_dict(discriminator_hat_state_dict_from_jax(_np_tree(state.d_params),
                                                                 _np_tree(state.spectral)))
    d_before = {k: v.clone() for k, v in port.d.state_dict().items()}
    vgg = VGG19Features(35)
    vgg.load_state_dict(vgg19_state_dict_from_jax(_np_tree(vgg_params)))
    tstep = make_hat_train_step(port, accum_steps=ACCUM, augment=False, criterion_g=CombinedGANLoss(
        pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005,
        vgg_apply=vgg.requires_grad_(False)))
    with _torch_masks(masks):
        tm = tstep(batch, 1e-4, 1e-4, warmup=warmup)

    assert set(tm) == set(m)
    for k in m:
        np.testing.assert_allclose(tm[k], float(m[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if warmup:
        assert tm["g_adv"] == tm["loss_d"] == 0.0
        for k, v in port.d.state_dict().items():
            assert torch.equal(v, d_before[k]), k
    want_d = discriminator_hat_state_dict_from_jax(_np_tree(new.d_params),
                                                   _np_tree(new.spectral))
    got_d = port.d.state_dict()
    for k in want_d:
        if k.endswith(("weight_u", "weight_v")):
            np.testing.assert_allclose(got_d[k].numpy(), want_d[k].numpy(), atol=1e-5,
                                       err_msg=k)
    # RaGAN sees only differences of D's logits: conv9's bias, which shifts
    # them all alike, has no gradient but rounding noise
    _assert_weights(got_d, want_d, "D", noise_only=("conv9.bias",))
    _assert_weights(port.g.state_dict(), hybrid_state_dict_from_jax(_np_tree(new.g_params)), "G")
    _assert_weights(port.ema.state_dict(), hybrid_state_dict_from_jax(_np_tree(new.ema)), "EMA")
