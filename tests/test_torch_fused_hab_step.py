"""One GAN step of the port's fused-HAB hybrid state against the JAX package's.

``create_hat_train_state(fused=True, fused_hab=True, device="cpu")`` (the
plain versions of K7-K10 behind the autograd nodes) against the JAX state
with ``fused=True, fused_hab=True, fused_interpret=True`` (its Pallas kernels
in interpret mode) at the sizes of tests/test_fused_hat_train.py: img 64
(the JAX fused path needs a trunk width that is a multiple of 128), embed
30, one stage of 2 blocks, 6 heads, one RRDB of 16/8; micro 1 x accum 1,
augmentation and drop-path off (the JAX step draws its masks from its own
key; tests/test_torch_fused_hat_train.py holds the drop-path). Bounds are
those of tests/test_torch_hat_train.py. The JAX side's interpret mode takes
most of this file's two to three minutes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(1)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def test_fused_hab_gan_step_matches_jax():
    from superresolution_def_tpu.train import create_hat_train_state as jax_state
    from superresolution_def_tpu.train import make_hat_train_step as jax_step
    from superresolution_def_tpu.train.losses import CombinedGANLoss as JaxCombined
    from superresolution_def_tpu.train.vgg import VGG19Features as JaxVGG
    from superresolution_def_tpu.train.vgg import init_vgg_params
    from superresolution_def_tpu_torch.models import (
        discriminator_hat_state_dict_from_jax,
        hybrid_state_dict_from_jax,
        vgg19_state_dict_from_jax,
    )
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss,
        VGG19Features,
        create_hat_train_state,
        make_hat_train_step,
    )
    from test_torch_hat_train import _assert_weights

    cfg = dict(img_size=64, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8,
               num_rrdb=1, num_feat=16, num_grow_ch=8, drop_path_rate=0.0)
    state, bundle = jax_state(jax.random.PRNGKey(0), **cfg, dtype=jnp.float32, fused=True,
                              fused_hab=True, fused_interpret=True)
    vgg_params = init_vgg_params(cutoff=35, seed=0)
    rng = np.random.default_rng(3)
    batch = {"lr": rng.integers(0, 65535, (1, 1, 64, 64, 1), dtype=np.uint16),
             "hr": rng.integers(0, 65535, (1, 1, 256, 256, 1), dtype=np.uint16)}
    vgg_model = JaxVGG(cutoff=35)
    criterion = JaxCombined(pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005,
                            vgg_apply=lambda x: vgg_model.apply({"params": vgg_params}, x))
    step = jax_step(bundle, accum_steps=1, augment=False, criterion_g=criterion, donate=False)
    # the step is one jitted program; it is waited for before anything else
    # runs (eager JAX ops beside an interpreted kernel's callbacks can
    # deadlock the CPU client)
    with pltpu.force_tpu_interpret_mode():
        new, m = jax.block_until_ready(step(state, batch, 1e-4, 1e-4, warmup=False))

    port = create_hat_train_state(torch.Generator().manual_seed(0), **cfg, fused=True,
                                  fused_hab=True, device="cpu")
    port.g.load_state_dict(hybrid_state_dict_from_jax(_np_tree(state.g_params)))
    port.ema.load_state_dict(hybrid_state_dict_from_jax(_np_tree(state.ema)))
    port.d.load_state_dict(discriminator_hat_state_dict_from_jax(_np_tree(state.d_params),
                                                                 _np_tree(state.spectral)))
    vgg = VGG19Features(35)
    vgg.load_state_dict(vgg19_state_dict_from_jax(_np_tree(vgg_params)))
    tstep = make_hat_train_step(port, accum_steps=1, augment=False, criterion_g=CombinedGANLoss(
        pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005,
        vgg_apply=vgg.requires_grad_(False)))
    tm = tstep(batch, 1e-4, 1e-4)
    assert set(tm) == set(m)
    for k in m:
        np.testing.assert_allclose(float(tm[k]), float(m[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want_d = discriminator_hat_state_dict_from_jax(_np_tree(new.d_params),
                                                   _np_tree(new.spectral))
    _assert_weights(port.d.state_dict(), want_d, "D", noise_only=("conv9.bias",))
    _assert_weights(port.g.state_dict(), hybrid_state_dict_from_jax(_np_tree(new.g_params)), "G")
    _assert_weights(port.ema.state_dict(), hybrid_state_dict_from_jax(_np_tree(new.ema)), "EMA")
