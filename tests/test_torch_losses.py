"""VGG19 features, the losses, EMA, the cosine LR and the paired augmentation
against the JAX package, on numpy-seeded inputs.

fp32 throughout: the VGG features agree to 1e-4 of their largest entry (16
convs summed in other orders), every loss to 1e-5 relative, EMA to 1e-6,
the LR exactly, and the augmentation bit for bit (it only moves pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.data.augment import augment_pair_batch as jax_augment
from superresolution_def_tpu.train import ema as jax_ema
from superresolution_def_tpu.train import losses as jl
from superresolution_def_tpu.train.schedule import cosine_annealing_lr as jax_lr
from superresolution_def_tpu.train.vgg import VGG19Features as JaxVGG
from superresolution_def_tpu.train.vgg import init_vgg_params, vgg19_from_torch
from superresolution_def_tpu_torch.data import augment_pair_batch, draw_augment
from superresolution_def_tpu_torch.models import vgg19_state_dict_from_jax
from superresolution_def_tpu_torch.train import (
    CombinedGANLoss,
    DiscriminatorLoss,
    VGG19Features,
    charbonnier_loss,
    cosine_annealing_lr,
    ema_update,
    gan_loss,
    gram_matrix,
    l1_loss,
    relative_gan_loss,
    texture_loss,
)

# The suite runs in parallel worker processes on few cores, beside JAX tests
# whose CPU collectives abort when their threads starve: torch takes one
# thread per process (every worker imports this module at collection).
torch.set_num_threads(1)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def vgg_pair():
    params = init_vgg_params(cutoff=35, seed=0)
    port = VGG19Features(35)
    port.load_state_dict(vgg19_state_dict_from_jax(_np_tree(params)))
    model = JaxVGG(cutoff=35)
    return (lambda x: model.apply({"params": params}, x)), port.requires_grad_(False), params


def test_vgg_features_match_jax(vgg_pair):
    jax_vgg, port, params = vgg_pair
    x = np.random.default_rng(0).random((2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax_vgg(jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the bridge is the inverse of vgg19_from_torch
    back = vgg19_from_torch(port.state_dict())
    for name, p in _np_tree(params).items():
        np.testing.assert_array_equal(back[name]["kernel"], p["kernel"])
        np.testing.assert_array_equal(back[name]["bias"], p["bias"])


def _pair(seed, shape=(2, 8, 8, 1)):
    r = np.random.default_rng(seed)
    return r.standard_normal(shape).astype(np.float32), r.standard_normal(shape).astype(np.float32)


def _eq(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def test_pixel_and_gan_losses_match_jax():
    a, b = _pair(1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(l1_loss(ta, tb), jl.l1_loss(ja, jb))
    _eq(charbonnier_loss(ta, tb), jl.charbonnier_loss(ja, jb))
    for gan_type in ("vanilla", "lsgan", "ragan"):
        for real in (True, False):
            _eq(gan_loss(ta, real, gan_type), jl.gan_loss(ja, real, gan_type))
    for for_d in (True, False):
        _eq(relative_gan_loss(ta, tb, for_d), jl.relative_gan_loss(ja, jb, for_d))
    np.testing.assert_allclose(gram_matrix(ta).numpy(), np.asarray(jl.gram_matrix(ja)),
                               rtol=1e-5, atol=1e-7)
    _eq(texture_loss(ta, tb), jl.texture_loss(ja, jb))
    d, _ = DiscriminatorLoss()(ta, tb)
    _eq(d, jl.DiscriminatorLoss()(ja, jb)[0])
    _eq(DiscriminatorLoss("lsgan")(ta, tb)[0], jl.DiscriminatorLoss("lsgan")(ja, jb)[0])
    with pytest.raises(ValueError):
        gan_loss(ta, True, "hinge")


def test_combined_gan_loss_matches_jax(vgg_pair):
    jax_vgg, port, _ = vgg_pair
    sr, hr = (np.clip(v, 0, 1) for v in _pair(2, (2, 32, 32, 1)))
    dr, df = _pair(3, (2, 4, 4, 1))
    kw = dict(pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005)
    got, parts = CombinedGANLoss(**kw, vgg_apply=port)(
        *(torch.from_numpy(v) for v in (sr, hr, dr, df)))
    want, jparts = jl.CombinedGANLoss(**kw, vgg_apply=jax_vgg)(
        *(jnp.asarray(v) for v in (sr, hr, dr, df)))
    assert set(parts) == set(jparts)
    for k in parts:
        _eq(parts[k], jparts[k])
    _eq(got, want)


def test_ema_and_cosine_lr_match_jax():
    r = np.random.default_rng(4)
    shadow = torch.nn.Linear(3, 4)
    model = torch.nn.Linear(3, 4)
    s0 = {k: v.detach().numpy().copy() for k, v in shadow.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(r.standard_normal(p.shape).astype(np.float32)))
    p0 = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    ema_update(shadow, model, 0.999)
    want = jax_ema.ema_update(s0, p0, 0.999)
    for k, v in shadow.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7)
    for epoch in (1, 2, 150, 299, 300):
        assert cosine_annealing_lr(epoch, 1e-4, 300) == jax_lr(epoch, 1e-4, 300)


def test_augment_matches_jax_with_the_same_draws():
    """The JAX augmentation's own per-sample draws, fed to the port."""
    r = np.random.default_rng(5)
    lr = r.random((6, 4, 4, 1)).astype(np.float32)
    hr = r.random((6, 16, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want_lr, want_hr = jax_augment(jnp.asarray(lr), jnp.asarray(hr), key)
    draws = [[], [], []]
    for k in jax.random.split(key, lr.shape[0]):  # as data/augment.py::_augment_one draws
        kf, kv, kr = jax.random.split(k, 3)
        draws[0].append(bool(jax.random.bernoulli(kf)))
        draws[1].append(bool(jax.random.bernoulli(kv)))
        draws[2].append(int(jax.random.randint(kr, (), 0, 4)))
    draws = (torch.tensor(draws[0]), torch.tensor(draws[1]), torch.tensor(draws[2]))
    got_lr, got_hr = augment_pair_batch(torch.from_numpy(lr), torch.from_numpy(hr), draws)
    np.testing.assert_array_equal(got_lr.numpy(), np.asarray(want_lr))
    np.testing.assert_array_equal(got_hr.numpy(), np.asarray(want_hr))
    do_h, do_v, k = draw_augment(1000, torch.Generator().manual_seed(0))
    assert 0.4 < do_h.float().mean() < 0.6 and 0.4 < do_v.float().mean() < 0.6
    assert set(k.tolist()) == {0, 1, 2, 3}


def test_trainer_reads_the_jax_vgg_npz(vgg_pair, tmp_path):
    """--vgg-weights: the JAX package's npz of VGG params, read with numpy."""
    from superresolution_def_tpu_torch.cli.trainers import SwinTrainConfig, _load_vgg

    _, port, params = vgg_pair
    path = tmp_path / "vgg.npz"
    np.savez(path, params=np.array(_np_tree(params), dtype=object))
    loaded = _load_vgg(SwinTrainConfig(vgg_weights=str(path)), torch.float32, "cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
