"""The modules and names the port took over last, against the JAX package.

- ``cli/port_vgg.py``: ``convert`` writes the JAX ``convert``'s npz from a
  seeded torchvision-layout VGG19 ``.pth``; the trainers' ``_load_vgg``
  reads that ``.pth`` and that npz to the same features.
- ``models/srvgg.py``: ``SRVGGNetCompact`` against the JAX module for each
  activation (num_feat 16, num_conv 4, fp32, within 1e-5), its weights
  bridged by ``torch_port.srvgg_from_torch`` and back by
  ``srvgg_state_dict_from_jax``.
- ``ops``' ``pixel_unshuffle``, ``gaussian_window`` and
  ``interpolate_nearest``; ``data.merge_manifests``; ``train``'s
  ``mse_loss``, ``ema_init`` (then ``ema_update``) and ``init_vgg_params``.
- Every name the JAX subpackages export, or its stated counterpart, is
  exported by the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu import ops as jops
from superresolution_def_tpu.cli import port_vgg as jport_vgg
from superresolution_def_tpu.data import manifest as jmanifest
from superresolution_def_tpu.models import SRVGGNetCompact as JaxSRVGG
from superresolution_def_tpu.models.torch_port import srvgg_from_torch
from superresolution_def_tpu.train import ema as jema
from superresolution_def_tpu.train import losses as jlosses
from superresolution_def_tpu_torch import cli, data, models, ops, train
from superresolution_def_tpu_torch.cli import port_vgg
from superresolution_def_tpu_torch.cli.trainers import SwinTrainConfig, _load_vgg
from superresolution_def_tpu_torch.models import SRVGGNetCompact, srvgg_state_dict_from_jax
from superresolution_def_tpu_torch.train import VGG19Features

torch.set_num_threads(1)


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def test_port_vgg_writes_the_jax_npz_and_both_files_load_to_the_same_features(tmp_path):
    sd = VGG19Features(generator=torch.Generator().manual_seed(3)).state_dict()
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # torchvision's vgg19 carries its head too
    pth = tmp_path / "vgg19.pth"
    torch.save(sd, pth)
    port_vgg.convert(str(pth), str(tmp_path / "port.npz"))
    jport_vgg.convert(str(pth), str(tmp_path / "jax.npz"))
    ours = np.load(tmp_path / "port.npz", allow_pickle=True)["params"].item()
    ref = np.load(tmp_path / "jax.npz", allow_pickle=True)["params"].item()
    assert sorted(ours) == sorted(ref) and len(ours) == 16
    for name in ref:
        for k in ("kernel", "bias"):
            assert ours[name][k].dtype == ref[name][k].dtype
            np.testing.assert_array_equal(ours[name][k], ref[name][k])

    x = torch.from_numpy(np.random.default_rng(0).random((1, 16, 16, 1), np.float32))
    feats = []
    for weights in (pth, tmp_path / "port.npz", None):
        vgg = _load_vgg(SwinTrainConfig(vgg_weights=weights and str(weights)), torch.float32,
                        "cpu")
        with torch.no_grad():
            feats.append(vgg(x))
    np.testing.assert_array_equal(feats[0].numpy(), feats[1].numpy())
    assert not torch.equal(feats[0], feats[2])  # not the seeded fall-back


@pytest.mark.parametrize("act", ["relu", "leakyrelu", "prelu"])
def test_srvgg_matches_the_jax_module(act):
    cfg = dict(num_in_ch=3, num_out_ch=3, num_feat=16, num_conv=4, upscale=4, act_type=act)
    model = SRVGGNetCompact(**cfg, generator=torch.Generator().manual_seed(1))
    if act == "prelu":  # slopes away from their init, so a misplaced one shows
        with torch.no_grad():
            for m in model.body:
                if isinstance(m, torch.nn.PReLU):
                    m.weight.uniform_(0.05, 0.5, generator=torch.Generator().manual_seed(2))
    sd = _np(model.state_dict())
    params = srvgg_from_torch(sd, num_conv=4)
    back = srvgg_state_dict_from_jax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    x = np.random.default_rng(4).random((2, 12, 10, 3), np.float32)
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxSRVGG(**cfg).apply({"params": params}, jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 48, 40, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_srvgg_rejects_an_unknown_activation():
    with pytest.raises(ValueError, match="act_type"):
        SRVGGNetCompact(act_type="gelu")


@pytest.mark.parametrize("size", [(8, 12), (5, 7), (17, 3), (24, 36)])
def test_interpolate_nearest_matches_jax(size):
    x = np.random.default_rng(5).random((2, 6, 9, 3), np.float32)
    np.testing.assert_array_equal(ops.interpolate_nearest(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jops.interpolate_nearest(jnp.asarray(x), size)))


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_unshuffle_matches_jax_and_inverts_pixel_shuffle(r):
    x = np.random.default_rng(6).random((2, 4 * r, 3 * r, 2), np.float32)
    ours = ops.pixel_unshuffle(torch.from_numpy(x), r)
    ref = jops.pixel_unshuffle(jnp.asarray(x), r)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ops.pixel_shuffle(ours, r).numpy(), x)


@pytest.mark.parametrize("window,sigma", [(11, 1.5), (7, 1.0)])
def test_gaussian_window_matches_jax(window, sigma):
    ours, ref = ops.gaussian_window(window, sigma), jops.gaussian_window(window, sigma)
    assert ours.dtype == np.float32 and ours.shape == (window, window)
    np.testing.assert_array_equal(ours, ref)


def test_merge_manifests_matches_jax(tmp_path):
    paths = []
    for t in range(2):
        entries = [data.ManifestEntry(f"t{t}p{i}", f"/old/data/T{t}/h{i}.tiff",
                                      f"/old/data/T{t}/g{i}.tiff") for i in range(3)]
        paths.append(tmp_path / f"T{t}.json")
        data.write_manifest(paths[-1], entries)
    ours = data.merge_manifests(paths, tmp_path)
    ref = jmanifest.merge_manifests(paths, tmp_path)
    assert [e.to_json() for e in ours] == [e.to_json() for e in ref] and len(ours) == 6


def test_mse_loss_matches_jax():
    rng = np.random.default_rng(7)
    a, b = rng.random((2, 8, 8, 1), np.float32), rng.random((2, 8, 8, 1), np.float32)
    ours = float(train.mse_loss(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(ours, float(jlosses.mse_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def test_ema_init_copies_and_then_follows_jax_ema_update():
    model = SRVGGNetCompact(1, 1, 8, 2, generator=torch.Generator().manual_seed(0))
    shadow = train.ema_init(model)
    assert not any(p.requires_grad for p in shadow.parameters())
    assert all(a.data_ptr() != b.data_ptr() and torch.equal(a, b)
               for a, b in zip(shadow.parameters(), model.parameters()))
    ref = jema.ema_init(srvgg_from_torch(_np(model.state_dict()), num_conv=2))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    train.ema_update(shadow, model, decay=0.9)
    ref = jema.ema_update(ref, srvgg_from_torch(_np(model.state_dict()), num_conv=2), 0.9)
    got = srvgg_from_torch(_np(shadow.state_dict()), num_conv=2)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6), got, ref)


def test_init_vgg_params_is_the_seeded_vgg():
    sd = train.init_vgg_params(seed=4)
    want = VGG19Features(generator=torch.Generator().manual_seed(4)).state_dict()
    assert sorted(sd) == sorted(want)
    assert all(torch.equal(sd[k], want[k]) for k in sd)
    other = train.init_vgg_params(seed=5)
    assert not torch.equal(sd["features.0.weight"], other["features.0.weight"])


@pytest.mark.parametrize("package,names", [
    (ops, ["pixel_unshuffle", "gaussian_window", "interpolate_nearest"]),
    (data, ["merge_manifests", "synth_pair", "synth_batch_u16"]),
    (train, ["mse_loss", "ema_init", "init_vgg_params", "vgg19_from_torch"]),
    (cli, ["SwinTrainConfig", "HATTrainConfig", "train_swin_run", "train_hat_run"]),
    (models, ["SRVGGNetCompact"]),
])
def test_the_jax_exports_are_exported(package, names):
    for name in names:
        assert name in package.__all__ and callable(getattr(package, name))


def test_gan_train_state_is_named_not_aliased():
    assert not hasattr(train, "GANTrainState")
    assert "GANTrainState" in train.__doc__
    assert "SwinTrainState" in train.__doc__ and "HATTrainState" in train.__doc__
