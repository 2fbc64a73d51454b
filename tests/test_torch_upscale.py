"""The port's tiled inference and ``upscale`` against the JAX package's.

Tolerances:
- a local op (nearest x s) through ``tiled_sr``: the feather blend of equal
  values is exact up to float32 rounding of the weights, atol 1e-5, and the
  port's blend is the JAX one's to 1e-6;
- a tiny SwinIR on the same weights, fp32 on both sides, blended
  tiles to atol 1e-4 (the frameworks' matmul and softmax orders differ);
- ``upscale``'s 16-bit TIFF: the SR values differ by ~1e-5, so a code may
  flip once at the quantization in each direction: 2 LSB.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.cli import main as jcli
from superresolution_def_tpu.cli.infer import load_generator as jax_load_generator
from superresolution_def_tpu.cli.infer import tiled_sr as jax_tiled_sr
from superresolution_def_tpu.prep import TanWCS, write_fits
from superresolution_def_tpu_torch.cli.infer import load_generator, tiled_sr
from superresolution_def_tpu_torch.cli.main import main as cli_main
from superresolution_def_tpu_torch.data import read_tiff_u16, write_tiff_u16
from superresolution_def_tpu_torch.kernels import make_fused_swinir
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR

torch.set_num_threads(1)

SWIN = dict(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
            mlp_ratio=2.0, upscale=4)
HYBRID = dict(img_size=16, in_chans=1, embed_dim=30, depths=(6,), num_heads=(6,), window_size=8,
              num_rrdb=1, num_feat=16, num_grow_ch=8)
# a frame the 32-px tiles do not divide: 2 x 2 tiles, the last row and
# column moved back to the border, one padded batch of 8
FRAME = (40, 56)
TILES = dict(tile=32, overlap=4)


def _nearest(s):
    return lambda x: x.repeat_interleave(s, 1).repeat_interleave(s, 2)


def _jax_nearest(s):
    return lambda params, x: jnp.repeat(jnp.repeat(x, s, axis=1), s, axis=2)


@pytest.mark.parametrize("shape,tile,overlap,scale", [((80, 112), 48, 8, 4),
                                                      ((20, 30), 32, 4, 2)])
def test_tiled_sr_is_exact_on_a_local_op(shape, tile, overlap, scale):
    """The cases of tests/test_infer.py:86-107: a tiled frame and one
    smaller than a tile (reflect-padded to it)."""
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    out = tiled_sr(_nearest(scale), img, tile=tile, overlap=overlap, scale=scale, device="cpu")
    ref = np.repeat(np.repeat(img[..., None], scale, axis=0), scale, axis=1)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-5)
    want = jax_tiled_sr(_jax_nearest(scale), {}, img, tile=tile, overlap=overlap, scale=scale)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)


def test_tiled_sr_calls_have_one_shape():
    shapes = []

    def forward(x):
        shapes.append(tuple(x.shape))
        return _nearest(4)(x)

    img = np.random.default_rng(2).random((124, 130)).astype(np.float32)
    tiled_sr(forward, img, tile=32, overlap=4, batch_tiles=8, device="cpu")
    # 5 x 6 = 30 tiles: four calls of 8, the last padded
    assert shapes == [(8, 32, 32, 1)] * 4
    with pytest.raises(ValueError, match="overlap"):
        tiled_sr(forward, img, tile=32, overlap=16, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run folders holding seeded port weights, SwinIR and the hybrid, in the
    reference trainers' .pth layouts; the JAX side reads the same files."""
    root = tmp_path_factory.mktemp("upscale")
    with torch.random.fork_rng():
        torch.manual_seed(1)
        models = {"swin": SwinIR(**SWIN, generator=torch.Generator().manual_seed(1)),
                  "hat": HybridHATRealESRGAN(**HYBRID)}
    out = {}
    for arch, name, key in (("swin", "best_gan_model.pth", "net_g"),
                            ("hat", "best_hybrid_model.pth", "model_state_dict")):
        run = root / arch / "checkpoints"
        run.mkdir(parents=True)
        sd = models[arch].state_dict()
        torch.save({key: {"module." + k: v for k, v in sd.items()}}, run / name)
        out[arch] = run.parent
    return out


def _frame01():
    yy, xx = np.mgrid[0:FRAME[0], 0:FRAME[1]] / 32.0
    rng = np.random.default_rng(3)
    return np.clip(0.5 + 0.3 * np.sin(5 * xx) * np.cos(3 * yy)
                   + 0.05 * rng.standard_normal(FRAME), 0, 1).astype(np.float32)


def test_tiled_swinir_matches_jax(runs):
    img = _frame01()
    apply_fn, params, _ = jax_load_generator(runs["swin"], "swin")
    want = jax_tiled_sr(apply_fn, params, img, **TILES)
    model, _ = load_generator(runs["swin"], "cpu", "swin")
    got = tiled_sr(model, img, **TILES, device="cpu")
    assert got.shape == (FRAME[0] * 4, FRAME[1] * 4, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # K1's plain version in fp32 through the same tiles: the fused forward's
    # wiring (NHWC in and out, one shape a call), within the same bound
    fused = tiled_sr(make_fused_swinir(model, dtype=torch.float32), img, **TILES, device="cpu")
    np.testing.assert_allclose(fused, got, rtol=0, atol=1e-4)


def _write_inputs(root):
    """A 16-bit TIFF and a FITS frame (sky counts with NaNs and a floor)."""
    img = _frame01()
    write_tiff_u16(root / "frame.tiff", img)
    counts = (np.exp(img * 3.0) - 1.0).astype(np.float32)
    counts[:2, :5] = np.nan
    counts[-3:] = 0.0
    w = TanWCS((10.0, 20.0), (FRAME[1] / 2, FRAME[0] / 2), cdelt=[-2e-4, 2e-4])
    write_fits(root / "frame.fits", counts, w.to_header())


@pytest.mark.parametrize("arch,fmt", [("swin", "fits"), ("swin", "tiff"), ("hat", "fits")])
def test_upscale_cli_matches_jax(runs, tmp_path, arch, fmt):
    """`upscale --device cpu` against the JAX `cmd_upscale` over the same
    .pth: FITS through robust_minmax and the log stretch, TIFF /65535."""
    _write_inputs(tmp_path)
    src = str(tmp_path / f"frame.{fmt}")
    args = ["upscale", src, "--folder", str(runs[arch]), "--arch", arch, "--tile", "32",
            "--overlap", "4"]
    jcli.main([*args, "--out", str(tmp_path / "jax.tiff")])
    res = cli_main([*args, "--out", str(tmp_path / "port.tiff"), "--device", "cpu"])
    assert res["shape"] == (FRAME[0] * 4, FRAME[1] * 4)
    want = read_tiff_u16(tmp_path / "jax.tiff").astype(np.int64)
    got = read_tiff_u16(tmp_path / "port.tiff").astype(np.int64)
    assert got.shape == want.shape == res["shape"]
    assert np.abs(got - want).max() <= 2
    assert want.std() > 100  # the frame is not flat


def test_upscale_default_output_path(runs, tmp_path):
    _write_inputs(tmp_path)
    shutil.copy(tmp_path / "frame.tiff", tmp_path / "m42.tiff")
    res = cli_main(["upscale", str(tmp_path / "m42.tiff"), "--folder", str(runs["swin"]),
                    "--tile", "64", "--overlap", "8", "--device", "cpu"])
    assert res["out"] == str(tmp_path / "m42_sr.tiff")
    assert read_tiff_u16(res["out"]).shape == (FRAME[0] * 4, FRAME[1] * 4)
