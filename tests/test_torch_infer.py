"""The slice end to end: the port's `infer` against the JAX `run_test`.

A synthetic test split (4 pairs of 16 -> 64 uint16 TIFFs) and a run folder
holding ``best_gan_model.pth`` saved from bridged JAX weights go through
both packages; the JAX side loads the same ``.pth``.

fp32 (``nn.Module`` path): both frameworks compute the same float32 math,
so PSNR agrees to 1e-3 dB, SSIM to 1e-5 and each SR TIFF to 2 LSB (one
rounding flip of the 16-bit quantisation either way).

bf16 (``--impl fused``, against the JAX fused path in interpret mode): the
output is a bf16 value (8 significant bits) and the frameworks round at
different places, so a pixel may flip by a bf16 step of its value (2**-8
near 1.0, 256 LSB): bounded by two such steps, PSNR by 1e-2 dB and SSIM by
1e-4.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from superresolution_def_tpu.cli.infer import run_test as jax_run_test
from superresolution_def_tpu.models import SwinIR as FlaxSwinIR
from superresolution_def_tpu_torch.cli.infer import run_test, targets_from_folder_name
from superresolution_def_tpu_torch.cli.main import main as cli_main
from superresolution_def_tpu_torch.data import (
    ManifestEntry,
    read_tiff_u16,
    write_manifest,
    write_tiff_u16,
)
from superresolution_def_tpu_torch.kernels import fused_swin_block
from superresolution_def_tpu_torch.models import swinir_state_dict_from_jax

TINY = dict(img_size=16, in_chans=1, embed_dim=16, depths=(2,), num_heads=(2,),
            window_size=8, mlp_ratio=2.0, upscale=4)
N_PAIRS = 4
RUN = "T1_DDP_SwinIR"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """data/T1 test split + one run folder with the bridged checkpoint."""
    root = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(N_PAIRS):
        hr = rng.random((64, 64))
        lr = hr.reshape(16, 4, 16, 4).mean(axis=(1, 3))
        d = root / "data" / "T1" / "pairs" / f"p{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", lr)
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "data" / "T1" / "8_dataset_split" / "splits_json" / "test.json", entries)

    params = FlaxSwinIR(**TINY).init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))["params"]
    sd = swinir_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ckpt = root / "ckpt" / "best_gan_model.pth"
    ckpt.parent.mkdir()
    # the reference trainer's layout: {'net_g': state_dict} with 'module.' keys
    torch.save({"net_g": {"module." + k: v for k, v in sd.items()}, "epoch": 3}, ckpt)
    return root, ckpt


def _run_folder(root, ckpt, side):
    folder = root / side / RUN
    folder.mkdir(parents=True)
    shutil.copy(ckpt, folder / "best_gan_model.pth")
    return folder


def _sr_tiffs(folder):
    return [read_tiff_u16(folder / "test_results" / f"test_{i:04d}_sr.tiff").astype(np.int64)
            for i in range(N_PAIRS)]


def _artifacts(folder):
    return sorted(p.name for p in (folder / "test_results").iterdir())


def test_targets_from_folder_name():
    assert targets_from_folder_name("M1_M33_DDP_SwinIR") == ["M1", "M33"]
    assert targets_from_folder_name("M42") == ["M42"]


def test_infer_matches_jax_run_test_fp32(workspace):
    root, ckpt = workspace
    ours_dir, ref_dir = _run_folder(root, ckpt, "port"), _run_folder(root, ckpt, "jax")
    ours = run_test(ours_dir, "swin", data_root=str(root / "data"), lr_size=16, hr_size=64,
                    write_csv=True, device="cpu")
    ref = jax_run_test(ref_dir, "swin", data_root=str(root / "data"), lr_size=16, hr_size=64,
                       write_csv=True)
    assert ours["num_images"] == ref["num_images"] == N_PAIRS
    assert ours["checkpoint"]["detected"] == ref["checkpoint"]["detected"]
    assert abs(ours["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(ours["ssim"] - ref["ssim"]) <= 1e-5
    for a, b in zip(_sr_tiffs(ours_dir), _sr_tiffs(ref_dir)):
        assert np.abs(a - b).max() <= 2
    assert _artifacts(ours_dir) == _artifacts(ref_dir)
    assert "test_metrics.csv" in _artifacts(ours_dir)


def test_infer_fused_cli_matches_jax_fused_run_test(workspace):
    root, ckpt = workspace
    ours_dir, ref_dir = _run_folder(root, ckpt, "port_fused"), _run_folder(root, ckpt, "jax_fused")
    ours = cli_main(["infer", "--arch", "swin", "--impl", "fused", "--folder", str(ours_dir),
                     "--data-root", str(root / "data"), "--lr-size", "16", "--hr-size", "64",
                     "--device", "cpu"])
    with pltpu.force_tpu_interpret_mode():
        ref = jax_run_test(ref_dir, "swin", data_root=str(root / "data"), lr_size=16,
                           hr_size=64, impl="fused")
    assert ours["checkpoint"]["impl"] == ref["checkpoint"]["impl"] == "fused"
    assert ours["num_images"] == ref["num_images"] == N_PAIRS
    for a, b in zip(_sr_tiffs(ours_dir), _sr_tiffs(ref_dir)):
        assert np.abs(a - b).max() <= 2 * 2**-8 * 65535
    assert abs(ours["psnr"] - ref["psnr"]) <= 1e-2
    assert abs(ours["ssim"] - ref["ssim"]) <= 1e-4
    assert _artifacts(ours_dir) == _artifacts(ref_dir)
    assert fused_swin_block.launches == 0  # CPU tensors take the plain version
