"""``infer --arch hat`` end to end against the JAX ``run_test(folder, "hat")``.

A synthetic test split (4 pairs of 16 -> 64 uint16 TIFFs) and a run folder
holding ``best_hybrid_model.pth`` saved from bridged JAX weights go through
both packages; the JAX side loads the same ``.pth`` through its own
``detect_hybrid_params`` / ``hybrid_from_torch``. The hybrid has one stage of
6 blocks (the shape sniffing assumes 6 blocks and 6 heads per stage).

fp32 (``nn.Module`` path): both frameworks compute the same float32 math,
so PSNR agrees to 1e-3 dB, SSIM to 1e-5, each SR TIFF to 2 LSB (one rounding
flip of the 16-bit quantisation either way), and ``test_metrics.csv``, which
both write by default for the hybrid, row by row to the same bounds.
"""

import csv
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_def_tpu.cli.infer import run_test as jax_run_test
from superresolution_def_tpu.models import HybridHATRealESRGAN as FlaxHybrid
from superresolution_def_tpu_torch.cli.infer import run_test
from superresolution_def_tpu_torch.cli.main import main as cli_main
from superresolution_def_tpu_torch.data import (
    ManifestEntry,
    read_tiff_u16,
    write_manifest,
    write_tiff_u16,
)
from superresolution_def_tpu_torch.kernels import fused_hab_block, fused_ocab_block, fused_rdb_cm
from superresolution_def_tpu_torch.models import hybrid_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(img_size=16, in_chans=1, embed_dim=30, depths=(6,), num_heads=(6,), window_size=8,
            upscale=4, num_rrdb=1, num_feat=16, num_grow_ch=8)
N_PAIRS = 4
RUN = "T1_DDP_SwinIR"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """data/T1 test split + a best_hybrid_model.pth of bridged JAX weights."""
    root = tmp_path_factory.mktemp("hat_slice")
    rng = np.random.default_rng(0)
    entries = []
    for i in range(N_PAIRS):
        yy, xx = np.mgrid[0:64, 0:64] / 64.0
        hr = np.clip(0.5 + 0.3 * np.sin(6 * xx + i) * np.cos(4 * yy) +
                     0.05 * rng.standard_normal((64, 64)), 0, 1)
        d = root / "data" / "T1" / "pairs" / f"p{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "data" / "T1" / "8_dataset_split" / "splits_json" / "test.json", entries)

    params = FlaxHybrid(**TINY).init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 1)))["params"]
    sd = hybrid_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ckpt = root / "ckpt" / "best_hybrid_model.pth"
    ckpt.parent.mkdir()
    torch.save({"model_state_dict": {"module." + k: v for k, v in sd.items()}}, ckpt)
    return root, ckpt


def _run_folder(root, ckpt, side):
    folder = root / side / RUN
    (folder / "checkpoints").mkdir(parents=True)
    shutil.copy(ckpt, folder / "checkpoints" / "best_hybrid_model.pth")
    return folder


def _artifacts(folder):
    return sorted(p.name for p in (folder / "test_results").iterdir())


def _csv(folder):
    with open(folder / "test_results" / "test_metrics.csv") as f:
        return list(csv.reader(f))


def test_infer_hat_matches_jax_run_test_fp32(workspace):
    root, ckpt = workspace
    ours_dir, ref_dir = _run_folder(root, ckpt, "port"), _run_folder(root, ckpt, "jax")
    ours = run_test(ours_dir, "hat", data_root=str(root / "data"), lr_size=16, hr_size=64,
                    device="cpu")
    ref = jax_run_test(ref_dir, "hat", data_root=str(root / "data"), lr_size=16, hr_size=64)
    assert ours["num_images"] == ref["num_images"] == N_PAIRS
    assert ours["checkpoint"]["detected"] == ref["checkpoint"]["detected"]
    assert abs(ours["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(ours["ssim"] - ref["ssim"]) <= 1e-5
    for i in range(N_PAIRS):
        a, b = (read_tiff_u16(d / "test_results" / f"test_{i:04d}_sr.tiff").astype(np.int64)
                for d in (ours_dir, ref_dir))
        assert np.abs(a - b).max() <= 2
    assert _artifacts(ours_dir) == _artifacts(ref_dir)
    assert "test_metrics.csv" in _artifacts(ours_dir)
    ours_rows, ref_rows = _csv(ours_dir), _csv(ref_dir)
    assert ours_rows[0] == ref_rows[0] == ["ID", "PSNR", "SSIM"]
    assert len(ours_rows) == len(ref_rows) == N_PAIRS + 1
    for a, b in zip(ours_rows[1:], ref_rows[1:]):
        assert a[0] == b[0]
        assert abs(float(a[1]) - float(b[1])) <= 1e-3
        assert abs(float(a[2]) - float(b[2])) <= 1e-5


def test_infer_hat_fused_cli_on_cpu(workspace):
    """``--impl fused`` on the CPU: the kernels' plain versions, bf16, every
    artifact, finite metrics, no kernel launch."""
    root, ckpt = workspace
    folder = _run_folder(root, ckpt, "port_fused")
    res = cli_main(["infer", "--arch", "hat", "--impl", "fused", "--folder", str(folder),
                    "--data-root", str(root / "data"), "--lr-size", "16", "--hr-size", "64",
                    "--device", "cpu"])
    assert res["checkpoint"]["impl"] == "fused" and res["num_images"] == N_PAIRS
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
    assert _artifacts(folder) == sorted(
        [f"test_{i:04d}_{s}" for i in range(N_PAIRS) for s in ("sr.tiff", "tris.png")]
        + ["test_metrics.csv"])
    assert fused_hab_block.launches == fused_ocab_block.launches == fused_rdb_cm.launches == 0
