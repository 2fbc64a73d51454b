"""The port's ``train`` command end to end on the CPU, then ``infer`` of what it wrote.

A synthetic split (4 train, 2 val and 2 test pairs of 16 -> 64 uint16 TIFFs)
trains a tiny SwinIR GAN (embed 16, one stage of 2 blocks) for 2 epochs of
1 step (micro 2). The run folder must hold the reference layout: a
``metrics.csv`` row per epoch with the reference columns, a preview per
epoch, ``checkpoints/best_gan_model.pth`` as ``{'net_g': EMA weights}`` and
``checkpoints/latest_checkpoint.pth`` with both networks, both optimizers,
the EMA copy and the epoch; the port's ``infer`` reads the best checkpoint.
"""

import csv

import numpy as np
import torch

from superresolution_def_tpu_torch.cli.main import main
from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
from superresolution_def_tpu_torch.obs import SWIN_CSV_COLUMNS

# The suite runs in parallel worker processes on few cores, beside JAX tests
# whose CPU collectives abort when their threads starve: torch takes one
# thread per process (every worker imports this module at collection).
torch.set_num_threads(1)


def _split(root, name, count, rng):
    entries = []
    for i in range(count):
        hr = rng.random((64, 64))
        d = root / "T1" / "pairs" / f"{name}{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
        entries.append(ManifestEntry(f"{name}{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / f"{name}.json", entries)


def test_train_cli_writes_the_run_and_infer_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for name, count in (("train", 4), ("val", 2), ("test", 2)):
        _split(data, name, count, rng)
    last = main(["train", "--arch", "swin", "--target", "T1", "--device", "cpu",
                 "--data-root", str(data), "--outputs-root", str(tmp_path / "outputs"),
                 "--epochs", "2", "--max-steps-per-epoch", "1", "--batch-size", "2",
                 "--img-size", "16", "--embed-dim", "16", "--depths", "2", "--num-heads", "2"])
    assert last["epoch"] == 2
    assert np.isfinite(last["loss_g"]) and np.isfinite(last["loss_d"])
    run = tmp_path / "outputs" / "T1_DDP_SwinIR"
    with open(run / "metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == SWIN_CSV_COLUMNS and [r[0] for r in rows[1:]] == ["1", "2"]
    assert (run / "images" / "epoch_001.png").exists()
    assert (run / "images" / "epoch_002.png").exists()

    best = torch.load(run / "checkpoints" / "best_gan_model.pth", weights_only=False)
    latest = torch.load(run / "checkpoints" / "latest_checkpoint.pth", weights_only=False)
    assert set(best) == {"net_g"}
    assert {"net_g", "net_d", "optimizer_g", "optimizer_d", "ema", "epoch",
            "best_psnr"} <= set(latest)
    assert latest["epoch"] == 2
    assert any(k.endswith("weight_u") for k in latest["net_d"])
    # the G weights moved from their seeded start, and the EMA lags behind them
    assert set(best["net_g"]) == set(latest["ema"])
    key = "layers.0.0.attn.qkv.weight"
    assert not torch.equal(latest["net_g"][key], latest["ema"][key])

    res = main(["infer", "--arch", "swin", "--folder", str(run), "--data-root", str(data),
                "--lr-size", "16", "--hr-size", "64", "--device", "cpu"])
    assert res["num_images"] == 2
    assert res["checkpoint"]["source"].endswith("best_gan_model.pth")
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
