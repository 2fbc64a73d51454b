"""The port's ``train --arch hat`` end to end on the CPU, then ``infer --arch hat`` of what it wrote.

A synthetic split (4 train and 2 test pairs of 16 -> 64 uint16 TIFFs)
trains a tiny hybrid (HAT embed 30, one stage of 6 blocks as the
checkpoint's shape sniffing expects, 6 heads; one RRDB of F/G = 16/8) for 2
epochs of 1 step of micro 2 x accum 2, the first L1-only (warmup), the
second the GAN, with every interval at 1 epoch. The run folder must hold
the reference layout: ``train_log.csv`` with the reference columns and a
row per epoch, a preview per epoch, and in ``checkpoints/``
``hybrid_epoch_{1,2}.pth`` (both networks, both optimizers, the EMA copy,
the epoch), ``best_hybrid_model.pth`` and ``best_hybrid_model_EMA.pth``;
the port's ``infer --arch hat`` reads the run.
"""

import csv

import numpy as np
import torch

from superresolution_def_tpu_torch.cli.main import main
from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
from superresolution_def_tpu_torch.obs import HAT_CSV_COLUMNS

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


def test_hat_train_cli_writes_the_run_and_infer_reads_it(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for name, count in (("train", 4), ("test", 2)):
        _split(data, name, count, rng)
    last = main(["train", "--arch", "hat", "--target", "T1", "--device", "cpu",
                 "--data-root", str(data), "--outputs-root", str(tmp_path / "outputs"),
                 "--epochs", "2", "--warmup-epochs", "1", "--batch-size", "2",
                 "--accum-steps", "2", "--img-size", "16", "--embed-dim", "30",
                 "--depths", "6", "--num-heads", "6", "--num-rrdb", "1", "--num-feat", "16",
                 "--num-grow-ch", "8", "--ckpt-interval", "1", "--img-interval", "1",
                 "--csv-interval", "1"])
    assert last["epoch"] == 2
    assert all(np.isfinite(last[k]) for k in ("g_total", "l1", "d_total", "psnr", "ssim"))
    assert last["d_total"] > 0 and last["g_adv"] > 0  # the second epoch ran the GAN
    run = tmp_path / "outputs" / "T1"
    with open(run / "train_log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == HAT_CSV_COLUMNS and [r[0] for r in rows[1:]] == ["1", "2"]
    assert float(rows[1][HAT_CSV_COLUMNS.index("D_Total")]) == 0.0  # warmup: no D phase
    assert (run / "previews" / "epoch_001_preview.png").exists()
    assert (run / "previews" / "epoch_002_preview.png").exists()

    ck = run / "checkpoints"
    for epoch in (1, 2):
        state = torch.load(ck / f"hybrid_epoch_{epoch}.pth", weights_only=False)
        assert {"net_g", "net_d", "optimizer_g", "optimizer_d", "ema", "epoch"} <= set(state)
        assert state["epoch"] == epoch
    assert any(k.endswith("weight_u") for k in state["net_d"])
    best = torch.load(ck / "best_hybrid_model.pth", weights_only=False)["model_state_dict"]
    ema = torch.load(ck / "best_hybrid_model_EMA.pth", weights_only=False)["model_state_dict"]
    key = "rrdb_trunk.0.rdb1.conv1.weight"
    assert torch.equal(best[key], state["net_g"][key])
    assert not torch.equal(best[key], ema[key])  # the EMA lags behind G

    res = main(["infer", "--arch", "hat", "--folder", str(run), "--data-root", str(data),
                "--lr-size", "16", "--hr-size", "64", "--device", "cpu"])
    assert res["num_images"] == 2
    assert res["checkpoint"]["source"].endswith("best_hybrid_model.pth")
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ssim"])
