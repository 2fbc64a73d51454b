"""The port's epoch loops (``cli/trainers.py``) as the JAX loops run them.

The port's mirror of ``tests/test_epoch_loop.py``: ``train_swin_run`` and
``train_hat_run`` on ``--device cpu`` at tiny widths (no perceptual term),
1 epoch cut to 2 steps by ``max_steps_per_epoch`` out of a longer stream.
The steps return their metrics as 0-d tensors; the loop keeps them, reads
``loss_g`` of the step ``_RUNAHEAD_SYNC`` back every ``_RUNAHEAD_SYNC``
steps (the bounded run-ahead), and drains them once at the epoch's end.
Checked: the staging thread is gone when the call returns, the run-ahead
reads are those steps' own scalars (at the module's bound of 8, and with it
set to 1 and 2), the epoch's numbers are what the steps' metrics give by
the JAX loops' formulas (JAX ``cli/trainers.py:334-339, 497-508``), and
the CSV row holds them.
"""

import csv
import threading

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.cli import trainers
from superresolution_def_tpu_torch.cli.trainers import (
    HATTrainConfig,
    SwinTrainConfig,
    train_hat_run,
    train_swin_run,
)
from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
from superresolution_def_tpu_torch.train import HAT_METRICS

torch.set_num_threads(1)

STEPS = 2


def _target(tmp_path, counts=(("train", 6), ("val", 2))):
    rng = np.random.default_rng(0)
    root = tmp_path / "data"
    for name, count in counts:
        entries = []
        for i in range(count):
            hr = rng.random((64, 64))
            d = root / "T1" / "pairs" / f"{name}{i}"
            write_tiff_u16(d / "hr.tiff", hr)
            write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
            entries.append(ManifestEntry(f"{name}{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
        write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / f"{name}.json",
                       entries)
    return root


def _record(monkeypatch, factory: str, runahead: int | None):
    """Every step's metrics as the step returned them, and every tensor the
    loop's run-ahead bound read; ``runahead`` sets ``_RUNAHEAD_SYNC``."""
    steps, reads = [], []
    make, wait = getattr(trainers, factory), trainers._wait_for

    def recording_factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(*a, **k):
            steps.append(step(*a, **k))
            return steps[-1]

        return recorded

    def recording_wait(value):
        reads.append(value)
        return wait(value)

    monkeypatch.setattr(trainers, factory, recording_factory)
    monkeypatch.setattr(trainers, "_wait_for", recording_wait)
    if runahead is not None:
        monkeypatch.setattr(trainers, "_RUNAHEAD_SYNC", runahead)
    return steps, reads


def _check_loop(steps, reads, runahead):
    bound = runahead or 8
    assert len(steps) == STEPS
    for m in steps:  # kept on the device: tensors, not floats
        assert all(isinstance(v, torch.Tensor) and v.shape == () for v in m.values())
    want = [steps[n - bound]["loss_g"] for n in range(bound, STEPS + 1, bound)]
    assert len(reads) == len(want) and all(r is w for r, w in zip(reads, want))
    # the early exit closed the staging thread: no batch stays staged
    assert not any(t.name == "mesh-prefetch" and t.is_alive() for t in threading.enumerate())


def _csv_row(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


@pytest.mark.parametrize("runahead", [None, 1, 2])
def test_swin_loop_defers_the_reads(tmp_path, monkeypatch, runahead):
    steps, reads = _record(monkeypatch, "make_swin_train_step", runahead)
    cfg = SwinTrainConfig(
        targets=("T1",), data_root=str(_target(tmp_path)),
        outputs_root=str(tmp_path / "outputs"), epochs=1, batch_size=1, accum_steps=1,
        img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), use_vgg=False,
        max_steps_per_epoch=STEPS, device="cpu")
    last = train_swin_run(cfg, resume=False)
    _check_loop(steps, reads, runahead)

    # JAX cli/trainers.py:334-339: the valid-weighted means over the steps
    g_sum = d_sum = valid = 0.0
    for m in steps:
        g_sum += float(m["loss_g"]) * float(m["valid_batches"])
        d_sum += float(m["loss_d"]) * float(m["valid_batches"])
        valid += float(m["valid_batches"])
    assert valid == STEPS
    assert last["loss_g"] == g_sum / valid and last["loss_d"] == d_sum / valid
    assert np.isfinite(last["psnr"])
    row = _csv_row(tmp_path / "outputs" / "T1_DDP_SwinIR" / "metrics.csv")
    assert [float(row[k]) for k in ("Epoch", "Loss_G", "Loss_D", "PSNR", "SSIM")] == [
        1.0, last["loss_g"], last["loss_d"], last["psnr"], last["ssim"]]


@pytest.mark.parametrize("runahead", [None, 1])
def test_hat_loop_defers_the_reads(tmp_path, monkeypatch, runahead):
    steps, reads = _record(monkeypatch, "make_hat_train_step", runahead)
    cfg = HATTrainConfig(
        targets=("T1",), data_root=str(_target(tmp_path, (("train", 6),))),
        outputs_root=str(tmp_path / "outputs"), epochs=1, warmup_epochs=0, batch_size=1,
        accum_steps=2, img_size=16, embed_dim=30, depths=(2,), num_heads=(6,), num_rrdb=1,
        num_feat=16, num_grow_ch=8, use_vgg=False, csv_interval=1,
        max_steps_per_epoch=STEPS, device="cpu")
    last = train_hat_run(cfg, resume=False)
    _check_loop(steps, reads, runahead)

    # JAX cli/trainers.py:497-508: sums over the steps, means over the steps
    # and, for PSNR and SSIM, over the patches
    sums = {k: sum(float(m[k]) for m in steps) for k in HAT_METRICS}
    assert sums["count"] == STEPS * 2 and sums["loss_d"] > 0  # the GAN ran
    assert last == {"epoch": 1, "g_total": sums["loss_g"] / STEPS, "l1": sums["l1"] / STEPS,
                    "g_adv": sums["g_adv"] / STEPS, "d_total": sums["loss_d"] / STEPS,
                    "psnr": sums["psnr_sum"] / sums["count"],
                    "ssim": sums["ssim_sum"] / sums["count"], "lr": last["lr"]}
    row = _csv_row(tmp_path / "outputs" / "T1" / "train_log.csv")
    assert [float(row[k]) for k in ("G_Total", "L1", "G_Adv", "D_Total", "PSNR", "SSIM")] == [
        last[k] for k in ("g_total", "l1", "g_adv", "d_total", "psnr", "ssim")]
