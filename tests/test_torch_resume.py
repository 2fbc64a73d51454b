"""``train`` resumes a run folder, as the JAX trainers do, and ``--no-resume`` starts over.

Tiny runs on the CPU (SwinIR embed 16, one stage of 2 blocks; the hybrid
with HAT embed 30, one stage of 2 blocks, one RRDB of F/G = 16/8), on
synthetic 16 -> 64 splits. Per architecture: one epoch, then ``--epochs
2`` in the same folder takes up at epoch 2 (its checkpoint and CSV row say
so, under the one header); for the hybrid, ``--no-resume`` then rewrites
the log from epoch 1 (the flag is shared code, so one architecture shows
it). ``_restore`` of a checkpoint into a fresh state gives exactly the saved
parameters, buffers (D's spectral-norm vectors) and optimizer state, and
moves every parameter's version, which is what the kernels' caches of
packed weights key on. The hat run resumes from the ``hybrid_epoch_N.pth``
of the largest N, compared as integers. The random streams are part of
the state: per architecture, one epoch resumed for a second gives the
generator weights of an uninterrupted two-epoch run bit for bit (the
augmentation draws, and the hybrid's drop-path draws, continue where they
stopped instead of repeating epoch 1's).
"""

import csv
import shutil

import numpy as np
import pytest
import torch

from superresolution_def_tpu_torch.cli.main import main
from superresolution_def_tpu_torch.cli.trainers import _restore, latest_epoch_checkpoint
from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
from superresolution_def_tpu_torch.train import create_hat_train_state, create_swin_train_state

torch.set_num_threads(1)

SWIN_ARGS = ["--arch", "swin", "--batch-size", "2", "--img-size", "16", "--embed-dim", "16",
             "--depths", "2", "--num-heads", "2"]
HAT_ARGS = ["--arch", "hat", "--warmup-epochs", "0", "--batch-size", "2", "--accum-steps", "1",
            "--img-size", "16", "--embed-dim", "30", "--depths", "2", "--num-heads", "6",
            "--num-rrdb", "1", "--num-feat", "16", "--num-grow-ch", "8", "--ckpt-interval", "1",
            "--img-interval", "1", "--csv-interval", "1"]


def _data(root):
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        entries = []
        for i in range(2):
            hr = rng.random((64, 64))
            d = root / "T1" / "pairs" / f"{split}{i}"
            write_tiff_u16(d / "hr.tiff", hr)
            write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
            entries.append(ManifestEntry(f"{split}{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
        write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / f"{split}.json", entries)


def _train(tmp_path, arch_args, *extra):
    return main(["train", "--target", "T1", "--device", "cpu", "--data-root",
                 str(tmp_path / "data"), "--outputs-root", str(tmp_path / "outputs"),
                 *arch_args, *extra])


def _epochs(csv_path):
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "Epoch" and all(r[0] != "Epoch" for r in rows[1:])
    return [r[0] for r in rows[1:]]


def _assert_restored(state, ck):
    for module, key in ((state.g, "net_g"), (state.d, "net_d"), (state.ema, "ema")):
        got = module.state_dict()
        assert set(got) == set(ck[key])
        assert all(torch.equal(got[k], ck[key][k]) for k in got), key
    for opt, key in ((state.g_opt, "optimizer_g"), (state.d_opt, "optimizer_d")):
        got, want = opt.state_dict()["state"], ck[key]["state"]
        assert set(got) == set(want) and len(got) > 0
        for i in got:
            assert all(torch.equal(torch.as_tensor(got[i][n]), torch.as_tensor(want[i][n]))
                       for n in want[i]), (key, i)


def test_swin_train_resumes(tmp_path):
    _data(tmp_path / "data")
    run = tmp_path / "outputs" / "T1_DDP_SwinIR"
    assert _train(tmp_path, SWIN_ARGS, "--epochs", "1")["epoch"] == 1
    ck1 = torch.load(run / "checkpoints" / "latest_checkpoint.pth", weights_only=False)

    state = create_swin_train_state(torch.Generator().manual_seed(7), img_size=16, embed_dim=16,
                                    depths=(2,), num_heads=(2,), device="cpu")
    versions = [p._version for p in state.g.parameters()]
    _restore(state, run / "checkpoints" / "latest_checkpoint.pth", "cpu")
    _assert_restored(state, ck1)
    assert all(p._version > v for p, v in zip(state.g.parameters(), versions))

    assert _train(tmp_path, SWIN_ARGS, "--epochs", "2")["epoch"] == 2
    ck2 = torch.load(run / "checkpoints" / "latest_checkpoint.pth", weights_only=False)
    assert ck2["epoch"] == 2 and ck2["best_psnr"] >= ck1["best_psnr"]
    assert _epochs(run / "metrics.csv") == ["1", "2"]


def test_hat_train_resumes_from_the_newest_epoch_and_no_resume_starts_over(tmp_path):
    _data(tmp_path / "data")
    run = tmp_path / "outputs" / "T1"
    ckpt = run / "checkpoints"
    assert _train(tmp_path, HAT_ARGS, "--epochs", "1")["epoch"] == 1
    ck1 = torch.load(ckpt / "hybrid_epoch_1.pth", weights_only=False)

    state = create_hat_train_state(torch.Generator().manual_seed(7), img_size=16, embed_dim=30,
                                   depths=(2,), num_heads=(6,), num_rrdb=1, num_feat=16,
                                   num_grow_ch=8, fused=True, fused_hab=True, device="cpu")
    versions = [p._version for p in state.g.parameters()]
    _restore(state, ckpt / "hybrid_epoch_1.pth", "cpu")
    _assert_restored(state, ck1)
    assert all(p._version > v for p, v in zip(state.g.parameters(), versions))

    assert _train(tmp_path, HAT_ARGS, "--epochs", "2")["epoch"] == 2
    assert torch.load(ckpt / "hybrid_epoch_2.pth", weights_only=False)["epoch"] == 2
    assert _epochs(run / "train_log.csv") == ["1", "2"]

    # the newest by epoch number, not by name: 10 after 9 and 2
    for n in (9, 10):
        (ckpt / f"hybrid_epoch_{n}.pth").write_bytes(b"")
    assert latest_epoch_checkpoint(ckpt).name == "hybrid_epoch_10.pth"
    for n in (9, 10):
        (ckpt / f"hybrid_epoch_{n}.pth").unlink()

    assert _train(tmp_path, HAT_ARGS, "--epochs", "1", "--no-resume")["epoch"] == 1
    assert _epochs(run / "train_log.csv") == ["1"]


@pytest.mark.parametrize("arch_args,run_name,last", [
    (SWIN_ARGS, "T1_DDP_SwinIR", "latest_checkpoint.pth"),
    (HAT_ARGS, "T1", "hybrid_epoch_2.pth"),
], ids=["swin", "hat"])
def test_resumed_run_continues_the_random_streams(tmp_path, arch_args, run_name, last):
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    for out in (straight, resumed):
        _data(out / "data")
    assert _train(straight, arch_args, "--epochs", "2")["epoch"] == 2
    hat = last.startswith("hybrid")
    ckpt = resumed / "outputs" / run_name / "checkpoints"
    if hat:  # the straight run keeps its epoch-1 checkpoint: resume from a copy
        ckpt.mkdir(parents=True)
        shutil.copy(straight / "outputs" / run_name / "checkpoints" / "hybrid_epoch_1.pth", ckpt)
    else:  # latest_checkpoint.pth is overwritten each epoch: train epoch 1 again
        assert _train(resumed, arch_args, "--epochs", "1")["epoch"] == 1
    ck1 = torch.load(ckpt / ("hybrid_epoch_1.pth" if hat else last), weights_only=False)
    assert ck1["epoch"] == 1
    assert "rng_augment" in ck1 and ("rng_drop_path" in ck1) == hat
    assert _train(resumed, arch_args, "--epochs", "2")["epoch"] == 2
    want, got = (torch.load(out / "outputs" / run_name / "checkpoints" / last,
                            weights_only=False) for out in (straight, resumed))
    assert want["epoch"] == got["epoch"] == 2
    for key in ("net_g", "ema"):
        assert all(torch.equal(got[key][k], want[key][k]) for k in want[key]), key
    assert torch.equal(got["rng_augment"], want["rng_augment"])
