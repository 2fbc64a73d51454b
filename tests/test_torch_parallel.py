"""The port's data-parallel layer (``parallel/``, the DP steps, ``tiled_sr(mesh=)``, the trainers).

Multi-rank worlds run as gloo subprocesses (``tests/_torch_dist_worker.py``,
``file://`` rendezvous, two torch threads a rank, a timeout a world).

- ``DataIterator``: the port's rank-strided indices and batches per epoch
  are the JAX ``DataIterator``'s (shuffle, drop_last, 1, 2 and 3 processes),
  and the ranks' batches together are one process's global batches.
- ``prefetch_to_mesh`` in a world of one: order and transform, early break,
  exception relay, cleanup after an exception in the consumer's body
  (tests/test_parallel.py's checks of the JAX prefetcher).
- A 2-rank SwinIR DP step (micro 2 a rank x accum 2) against the JAX
  single-device ``make_swin_train_step`` on the concatenated batch, from
  bridged weights, augmentation off: losses to rtol 2e-4 (atol 2e-5, as
  tests/test_parallel.py holds the JAX DP step to one device) and the
  weights to tests/test_torch_train_step.py's bounds (every weight 2.1e-4,
  all but 2% of each tensor's entries 1e-6: AdamW's first step moves a
  weight whose gradient is near 0 by up to 2 lr either way).
- 2-rank hybrid DP steps, warm-up and GAN, augmentation and drop-path on,
  against the port's one-process step on the concatenated batch with the
  same generators: the ranks draw for the global batch, so the two runs
  differ only in summation order (losses and metric sums rtol 2e-4, the
  weights to the bounds above; D's conv9 bias, whose gradient is 0 but for
  rounding noise under RaGAN, to 2.1e-4 alone, as in
  tests/test_torch_hat_train.py).
- A NaN D loss on one rank's slice skips the window on both ranks: valid 0,
  G and D's weights unchanged.
- Every rank ends a step with bit-identical weights, (u, v) and EMA;
  ``replicate`` makes rank 0's weights, spectral (u, v) and AdamW states
  every rank's, in place.
- ``tiled_sr(mesh=)`` at 2 ranks equals ``tiled_sr`` within 1e-6, on a frame
  of many tiles and on one inside a tile.
- ``train --arch swin --device cpu`` at 2 ranks of batch 1: only rank 0
  writes, and its checkpoint matches one process at batch 2 (the
  rank-strided stream at one sample a rank is that process's order; the
  weights to the bounds above, the losses to rtol 2e-4).
- ``tools/dp_check.py`` under torchrun (env://, two gloo processes, tiny
  widths) passes its own checks.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import REPO, run_world
from superresolution_def_tpu.data.pipeline import DataIterator as JaxDataIterator
from superresolution_def_tpu.train import create_swin_train_state as jax_state
from superresolution_def_tpu.train import make_swin_train_step as jax_step
from superresolution_def_tpu.train.vgg import init_vgg_params
from superresolution_def_tpu_torch.cli.infer import tiled_sr
from superresolution_def_tpu_torch.data import DataIterator
from superresolution_def_tpu_torch.models import (
    SwinIR,
    discriminator_swin_state_dict_from_jax,
    swinir_state_dict_from_jax,
    vgg19_state_dict_from_jax,
)
from superresolution_def_tpu_torch.parallel import (
    make_mesh,
    prefetch_to_mesh,
    replicate,
    shard_batch,
    sync_metrics,
)
from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step
from test_torch_hat_train import _assert_weights as _assert_hat_weights
from test_torch_train_step import TINY, _assert_weights, _jax_criterion, _np_tree
from test_torch_trainers import _split

torch.set_num_threads(1)

HAT_TINY = dict(img_size=16, embed_dim=30, depths=(2,), num_heads=(6,), window_size=8,
                num_rrdb=1, num_feat=16, num_grow_ch=8)


def _batch(seed, accum, micro):
    rng = np.random.default_rng(seed)
    return {"lr": rng.integers(0, 65535, (accum, micro, 16, 16, 1), dtype=np.uint16),
            "hr": rng.integers(0, 65535, (accum, micro, 64, 64, 1), dtype=np.uint16)}


def _assert_same_on_every_rank(outs):
    for out in outs[1:]:
        for part in ("g", "d", "ema"):
            for k, v in outs[0][part].items():
                assert torch.equal(out[part][k], v), (part, k)


# --------------------------------------------------------------------------- #
# the data stream
# --------------------------------------------------------------------------- #
class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_data_iterator_indices_match_jax(shuffle, drop_last, count):
    ds = _Sized(23)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3, process_count=count)
    ranks = [DataIterator(ds, 4, process_index=r, **kw) for r in range(count)]
    for r, it in enumerate(ranks):
        want = JaxDataIterator(ds, 4, process_index=r, **kw)
        assert it.batches_per_epoch() == want.batches_per_epoch()
        for epoch in (0, 5):
            np.testing.assert_array_equal(it._indices(epoch), want._indices(epoch))
    # batch b of every rank together: the samples of one process's global batch b
    one = DataIterator(ds, 4 * count, shuffle=shuffle, drop_last=drop_last, seed=3)
    glob = one._indices(2).reshape(-1, 4 * count)
    local = [it._indices(2).reshape(-1, 4) for it in ranks]
    for b in range(len(glob)):
        assert sorted(glob[b]) == sorted(np.concatenate([lo[b] for lo in local]))


# --------------------------------------------------------------------------- #
# the prefetcher (tests/test_parallel.py's checks of the JAX one)
# --------------------------------------------------------------------------- #
def _host_batches(n, accum=2, b=8, size=8):
    for i in range(n):
        rng = np.random.default_rng(i)
        yield {"lr": rng.integers(0, 65535, (accum * b, size, size, 1), dtype=np.uint16),
               "hr": rng.integers(0, 65535, (accum * b, size * 4, size * 4, 1),
                                  dtype=np.uint16)}


def test_prefetch_full_drain_order_and_transform():
    mesh = make_mesh("cpu")
    seen = []
    tf = lambda bt: {k: v.reshape(2, 8, *v.shape[1:]) for k, v in bt.items()}  # noqa: E731
    with prefetch_to_mesh(_host_batches(5), mesh, transform=tf) as stream:
        for host, staged in stream:
            assert host["lr"].shape == (16, 8, 8, 1)  # the host batch passes untouched
            assert staged["lr"].shape == (2, 8, 8, 8, 1)  # transformed and uploaded
            assert isinstance(staged["lr"], torch.Tensor) and staged["lr"].dtype == torch.int16
            assert np.array_equal(staged["hr"].numpy().view(np.uint16),
                                  tf(host)["hr"])  # the uint16 bits, as int16
            seen.append(host["lr"][0, 0, 0, 0])
    for i, v in enumerate(seen):
        assert v == np.random.default_rng(i).integers(0, 65535, (16, 8, 8, 1),
                                                      dtype=np.uint16)[0, 0, 0, 0]
    assert len(seen) == 5


def test_prefetch_early_break_closes_worker_deterministically():
    produced = []

    def gen():
        for i, bt in enumerate(_host_batches(100)):
            produced.append(i)
            yield bt

    stream = prefetch_to_mesh(gen(), make_mesh("cpu"))
    for bi, _ in enumerate(stream):
        if bi >= 2:
            break
    stream.close()
    assert not stream._thread.is_alive()
    n_after_close = len(produced)
    assert n_after_close <= 6, produced  # consumed 3 + depth 2 + 1 in flight
    time.sleep(0.3)
    assert len(produced) == n_after_close
    assert list(stream) == []


def test_prefetch_relays_producer_exception():
    def gen():
        yield from _host_batches(2)
        raise OSError("corrupt TIFF mid-epoch")

    got = []
    with pytest.raises(OSError, match="corrupt TIFF"):
        with prefetch_to_mesh(gen(), make_mesh("cpu")) as stream:
            for host, _ in stream:
                got.append(host)
    assert len(got) == 2


def test_prefetch_exception_in_consumer_body_still_cleans_up():
    stream = prefetch_to_mesh(_host_batches(50), make_mesh("cpu"))
    with pytest.raises(ValueError):
        with stream:
            for _ in stream:
                raise ValueError("step blew up")
    assert not stream._thread.is_alive()


def test_world_of_one_is_a_passthrough():
    mesh = make_mesh("cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.device) == (None, 1, 0, torch.device("cpu"))
    assert sync_metrics({"psnr_sum": torch.tensor(4.0), "count": 2}, mesh) == {
        "psnr_sum": 4.0, "count": 2.0}
    net = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert replicate(net, mesh) is net
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    assert torch.equal(shard_batch({"x": x}, mesh)["x"], torch.from_numpy(x))


def test_replicate_broadcasts_rank_zeros_state(tmp_path):
    outs = run_world("replicate", 2, tmp_path, {})
    assert not torch.equal(outs[0]["before"]["lin.bias"], outs[1]["before"]["lin.bias"])
    for out in outs:
        assert all(out["moved"])  # copied in place: the versions moved
        # weights, biases and the spectral u, v: rank 0's
        for k, v in outs[0]["before"].items():
            assert torch.equal(out["state"][k], v), k
    for i, st in outs[0]["opt"].items():
        for k, v in st.items():
            assert torch.equal(outs[1]["opt"][i][k], v), (i, k)


# --------------------------------------------------------------------------- #
# the data-parallel steps
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def swin_start():
    """The JAX state and VGG params, and the port's state dicts bridged from them."""
    state, bundle = jax_state(jax.random.PRNGKey(0), **TINY, dtype=jax.numpy.float32)
    vgg_params = init_vgg_params(cutoff=35, seed=0)
    bridged = {
        "config": TINY,
        "g": swinir_state_dict_from_jax(_np_tree(state.g_params)),
        "ema": swinir_state_dict_from_jax(_np_tree(state.ema)),
        "d": discriminator_swin_state_dict_from_jax(_np_tree(state.d_params),
                                                    _np_tree(state.spectral)),
        "vgg": vgg19_state_dict_from_jax(_np_tree(vgg_params)),
    }
    return state, bundle, vgg_params, bridged


def test_swin_dp_step_matches_the_jax_step_on_the_whole_batch(tmp_path, swin_start):
    state, bundle, vgg_params, bridged = swin_start
    batch = _batch(0, 2, 4)
    step = jax_step(bundle, accum_steps=2, augment=False,
                    criterion_g=_jax_criterion(vgg_params), donate=False)
    new, m = step(state, batch, 1e-4, 1e-4)

    outs = run_world("swin_step", 2, tmp_path, {**bridged, "batch": batch})
    _assert_same_on_every_rank(outs)
    got = outs[0]
    assert got["metrics"]["valid_batches"] == float(m["valid_batches"]) == 2
    for k in ("loss_g", "loss_d"):
        np.testing.assert_allclose(got["metrics"][k], float(m[k]), rtol=2e-4, atol=2e-5)
    _assert_weights(got["d"], discriminator_swin_state_dict_from_jax(
        _np_tree(new.d_params), _np_tree(new.spectral)), "D")
    _assert_weights(got["g"], swinir_state_dict_from_jax(_np_tree(new.g_params)), "G")
    _assert_weights(got["ema"], swinir_state_dict_from_jax(_np_tree(new.ema)), "EMA")
    assert all(out["jax_loaded"] == [] for out in outs)


def test_nan_on_one_rank_skips_the_window_on_every_rank(tmp_path, swin_start):
    bridged = swin_start[3]
    outs = run_world("swin_step", 2, tmp_path, {**bridged, "batch": _batch(1, 2, 4),
                                                "nan_rank": 1})
    _assert_same_on_every_rank(outs)
    for out in outs:
        assert out["metrics"]["valid_batches"] == 0.0
        for k, v in bridged["g"].items():
            assert torch.equal(out["g"][k], v), k
        for k, v in bridged["d"].items():
            if k.endswith("weight_orig"):
                assert torch.equal(out["d"][k], v), k


@pytest.mark.parametrize("warmup", [True, False])
def test_hybrid_dp_step_matches_one_process_on_the_whole_batch(tmp_path, warmup):
    state = create_hat_train_state(torch.Generator().manual_seed(0), **HAT_TINY, device="cpu")
    start = {"config": HAT_TINY, "g": {k: v.clone() for k, v in state.g.state_dict().items()},
             "ema": {k: v.clone() for k, v in state.ema.state_dict().items()},
             "d": {k: v.clone() for k, v in state.d.state_dict().items()}}
    batch = _batch(2, 2, 4)
    step = make_hat_train_step(state, accum_steps=2, generator=torch.Generator().manual_seed(1),
                               drop_generator=torch.Generator().manual_seed(2))
    want = step(batch, 1e-4, 1e-4, warmup=warmup)

    outs = run_world("hat_step", 2, tmp_path, {**start, "batch": batch, "warmup": warmup})
    _assert_same_on_every_rank(outs)
    got = outs[0]
    for k, v in want.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=2e-4, atol=2e-5, err_msg=k)
    assert got["metrics"]["count"] == 8.0
    for part, module in (("g", state.g), ("d", state.d), ("ema", state.ema)):
        # RaGAN sees only differences of D's logits: conv9's bias has no gradient
        _assert_hat_weights(got[part], module.state_dict(), part, noise_only=("conv9.bias",))


# --------------------------------------------------------------------------- #
# tiled inference and the trainer
# --------------------------------------------------------------------------- #
def test_tiled_sr_over_two_ranks_equals_one_process(tmp_path):
    config = dict(img_size=32, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                  mlp_ratio=2.0, upscale=4)
    model = SwinIR(**config, generator=torch.Generator().manual_seed(7)).eval()
    rng = np.random.default_rng(8)
    # many tiles, and a frame inside one tile (run whole on every rank)
    imgs = [rng.random((40, 70), np.float32), rng.random((20, 30), np.float32)]
    wants = [tiled_sr(model, img, tile=32, overlap=4, batch_tiles=3, device="cpu")
             for img in imgs]
    outs = run_world("tiled", 2, tmp_path, {"config": config, "state_dict": model.state_dict(),
                                            "imgs": imgs, "tile": 32, "overlap": 4})
    for out in outs:
        for got, want in zip(out["outs"], wants, strict=True):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_train_cli_two_ranks_match_one_process_at_twice_the_batch(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    for name, count in (("train", 2), ("val", 2)):  # one step; every val pair once
        _split(data, name, count, rng)
    argv = ["--arch", "swin", "--target", "T1", "--data-root", str(data), "--epochs", "1",
            "--img-size", "16", "--embed-dim", "16", "--depths", "2", "--num-heads", "2"]
    two = run_world("train", 2, tmp_path / "two", {"argv": [
        *argv, "--batch-size", "1", "--outputs-root", str(tmp_path / "two" / "out")]})
    one = run_world("train", 1, tmp_path / "one", {"argv": [
        *argv, "--batch-size", "2", "--outputs-root", str(tmp_path / "one" / "out")]})
    assert two[1]["wrote"] == []
    run = tmp_path / "two" / "out" / "T1_DDP_SwinIR"
    assert sorted(two[0]["wrote"]) == sorted([
        str(run / "metrics.csv"), str(run / "tensorboard"),
        str(run / "checkpoints" / "best_gan_model.pth"),
        str(run / "checkpoints" / "latest_checkpoint.pth"), str(run / "images" / "epoch_001.png")])
    for k in ("loss_g", "loss_d", "psnr", "ssim"):
        np.testing.assert_allclose(two[0]["last"][k], one[0]["last"][k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
        assert two[1]["last"][k] == two[0]["last"][k]
    got = torch.load(run / "checkpoints" / "latest_checkpoint.pth", weights_only=False)
    want = torch.load(tmp_path / "one" / "out" / "T1_DDP_SwinIR" / "checkpoints"
                      / "latest_checkpoint.pth", weights_only=False)
    for part in ("net_g", "net_d", "ema"):
        _assert_weights(got[part], want[part], part)


def test_dp_check_tool_runs_under_torchrun(tmp_path):
    """tools/dp_check.py in two gloo processes started by torchrun (env://):
    its checks pass at tiny widths."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "superresolution_def_tpu_torch.tools.dp_check", "--device", "cpu", "--small",
         "--steps", "1"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["ranks"] == 2 and out["dp_ranks"]["ranks_bit_identical"]
