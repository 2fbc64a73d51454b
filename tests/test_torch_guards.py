"""Guards on the port's boundaries, each in a fresh interpreter.

- The port never loads jax nor any module of the JAX package: the conftest
  of this suite imports jax, so the check runs the CPU slices (``train``,
  then ``infer`` of what it trained and of a saved model, and a SwinIR
  forward with ``attn_impl="pallas"``; ``infer --arch hat`` of a saved
  hybrid, plain and fused; the hybrid's forward with ``attn_impl="pallas"``
  and through ``make_fused_hybrid(trunk_impl="kernel")``; ``train --arch
  hat``, plain, with the fused trunk's ``autograd.Function`` and with the
  fused HAB and OCAB training nodes (``fused_hab``), then ``infer --arch
  hat`` of what it trained) in a subprocess and inspects its
  ``sys.modules``.
- ``train`` and ``infer`` run on the card unless ``--device cpu`` is given:
  without a card and without it they raise.
- ``chip_smoke.py`` has no CPU fallback: without a GPU, or without the rest
  of the repository beside it, it fails and prints no result line.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

SLICE = textwrap.dedent(
    """
    import pkgutil, importlib, sys, tempfile
    from pathlib import Path
    import numpy as np, torch
    import superresolution_def_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)
    from superresolution_def_tpu_torch.cli.main import main
    from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
    from superresolution_def_tpu_torch.models import SwinIR

    root = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    entries = []
    for i in range(2):
        hr = rng.random((64, 64))
        d = root / "data" / "T1" / f"p{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    splits = root / "data" / "T1" / "8_dataset_split" / "splits_json"
    for split in ("train", "val", "test"):
        write_manifest(splits / f"{split}.json", entries)
    main(["train", "--target", "T1", "--data-root", str(root / "data"),
          "--outputs-root", str(root / "trained"), "--device", "cpu", "--epochs", "1",
          "--batch-size", "2", "--img-size", "16", "--embed-dim", "16", "--depths", "2",
          "--num-heads", "2"])
    run = root / "outputs" / "T1_DDP_SwinIR"
    run.mkdir(parents=True)
    model = SwinIR(img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                   mlp_ratio=2.0, upscale=4, generator=torch.Generator().manual_seed(0))
    torch.save({"net_g": model.state_dict()}, run / "best_gan_model.pth")
    for folder in (run, root / "trained" / "T1_DDP_SwinIR"):
        for impl in ([], ["--impl", "fused"]):
            res = main(["infer", "--folder", str(folder), "--data-root", str(root / "data"),
                        "--lr-size", "16", "--hr-size", "64", "--device", "cpu", *impl])
            assert res["num_images"] == 2, res
    with torch.no_grad():
        SwinIR(img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
               mlp_ratio=2.0, upscale=4, attn_impl="pallas")(torch.rand(1, 16, 24, 1))
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "orbax",
                                "superresolution_def_tpu")))
    """
)


HAT_SLICE = textwrap.dedent(
    """
    import sys, tempfile
    from pathlib import Path
    import numpy as np, torch
    from superresolution_def_tpu_torch.cli.main import main
    from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16
    from superresolution_def_tpu_torch.models import HybridHATRealESRGAN

    root = Path(tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    entries = []
    for i in range(2):
        hr = rng.random((64, 64))
        d = root / "data" / "T1" / f"p{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", hr.reshape(16, 4, 16, 4).mean(axis=(1, 3)))
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "data" / "T1" / "8_dataset_split" / "splits_json" / "test.json",
                   entries)
    run = root / "outputs" / "T1_DDP_SwinIR"
    run.mkdir(parents=True)
    model = HybridHATRealESRGAN(img_size=16, embed_dim=30, depths=(6,), num_heads=(6,),
                                num_rrdb=1, num_feat=16, num_grow_ch=8)
    torch.save({"model_state_dict": model.state_dict()}, run / "best_hybrid_model.pth")
    for impl in ([], ["--impl", "fused"]):
        res = main(["infer", "--arch", "hat", "--folder", str(run), "--data-root",
                    str(root / "data"), "--lr-size", "16", "--hr-size", "64", "--device", "cpu",
                    *impl])
        assert res["num_images"] == 2, res
        assert (run / "test_results" / "test_metrics.csv").exists()
    from superresolution_def_tpu_torch.kernels import make_fused_hybrid
    xs = torch.rand(1, 16, 24, 1)  # wider than a window: the shifted HABs take the mask
    with torch.no_grad():
        HybridHATRealESRGAN(img_size=16, embed_dim=30, depths=(2,), num_heads=(6,), num_rrdb=1,
                            num_feat=16, num_grow_ch=8, attn_impl="pallas")(xs)
    make_fused_hybrid(model, dtype=torch.float32, trunk_impl="kernel")(xs)
    write_manifest(root / "data" / "T1" / "8_dataset_split" / "splits_json" / "train.json",
                   entries)
    main(["train", "--arch", "hat", "--target", "T1", "--data-root", str(root / "data"),
          "--outputs-root", str(root / "trained"), "--device", "cpu", "--epochs", "1",
          "--warmup-epochs", "0", "--batch-size", "2", "--accum-steps", "1", "--img-size", "16",
          "--embed-dim", "30", "--depths", "6", "--num-rrdb", "1", "--num-feat", "16",
          "--num-grow-ch", "8", "--ckpt-interval", "1"])
    res = main(["infer", "--arch", "hat", "--folder", str(root / "trained" / "T1"),
                "--data-root", str(root / "data"), "--lr-size", "16", "--hr-size", "64",
                "--device", "cpu"])
    assert res["num_images"] == 2, res
    from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step
    batch = {"lr": rng.integers(0, 65535, (1, 2, 16, 16, 1), dtype=np.uint16),
             "hr": rng.integers(0, 65535, (1, 2, 64, 64, 1), dtype=np.uint16)}
    for fused_hab in (False, True):
        state = create_hat_train_state(torch.Generator().manual_seed(0), img_size=16,
                                       embed_dim=30, depths=(2,), num_heads=(6,), num_rrdb=1,
                                       num_feat=16, num_grow_ch=8, fused=True,
                                       fused_hab=fused_hab, device="cpu")
        make_hat_train_step(state, accum_steps=1)(batch, 1e-4, 1e-4)
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "orbax",
                                "superresolution_def_tpu")))
    """
)


def _run_slice(tmp_path, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as the suite's workers run
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_port_cpu_slice_never_loads_jax(tmp_path):
    assert _run_slice(tmp_path, SLICE) == "JAX_LOADED []"


def test_port_hat_cpu_slice_never_loads_jax(tmp_path):
    assert _run_slice(tmp_path, HAT_SLICE) == "JAX_LOADED []"


@pytest.mark.parametrize("cmd", ["train", "infer", "infer-hat", "train-hat",
                                 "train-hat-fused-hab"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from superresolution_def_tpu_torch.cli.main import main

    args = {"train": ["train", "--target", "T1", "--data-root", str(tmp_path)],
            "infer": ["infer", "--folder", str(tmp_path), "--data-root", str(tmp_path)],
            "infer-hat": ["infer", "--arch", "hat", "--impl", "fused", "--folder", str(tmp_path),
                          "--data-root", str(tmp_path)],
            "train-hat": ["train", "--arch", "hat", "--bf16", "--target", "T1", "--data-root",
                          str(tmp_path)],
            "train-hat-fused-hab": ["train", "--arch", "hat", "--bf16", "--fused-hab",
                                    "--target", "T1", "--data-root", str(tmp_path)]}[cmd]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = {}
        assert last.get("ok") is not True
