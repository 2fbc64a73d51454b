"""Guards on the port's boundaries, each in a fresh interpreter.

- The port never loads jax nor any module of the JAX package: the conftest
  of this suite imports jax, so the check runs the CPU slices (``train``,
  then ``infer`` of what it trained and of a saved model, a SwinIR
  forward with ``attn_impl="pallas"``, a step through the recompute
  backward (``make_fused_swinir(backward="recompute")``, K1 and K4b's plain
  versions) and the stage-ablation tool (``tools/swin_stage_ablation.py``,
  K13's plain versions); ``infer --arch hat`` of a saved
  hybrid, plain and fused; the hybrid's forward with ``attn_impl="pallas"``
  and through ``make_fused_hybrid(trunk_impl="kernel")``; ``train --arch
  hat``, plain, with the fused trunk's ``autograd.Function`` and with the
  fused HAB and OCAB training nodes (``fused_hab``), then ``infer --arch
  hat`` of what it trained; ``prep --fused`` of a target with solved
  headers, ``split`` and ``upscale`` of a FITS frame, plain, ``--mesh`` and
  ``--spatial``; the synthetic skies and the native TIFF codec, a
  ``SRVGGNetCompact`` forward, ``cli/port_vgg.py`` and ``train
  --vgg-weights`` of a torchvision-layout ``.pth``, and
  ``tools/train_learns.py`` at tiny widths) in a subprocess and inspects
  its ``sys.modules``; the
  worker script of the multi-rank tests (tests/_torch_dist_worker.py)
  reports the same of itself. Importing every module of the port loads
  no matplotlib.
- The port never touches the repository's ``native/`` (the JAX package's
  codec and its library): an audit hook in the same subprocesses records
  every path opened, listed, loaded or passed to a subprocess, and none
  lies under it. The port builds its own copy of the codec.
- ``train``, ``infer``, ``prep``, ``upscale`` (``--mesh`` and ``--spatial``
  too) and the stage-ablation tool run on the card unless ``--device cpu``
  is given: without a card and without it they raise.
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

# run first in each slice: records every path under the repo's native/ that
# the process opens, lists, loads or hands to a subprocess
NATIVE_AUDIT = textwrap.dedent(
    """
    import os, sys
    _NATIVE = os.path.join(os.environ["SR_REPO"], "native")
    NATIVE_HITS = []

    def _audit(event, args):
        if event in ("open", "os.listdir", "os.scandir", "ctypes.dlopen", "subprocess.Popen"):
            for a in args if event == "subprocess.Popen" else args[:1]:
                for s in (a if isinstance(a, (list, tuple)) else [a]):
                    if isinstance(s, (str, bytes, os.PathLike)):
                        p = os.path.abspath(os.fsdecode(s))
                        if p == _NATIVE or p.startswith(_NATIVE + os.sep):
                            NATIVE_HITS.append(p)

    sys.addaudithook(_audit)
    """
)

SLICE = NATIVE_AUDIT + textwrap.dedent(
    """
    import pkgutil, importlib, sys, tempfile
    from pathlib import Path
    import numpy as np, torch
    import superresolution_def_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)
    assert "matplotlib" not in sys.modules  # step 2 and the debug cards import it to draw
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
    from superresolution_def_tpu_torch.kernels import make_fused_swinir
    from superresolution_def_tpu_torch.tools import swin_stage_ablation as ablation
    make_fused_swinir(model, dtype=torch.float32, differentiable=True,
                      backward="recompute")(torch.rand(1, 16, 16, 1)).sum().backward()
    ablation.WINDOWS, ablation.BLOCKS = 2, 1
    ablation.main(["full", "allheads", "mlp_polygelu", "--device", "cpu"])
    # prep --fused of a target with solved headers (4 pairs at hr 512, stride
    # 40), split, then upscale of a FITS frame with the saved SwinIR
    from superresolution_def_tpu_torch.prep import TanWCS, reproject_bilinear, write_fits
    sky = (rng.random((552, 552)) * 0.6 + 0.2).astype(np.float32)
    w_h = TanWCS((10.0, 20.0), (276.0, 276.0), cdelt=[-2e-4, 2e-4])
    w_o = TanWCS((10.0, 20.0), (69.0, 69.0), cdelt=[-8e-4, 8e-4])
    orig = root / "prep" / "SYN" / "1_originarie"
    write_fits(orig / "img_lights" / "hst.fits", sky, w_h.to_header())
    write_fits(orig / "local_raw" / "obs.fits",
               reproject_bilinear(sky, w_h, w_o, (138, 138), fill_nan=False, device="cpu"),
               w_o.to_header())
    main(["prep", "--data-root", str(root / "prep"), "--steps", "1,3,4", "--fused",
          "--device", "cpu"])
    counts = main(["split", "--data-root", str(root / "prep")])
    assert counts == {"SYN": {"train": 3, "val": 0, "test": 1}}, counts
    write_fits(root / "frame.fits", sky[:40, :56], w_h.to_header())
    res = main(["upscale", str(root / "frame.fits"), "--folder", str(run), "--tile", "32",
                "--overlap", "4", "--device", "cpu"])
    assert res["shape"] == (160, 224), res
    for spread in ("--mesh", "--spatial"):  # the parallel layer, in a world of one
        res = main(["upscale", str(root / "frame.fits"), "--folder", str(run), "--tile", "32",
                    "--overlap", "4", "--device", "cpu", spread, "--out", str(root / "m.tiff")])
        assert res["shape"] == (160, 224), res
    # the modules ported last: synth and the native codec, SRVGGNetCompact,
    # port_vgg and a torchvision-layout .pth for --vgg-weights, the
    # convergence tool at tiny widths
    from superresolution_def_tpu_torch.cli import port_vgg
    from superresolution_def_tpu_torch.data import PatchDataset, fast_tiff, synth_batch_u16
    from superresolution_def_tpu_torch.models import SRVGGNetCompact
    from superresolution_def_tpu_torch.tools import train_learns
    from superresolution_def_tpu_torch.train import init_vgg_params
    sky = synth_batch_u16(2, 64, seed=0)["hr"][..., 0]
    fast_tiff.write_u16_native(root / "s.tiff", sky[0])
    assert (fast_tiff.read_batch_u16([root / "s.tiff"], 64, 64)[0][0] == sky[0]).all()
    assert PatchDataset(entries, 16, 64).read_batch([0, 1])["hr"].shape == (2, 64, 64, 1)
    with torch.no_grad():
        SRVGGNetCompact(1, 1, 8, 2)(torch.rand(1, 8, 8, 1))
    torch.save(init_vgg_params(seed=1), root / "vgg19.pth")
    port_vgg.convert(str(root / "vgg19.pth"), str(root / "vgg19.npz"))
    main(["train", "--target", "T1", "--data-root", str(root / "data"),
          "--outputs-root", str(root / "vgg"), "--device", "cpu", "--epochs", "1",
          "--batch-size", "2", "--img-size", "16", "--embed-dim", "16", "--depths", "2",
          "--num-heads", "2", "--vgg-weights", str(root / "vgg19.pth")])
    res = train_learns.main(["--arch", "swin", "--epochs", "1", "--tiny", "--device", "cpu",
                             "--no-bf16", "--hr-size", "64", "--pairs", "12",
                             "--data-root", str(root / "learn"),
                             "--outputs-root", str(root / "learn_out"),
                             "--out", str(root / "learn_res")])
    assert (root / "learn_res" / "metrics.csv").exists() and res["epoch"] == 1.0, res
    print("NATIVE_OPENED", NATIVE_HITS)
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "orbax",
                                "superresolution_def_tpu")))
    """
)


HAT_SLICE = NATIVE_AUDIT + textwrap.dedent(
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
    print("NATIVE_OPENED", NATIVE_HITS)
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "orbax",
                                "superresolution_def_tpu")))
    """
)


def _run_slice(tmp_path, script):
    """The slice's last two lines: the paths it touched under native/, and
    the JAX modules it loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["SR_REPO"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as the suite's workers run
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-2:]


def test_port_cpu_slice_never_loads_jax(tmp_path):
    assert _run_slice(tmp_path, SLICE) == ["NATIVE_OPENED []", "JAX_LOADED []"]


def test_port_hat_cpu_slice_never_loads_jax(tmp_path):
    assert _run_slice(tmp_path, HAT_SLICE) == ["NATIVE_OPENED []", "JAX_LOADED []"]


def test_native_audit_sees_the_repo_native_dir(tmp_path):
    """The audit hook of the slices catches an open, a listing and a load
    under the repo's ``native/``, and nothing under the port's own copy."""
    script = NATIVE_AUDIT + textwrap.dedent(
        """
        import ctypes
        from superresolution_def_tpu_torch.data import fast_tiff
        open(os.path.join(_NATIVE, "tifffast.cpp")).close()
        os.listdir(_NATIVE)
        try:
            ctypes.CDLL(os.path.join(_NATIVE, "no_such_lib.so"))
        except OSError:
            pass
        fast_tiff.native_available()
        open(fast_tiff.SOURCE).close()
        print("NATIVE_OPENED", [os.path.relpath(p, os.environ["SR_REPO"]) for p in NATIVE_HITS])
        print("done")
        """)
    assert _run_slice(tmp_path, script) == [
        "NATIVE_OPENED ['native/tifffast.cpp', 'native', 'native/no_such_lib.so']", "done"]


def test_dist_worker_never_loads_jax(tmp_path):
    from _torch_dist_worker import run_world

    from superresolution_def_tpu_torch.models import SwinIR

    config = dict(img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                  mlp_ratio=2.0, upscale=4)
    (out,) = run_world("tiled", 1, tmp_path, {
        "config": config, "state_dict": SwinIR(**config).state_dict(),
        "imgs": [torch.rand(20, 24).numpy()], "tile": 16, "overlap": 2})
    assert out["outs"][0].shape == (80, 96, 1)
    assert out["jax_loaded"] == []


@pytest.mark.parametrize("cmd", ["train", "infer", "infer-hat", "train-hat",
                                 "train-hat-fused-hab", "stage-ablation", "prep", "upscale",
                                 "upscale-mesh", "upscale-spatial"])
def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from superresolution_def_tpu_torch.cli.main import main

    if cmd == "stage-ablation":
        from superresolution_def_tpu_torch.tools.swin_stage_ablation import main as ablation

        with pytest.raises(RuntimeError, match="--device cpu"):
            ablation(["full"])
        return

    args = {"train": ["train", "--target", "T1", "--data-root", str(tmp_path)],
            "infer": ["infer", "--folder", str(tmp_path), "--data-root", str(tmp_path)],
            "infer-hat": ["infer", "--arch", "hat", "--impl", "fused", "--folder", str(tmp_path),
                          "--data-root", str(tmp_path)],
            "train-hat": ["train", "--arch", "hat", "--bf16", "--target", "T1", "--data-root",
                          str(tmp_path)],
            "train-hat-fused-hab": ["train", "--arch", "hat", "--bf16", "--fused-hab",
                                    "--target", "T1", "--data-root", str(tmp_path)],
            "prep": ["prep", "--fused", "--data-root", str(tmp_path)],
            "upscale": ["upscale", str(tmp_path / "frame.fits"), "--folder", str(tmp_path)],
            "upscale-mesh": ["upscale", str(tmp_path / "frame.fits"), "--folder", str(tmp_path),
                             "--mesh"],
            "upscale-spatial": ["upscale", str(tmp_path / "frame.fits"), "--folder",
                                str(tmp_path), "--spatial"]}[cmd]
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
