"""Guards on the port's boundaries, each in a fresh interpreter.

- The port never loads jax: the conftest of this suite imports it, so the
  check runs the CPU slice in a subprocess and inspects its ``sys.modules``.
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
    write_manifest(root / "data" / "T1" / "8_dataset_split" / "splits_json" / "test.json", entries)
    run = root / "outputs" / "T1_DDP_SwinIR"
    run.mkdir(parents=True)
    model = SwinIR(img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                   mlp_ratio=2.0, upscale=4, generator=torch.Generator().manual_seed(0))
    torch.save({"net_g": model.state_dict()}, run / "best_gan_model.pth")
    for impl in ([], ["--impl", "fused"]):
        res = main(["infer", "--folder", str(run), "--data-root", str(root / "data"),
                    "--lr-size", "16", "--hr-size", "64", *impl])
        assert res["num_images"] == 2, res
    print("JAX_LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                               ("jax", "jaxlib", "flax", "optax", "orbax")))
    """
)


def test_port_cpu_slice_never_loads_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", SLICE], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "JAX_LOADED []"


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
