#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line, any failure ending the run with a non-zero
exit code:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA kernel of the SwinIR x4 inference path, with time;
3. K1 (``fused_swin_block``) against its plain PyTorch version at the
   flagship shapes (Bw=768, C=180, 6 heads, hidden 720, bf16), with times;
4. the slice: a synthetic 128->512 test split and a seeded flagship SwinIR
   checkpoint through ``cli.main infer --arch swin --impl fused``, counting
   the kernel's launches (36 per image);
5. the fused bf16 forward against the fp32 ``nn.Module`` forward on one patch;
6. patches/s of the fused forward and of the bf16 ``nn.Module`` forward.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it fails at once:
the port has no CPU path here.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# flagship SwinIR x4 (BASELINE config #1)
FLAGSHIP = dict(img_size=128, in_chans=1, embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                window_size=8, mlp_ratio=4.0, upscale=4)
K1_TOL = 3e-2        # max |kernel - plain| <= K1_TOL * max(1, max |plain|): bf16 io
FORWARD_REL_L2 = 2e-2  # fused bf16 forward vs fp32 module, relative L2
N_IMAGES = 4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 5) -> float:
    """Device milliseconds per call of ``fn``, by CUDA events: the median of
    ``reps`` timings, each over ``calls`` back-to-back calls. One untimed call
    ahead of each timing keeps the device busy while the timed ones are
    queued, so the host's launch overhead stays out of the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def k1_inputs(gen: torch.Generator, device, bw=768, c=180, heads=6, hidden=720):
    """Seeded operands of one flagship Swin block, weights (in, out) bf16."""
    def uniform(*shape, fan_in):
        return (torch.rand(*shape, generator=gen) * 2 - 1) / fan_in**0.5

    def vec(n, base):
        return base + 0.1 * torch.randn(n, generator=gen)

    bf = torch.bfloat16
    args = (
        torch.randn(bw, 64, c, generator=gen).to(bf),
        vec(c, 1.0), vec(c, 0.0),
        uniform(c, 3 * c, fan_in=c).to(bf), uniform(3 * c, fan_in=c),
        0.5 * torch.randn(heads, 64, 64, generator=gen),
        uniform(c, c, fan_in=c).to(bf), uniform(c, fan_in=c),
        vec(c, 1.0), vec(c, 0.0),
        uniform(c, hidden, fan_in=c).to(bf), uniform(hidden, fan_in=c),
        uniform(hidden, c, fan_in=hidden).to(bf), uniform(c, fan_in=hidden),
    )
    return [a.to(device) for a in args]


def write_split(root: Path, gen: np.random.Generator) -> None:
    """N_IMAGES smooth 512x512 HR patches and their 4x box-downsampled LR."""
    from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16

    entries = []
    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    for i in range(N_IMAGES):
        fx, fy, ph = gen.uniform(1, 6, size=3)
        hr = 0.5 + 0.25 * np.sin(2 * np.pi * (fx * xx + ph)) * np.cos(2 * np.pi * fy * yy)
        hr = np.clip(hr + 0.02 * gen.standard_normal((512, 512)), 0.0, 1.0)
        lr = hr.reshape(128, 4, 128, 4).mean(axis=(1, 3))
        d = root / "T1" / "pairs" / f"p{i}"
        write_tiff_u16(d / "hr.tiff", hr)
        write_tiff_u16(d / "lr.tiff", lr)
        entries.append(ManifestEntry(f"p{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
    write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / "test.json", entries)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.data import read_tiff_u16
    from superresolution_def_tpu_torch.kernels import _build, swin_block
    from superresolution_def_tpu_torch.kernels import fused_swin_block, make_fused_swinir
    from superresolution_def_tpu_torch.models import SwinIR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    card = f"{kind} ({smi.splitlines()[0].split(',')[-1].strip()} limit)"

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build("swin_block")
    swin_block._kernel_library()
    log("build", f"swin_block.cu -> {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("swin_block").splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    # 3. K1 against its plain version at the flagship shapes
    gen = torch.Generator().manual_seed(seed)
    args = k1_inputs(gen, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    got = fused_swin_block(*args, **kw)
    torch.cuda.synchronize()
    want = swin_block.swin_block_reference(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    bound = K1_TOL * max(1.0, want.float().abs().max().item())
    k1_ms = cuda_ms(lambda: fused_swin_block(*args, **kw))
    plain_ms = cuda_ms(lambda: swin_block.swin_block_reference(*args, **kw))
    log("k1", f"Bw=768 C=180 heads=6 hidden=720 bf16: max|kernel-plain|={err:.3e} "
              f"(bound {bound:.3e}); kernel {k1_ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")
    if not err <= bound:
        raise SystemExit(f"K1 disagrees with its plain version: {err} > {bound}")

    # 4. the slice through the CLI
    model = SwinIR(**FLAGSHIP, generator=torch.Generator().manual_seed(seed))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed))
        run = root / "outputs" / "T1_DDP_SwinIR"
        run.mkdir(parents=True)
        torch.save({"net_g": model.state_dict()}, run / "best_gan_model.pth")
        fused_swin_block.launches = 0
        t0 = time.perf_counter()
        result = cli_main(["infer", "--arch", "swin", "--impl", "fused", "--folder", str(run),
                           "--data-root", str(root / "data")])
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t0
        launches = fused_swin_block.launches
        out = run / "test_results"
        missing = [f"test_{i:04d}_{s}" for i in range(N_IMAGES) for s in ("sr.tiff", "tris.png")
                   if not (out / f"test_{i:04d}_{s}").exists()]
        log("slice", f"infer --impl fused: {result['num_images']} images, "
                     f"PSNR={result['psnr']:.4f} dB SSIM={result['ssim']:.6f}, "
                     f"{launches} K1 launches, {infer_s:.2f} s wall")
        if missing or result["num_images"] != N_IMAGES:
            raise SystemExit(f"infer artifacts missing: {missing}")
        if not (np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])):
            raise SystemExit("infer metrics are not finite")
        if launches != 36 * N_IMAGES:
            raise SystemExit(f"expected {36 * N_IMAGES} K1 launches, counted {launches}")
        lr = read_tiff_u16(root / "data" / "T1" / "pairs" / "p0" / "lr.tiff")

    # 5. fused bf16 forward against the fp32 module on one patch
    model = model.to(device).eval()
    fused = make_fused_swinir(model)
    x = torch.from_numpy(lr.astype(np.float32) / 65535.0)[None, :, :, None].to(device)
    with torch.no_grad():
        ref = model(x)
        got = fused(x).float()
    if got.shape != (1, 512, 512, 1) or not torch.isfinite(got).all():
        raise SystemExit(f"fused forward gave {tuple(got.shape)} or non-finite values")
    diff = got - ref
    rel = (diff.norm() / ref.norm()).item()
    log("forward", f"fused bf16 vs module fp32, 128->512: rel L2 {rel:.3e} "
                   f"(bound {FORWARD_REL_L2}), max abs {diff.abs().max().item():.3e}, "
                   f"mean abs {diff.abs().mean().item():.3e}")
    if not rel <= FORWARD_REL_L2:
        raise SystemExit(f"fused forward disagrees with the module: rel L2 {rel}")

    # 6. throughput at batch 3
    x3 = x.repeat(3, 1, 1, 1)
    fused_ms = cuda_ms(lambda: fused(x3), reps=10, warmup=2, calls=2)
    model_bf16 = SwinIR(**FLAGSHIP).to(device, torch.bfloat16).eval()
    model_bf16.load_state_dict(model.state_dict())
    with torch.no_grad():
        module_ms = cuda_ms(lambda: model_bf16(x3.to(torch.bfloat16)), reps=10, warmup=2,
                            calls=2)
    log("throughput", f"batch 3, 128->512 on {card}: fused {3e3 / fused_ms:.2f} patches/s "
                      f"({fused_ms:.3f} ms), nn.Module bf16 {3e3 / module_ms:.2f} patches/s "
                      f"({module_ms:.3f} ms)")

    print(json.dumps({"kernels": [{
        "name": "fused_swin_block",
        "route": "cuda",
        "source": "superresolution_def_tpu_torch/csrc/swin_block.cu",
        "replaces": "superresolution_def_tpu/kernels/swin_block.py:1220",
        "launches": launches,
        "max_abs_err": err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
