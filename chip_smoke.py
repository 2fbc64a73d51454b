#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line, any failure ending the run with a non-zero
exit code:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA source (both at once, one nvcc each), with time;
3. K1 (``fused_swin_block``) against its plain PyTorch version at the
   flagship shapes (Bw=768, C=180, 6 heads, hidden 720, bf16), with times;
4. the inference slice: a synthetic 128->512 test split and a seeded flagship
   SwinIR checkpoint through ``cli.main infer --arch swin --impl fused``,
   counting K1's launches (36 per image);
5. the fused bf16 forward against the fp32 ``nn.Module`` forward on one patch;
6. patches/s of the fused forward and of the bf16 ``nn.Module`` forward;
7. the training kernels' build (``swin_block_train.cu``): ptxas registers
   and spills;
8. K2/K3/K4 against their plain versions at the flagship train shapes
   (Bw=2048: micro 8 of 128x128, bf16), K2's ``out`` bit-identical to K1's,
   with times;
9. the differentiable fused SwinIR (K2 forward, K3 + K4 backward) against
   autograd of the fp32 ``nn.Module`` on one patch;
10. the training slice: ``cli.main train --arch swin --bf16`` for 2 epochs of
    2 steps (micro 8) on a synthetic 16/4 train/val split, counting K2/K3/K4
    launches (36 each per step), then ``infer --impl fused`` of its EMA
    checkpoint;
11. train patches/s of the fused bf16 step and of the same step with the
    bf16 ``nn.Module`` generator, their peak memory, and the fused step's
    ``torch.profiler`` top device ops and idle share;
12. the HAT-hybrid kernels against their plain versions at the served
    config's shapes (BASELINE config #2, batch 8 of 128x128): K5
    (``fused_hab_block``, Bw=2048, C=90, 6 heads, hidden 360) unshifted and
    shifted, K6 (``fused_ocab_block``, 64 queries against 144 overlap keys)
    and K7 (``fused_rdb_cm``, B=8, F=48 at 256x256, G=24), with times;
13. the hybrid slice: a seeded config-#2 ``best_hybrid_model.pth`` through
    ``cli.main infer --arch hat --impl fused`` on the synthetic test split,
    counting K5/K6/K7 launches (24, 4 and 36 per image) and checking every
    artifact, ``test_metrics.csv`` included;
14. the fused bf16 hybrid against the fp32 ``nn.Module`` on one patch,
    beside the bf16 ``nn.Module``'s own distance;
15. patches/s at batch 8 of the fused hybrid and of the bf16 ``nn.Module``,
    and the fused forward's ``torch.profiler`` top device ops and idle share;
16. K8 (``fused_rdb_cm_bwd``, the dense-block backward) against its plain
    version at the hybrid train step's shapes (B=2, F=48, G=24, 256x256,
    bf16, dy ~ N(0, 1e-2)), run twice to show the same bits, with K7's
    stashing forward at B=2, with times;
17. gradients of the fused bf16 RRDB trunk (K7 forward, K8 backward) and of
    the whole fused hybrid generator against fp32 autograd of the
    ``nn.Module``, beside the bf16 ``nn.Module``'s own distance;
18. the hybrid training slice: ``cli.main train --arch hat --bf16`` for 2
    epochs (one L1-only warmup, one GAN) of 2 steps of micro 2 x accum 8 on
    a synthetic 32-pair split, counting K7/K8 launches (288 each per step),
    checking ``train_log.csv`` and the checkpoints, then ``infer --arch hat
    --impl fused`` of the trained run;
19. patches/s and peak memory of the hybrid GAN step, fused against the
    bf16 ``nn.Module`` generator, at micro 2 x accum 8 and micro 8 x accum 2;
20. the fused hybrid step's ``torch.profiler`` breakdown (K7, K8, AdamW and
    EMA, the rest) and idle share, with the HAT backbone, D and VGG timed
    alone at the step's shapes.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it fails at once:
the port has no CPU path here.
"""

from __future__ import annotations

import argparse
import copy
import importlib
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
# K3/K4 vs plain, relative L2 per output: bf16 operands (2**-9 relative
# rounding; an intermediate on the other side of a rounding step moves
# what is computed from it) and fp32 sums over 131,072 rows in another order
BWD_REL_L2 = 2e-2
# fused bf16 gradients vs fp32 autograd: no worse than 2x the bf16
# nn.Module's own distance from fp32, or this
GRAD_REL_L2 = 2e-2
N_IMAGES = 4
TRAIN_PAIRS, VAL_PAIRS = 16, 4
MICRO = 8
# H100 SXM dense peaks (NVIDIA data sheet): the least-time bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SWIN = "superresolution_def_tpu/kernels/swin_block.py"
# HybridHATRealESRGAN x4 (BASELINE config #2), served at batch 8
HYBRID = dict(img_size=128, in_chans=1, embed_dim=90, depths=(6,) * 4, num_heads=(6,) * 4,
              window_size=8, num_rrdb=12, num_feat=48, num_grow_ch=24)
HYBRID_BATCH = 8
# the hybrid GAN step (BASELINE config #4): the JAX trainer's split
HAT_MICRO, HAT_ACCUM = 2, 8
HAT_TRAIN_PAIRS = 32
SOURCES = ["swin_block", "swin_block_train", "hab_block", "ocab", "rdb_cm", "rdb_cm_bwd"]


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


def write_split(root: Path, gen: np.random.Generator, sizes: dict[str, int]) -> None:
    """Per split, smooth 512x512 HR patches and their 4x box-downsampled LR."""
    from superresolution_def_tpu_torch.data import ManifestEntry, write_manifest, write_tiff_u16

    yy, xx = np.mgrid[0:512, 0:512] / 512.0
    for split, count in sizes.items():
        entries = []
        for i in range(count):
            fx, fy, ph = gen.uniform(1, 6, size=3)
            hr = 0.5 + 0.25 * np.sin(2 * np.pi * (fx * xx + ph)) * np.cos(2 * np.pi * fy * yy)
            hr = np.clip(hr + 0.02 * gen.standard_normal((512, 512)), 0.0, 1.0)
            lr = hr.reshape(128, 4, 128, 4).mean(axis=(1, 3))
            name = "p" if split == "test" else split
            d = root / "T1" / "pairs" / f"{name}{i}"
            write_tiff_u16(d / "hr.tiff", hr)
            write_tiff_u16(d / "lr.tiff", lr)
            entries.append(ManifestEntry(f"{name}{i}", str(d / "hr.tiff"), str(d / "lr.tiff")))
        write_manifest(root / "T1" / "8_dataset_split" / "splits_json" / f"{split}.json",
                       entries)


def block_work(bw: int, c: int = 180, heads: int = 6, hidden: int = 720) -> dict:
    """FLOPs of each kernel over ``bw`` windows of 64 tokens, and the bytes it
    must move: windows in and out (bf16), weights (bf16) read and weight
    gradients (fp32) written once."""
    n = 64
    hd = c // heads
    qkv, proj, mlp = 2 * n * c * 3 * c, 2 * n * c * c, 2 * n * c * hidden
    attn = 2 * n * n * hd * heads  # one of the per-head products, all heads
    rows = bw * n * c * 2          # one (Bw, 64, C) bf16 tensor
    w_attn = (3 * c * c + c * c) * 2
    w_mlp = 2 * c * hidden * 2
    return {
        "K1": (bw * (qkv + 2 * attn + proj + 2 * mlp), 2 * rows + w_attn + w_mlp),
        "K2": (bw * (qkv + 2 * attn + proj + 2 * mlp), 3 * rows + w_attn + w_mlp),
        "K3": (bw * 5 * mlp, 3 * rows + w_mlp + w_mlp * 2),
        "K4": (bw * (3 * qkv + 2 * proj + 6 * attn),
               3 * rows + w_attn + w_attn * 2 + heads * n * n * 4),
    }


def hat_work(bw: int = 2048, c: int = 90, heads: int = 6, hidden: int = 360, nk: int = 144,
             b: int = 8, b_train: int = HAT_MICRO, hw: int = 256 * 256, f: int = 48,
             g: int = 24, shifted_share: float = 0.5) -> dict:
    """FLOPs and bytes of K5, K6, K7 and K8 at the hybrid's shapes. K5: x
    and conv_x in, out (bf16), the weights, and the (256, 64, 64) fp32 mask
    for its shifted half of the calls; K6: x, q, out and the 144-key k and v
    windows, the weights and the bias; K7 (batch ``b``): x in and out, the
    weights. K8 (the train micro-batch ``b_train``): the least work is dx's
    transposed convs and dW, each one product per forward weight and pixel
    (2 x 269,568 FLOP a pixel at 48/24), with no recompute; x, dy in and dx
    out (bf16), the weights read (bf16), dW and db written (fp32)."""
    n = 64
    hd = c // heads
    rows = bw * n * c * 2
    w_block = (3 * c * c + c * c + 2 * c * hidden) * 2
    mlp = 2 * 2 * n * c * hidden
    k5 = bw * (2 * n * c * 3 * c + 2 * 2 * n * n * hd * heads + 2 * n * c * c + mlp)
    k6 = bw * (2 * 2 * n * nk * c + 2 * n * c * c + mlp)
    per_pixel = sum(2 * 9 * (f + i * g) * (g if i < 4 else f) for i in range(5))
    w_rdb = sum(9 * (f + i * g) * (g if i < 4 else f) * 2 for i in range(5))
    return {
        "K5": (k5, 3 * rows + w_block + shifted_share * 256 * n * n * 4),
        "K6": (k6, 3 * rows + 2 * bw * nk * c * 2 + (c * c + 2 * c * hidden) * 2
               + heads * n * nk * 4),
        "K7": (b * hw * per_pixel, 2 * b * f * hw * 2 + w_rdb),
        "K8": (2 * b_train * hw * per_pixel,
               3 * b_train * f * hw * 2 + w_rdb + w_rdb * 2 + (4 * g + f) * 4),
    }


def least_ms(work: tuple) -> tuple[float, str]:
    """Least milliseconds for (flops, bytes) on the card, and what sets it."""
    t_ops, t_bytes = work[0] / PEAK_BF16_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def device_profile(fn, steps: int = 2) -> tuple[list, float, float]:
    """Top device ops (name, ms per step) of ``steps`` calls of ``fn``, the
    device's busy ms per step and its idle share of the kernels' span."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    if not kernels:
        raise SystemExit("torch.profiler saw no device time")
    busy, cur_s, cur_e = 0.0, *kernels[0]
    for s, e in kernels[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = kernels[-1][1] - kernels[0][0]
    ops = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.key, t / 1e3 / steps, e.count // steps))
    ops.sort(key=lambda o: -o[1])
    return ops, busy / 1e3 / steps, 1.0 - busy / span


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on the GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.data import read_tiff_u16
    from superresolution_def_tpu_torch.kernels import _build, hab_block, ocab, swin_block
    # the module, not the function of the same name that the package exports
    rdb_cm = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb_cm")
    rdb_bwd = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb_cm_bwd")
    from superresolution_def_tpu_torch.kernels import (
        fused_hab_block,
        fused_ocab_block,
        fused_rdb_cm,
        fused_rdb_cm_bwd,
        fused_rrdb_trunk_cm_ad,
        fused_swin_block,
        hab_block_reference,
        make_fused_hybrid,
        make_fused_hybrid_train,
        make_fused_swinir,
        ocab_block_reference,
        rdb_cm_bwd_reference,
        rdb_cm_reference,
        swin_block_bwd_attn,
        swin_block_bwd_mlp,
        swin_block_fwd_h,
    )
    from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
    from superresolution_def_tpu_torch.ops import shift_window_attn_mask
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss,
        VGG19Features,
        create_hat_train_state,
        create_swin_train_state,
        make_hat_train_step,
        make_swin_train_step,
    )

    from torch.func import functional_call

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

    # 2. build every source at once
    t0 = time.perf_counter()
    paths = dict(zip(SOURCES, _build.build_all(SOURCES)))
    lib_path, train_lib_path = paths["swin_block"], paths["swin_block_train"]
    swin_block._kernel_library()
    swin_block._train_library()
    hab_block._library()
    ocab._library()
    rdb_cm._library()
    rdb_bwd._library()
    build_s = time.perf_counter() - t0
    log("build", ", ".join(f"{k}.cu -> {v.name}" for k, v in paths.items())
        + f", all {len(SOURCES)} at once in {build_s:.1f} s")
    for name in ("swin_block", "hab_block", "ocab", "rdb_cm", "rdb_cm_bwd"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", f"{name}: " + line.strip().replace("ptxas info    : ", ""))

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
        write_split(root / "data", np.random.default_rng(seed), {"test": N_IMAGES})
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
    del model_bf16, fused

    # 7. the training kernels' build (done with phase 2's)
    log("build-train", f"swin_block_train.cu -> {train_lib_path.name} (parallel build, "
                       f"{build_s:.1f} s for both)")
    for line in _build.build_log("swin_block_train").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build-train", line.strip().replace("ptxas info    : ", ""))

    # 8. K2/K3/K4 against their plain versions at the flagship train shapes
    bw_train = MICRO * (128 // 8) ** 2  # 2048 windows: micro 8 of 128x128
    targs = k1_inputs(torch.Generator().manual_seed(seed + 1), device, bw=bw_train)
    xw, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = targs
    dgen = torch.Generator().manual_seed(seed + 2)
    dout = (1e-2 * torch.randn(bw_train, 64, 180, generator=dgen)).to(device, torch.bfloat16)
    out, h = swin_block_fwd_h(*targs, **kw)
    same_as_k1 = torch.equal(out, fused_swin_block(*targs, **kw))
    want_out, want_h = swin_block.swin_block_fwd_h_reference(*targs, **kw)
    k2_err = (out.float() - want_out.float()).abs().max().item()
    k2_bound = K1_TOL * max(1.0, want_out.float().abs().max().item())
    k2_h_err = (h.float() - want_h.float()).abs().max().item()
    mlp_args = (h, dout, ln2_w, ln2_b, w1, b1, w2)
    attn_args = (xw, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj)
    mlp = swin_block_bwd_mlp(*mlp_args)
    attn = swin_block_bwd_attn(*attn_args, **kw)
    torch.cuda.synchronize()
    want_mlp = swin_block.swin_block_bwd_mlp_reference(*mlp_args)
    want_attn = swin_block.swin_block_bwd_attn_reference(*attn_args, **kw)
    errs = {}
    for name, got_t, want_t in zip(
            ["dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2",
             "dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"],
            (*mlp, *attn), (*want_mlp, *want_attn)):
        if not torch.isfinite(got_t).all():
            raise SystemExit(f"{name} is not finite")
        errs[name] = rel_l2(got_t, want_t)
    k3_err = (mlp[0].float() - want_mlp[0].float()).abs().max().item()
    k4_err = (attn[0].float() - want_attn[0].float()).abs().max().item()
    del want_mlp, want_attn, want_out, want_h
    timing = dict(reps=5, warmup=1, calls=2)
    times = {
        "K2": (cuda_ms(lambda: swin_block_fwd_h(*targs, **kw)),
               cuda_ms(lambda: swin_block.swin_block_fwd_h_reference(*targs, **kw), **timing)),
        "K3": (cuda_ms(lambda: swin_block_bwd_mlp(*mlp_args)),
               cuda_ms(lambda: swin_block.swin_block_bwd_mlp_reference(*mlp_args), **timing)),
        "K4": (cuda_ms(lambda: swin_block_bwd_attn(*attn_args, **kw)),
               cuda_ms(lambda: swin_block.swin_block_bwd_attn_reference(*attn_args, **kw),
                       **timing)),
    }
    log("k2-k4", f"Bw={bw_train} C=180 heads=6 hidden=720 bf16, dout ~ N(0, 1e-2): "
                 f"K2 out == K1 out: {same_as_k1}; K2 max|out-plain|={k2_err:.3e} "
                 f"(bound {k2_bound:.3e}), max|h-plain|={k2_h_err:.3e}")
    log("k2-k4", "rel L2 vs plain (bound %g): " % BWD_REL_L2
                 + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log("k2-k4", f"on {card}: " + ", ".join(
        f"{k} {t[0]:.4f} ms (plain {t[1]:.4f} ms)" for k, t in times.items()))
    if not same_as_k1:
        raise SystemExit("K2's out differs from K1's on the same inputs")
    if not k2_err <= k2_bound or not k2_h_err <= k2_bound:
        raise SystemExit(f"K2 disagrees with its plain version: {k2_err}, {k2_h_err}")
    bad = {k: v for k, v in errs.items() if not v <= BWD_REL_L2}
    if bad:
        raise SystemExit(f"K3/K4 disagree with their plain versions: {bad}")
    del targs, xw, dout, out, h, mlp, attn, mlp_args, attn_args

    # 9. the differentiable fused SwinIR against fp32 autograd, one patch
    model.train()
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    fused_g = make_fused_swinir(model, differentiable=True)
    probe = torch.randn(1, 512, 512, 1, generator=torch.Generator().manual_seed(seed + 3))
    probe = probe.to(device)
    checked = ["conv_first.weight", "layers.0.0.attn.qkv.weight",
               "layers.0.0.attn.relative_position_bias_table"]

    def grads(forward, net, dtype):
        xi = x.clone().to(dtype).requires_grad_()
        net.zero_grad()
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    want_g = grads(model, model, torch.float32)
    ref16 = grads(model16, model16, torch.bfloat16)
    got_g = grads(fused_g, model, torch.float32)
    lines = []
    for name, g, w, r in zip(["input", *checked], got_g, want_g, ref16):
        g_err, g_err16 = rel_l2(g, w), rel_l2(r, w)
        lines.append(f"{name} {g_err:.3e} (nn.Module bf16 {g_err16:.3e})")
        if not (torch.isfinite(g).all() and g_err <= max(GRAD_REL_L2, 2 * g_err16)):
            raise SystemExit(f"fused gradient of {name} disagrees: {g_err} vs {g_err16}")
    log("autograd", "fused bf16 vs fp32 autograd, rel L2 (bound max(%g, 2x nn.Module bf16)): "
        % GRAD_REL_L2 + ", ".join(lines))
    del model16, fused_g, want_g, ref16, got_g
    model.zero_grad(set_to_none=True)

    # 10. the training slice through the CLI
    counters = (fused_swin_block, swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed + 4),
                    {"train": TRAIN_PAIRS, "val": VAL_PAIRS, "test": VAL_PAIRS})
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        last = cli_main(["train", "--arch", "swin", "--target", "T1", "--bf16",
                         "--batch-size", str(MICRO), "--accum-steps", "1", "--epochs", "2",
                         "--max-steps-per-epoch", "2", "--data-root", str(root / "data"),
                         "--outputs-root", str(root / "outputs"), "--seed", str(seed)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {fn.__name__: fn.launches for fn in counters}
        run = root / "outputs" / "T1_DDP_SwinIR"
        steps = 2 * 2
        rows = (run / "metrics.csv").read_text().strip().splitlines()[1:]
        ckpt = torch.load(run / "checkpoints" / "latest_checkpoint.pth", map_location="cpu",
                          weights_only=False)
        init = create_swin_train_state(torch.Generator().manual_seed(seed), device="cpu")
        moved = {
            "G": any(not torch.equal(v, ckpt["net_g"][k]) for k, v in init.g.state_dict().items()),
            "D": any(not torch.equal(v, ckpt["net_d"][k]) for k, v in init.d.state_dict().items()
                     if k.endswith("weight_orig")),
            "EMA": any(not torch.equal(v, ckpt["ema"][k])
                       for k, v in init.ema.state_dict().items()),
        }
        del init, ckpt
        result = cli_main(["infer", "--arch", "swin", "--impl", "fused", "--folder", str(run),
                           "--data-root", str(root / "data")])
        log("train", f"train --bf16, micro {MICRO} x accum 1, 2 epochs x 2 steps: "
                     f"loss_g={last['loss_g']:.5f} loss_d={last['loss_d']:.5f} "
                     f"val PSNR={last['psnr']:.4f} dB, {train_s:.2f} s wall; launches "
                     + ", ".join(f"{k} {v}" for k, v in train_launches.items())
                     + f"; moved {moved}; metrics.csv rows {len(rows)}")
        log("train", f"infer --impl fused of the EMA checkpoint: {result['num_images']} images, "
                     f"PSNR={result['psnr']:.4f} dB SSIM={result['ssim']:.6f}")
        for fn in counters[1:]:
            if train_launches[fn.__name__] != 36 * steps:
                raise SystemExit(f"expected {36 * steps} {fn.__name__} launches, counted "
                                 f"{train_launches[fn.__name__]}")
        if not (np.isfinite(last["loss_g"]) and np.isfinite(last["loss_d"])):
            raise SystemExit(f"non-finite losses: {last}")
        if not all(moved.values()) or len(rows) != 2:
            raise SystemExit(f"weights moved {moved}, metrics rows {len(rows)}")
        if not (np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])):
            raise SystemExit("infer of the trained checkpoint gave non-finite metrics")

    # 11. train-step throughput, fused vs nn.Module generator, micro 8 x accum 1
    bgen = np.random.default_rng(seed + 5)
    batch = {"lr": bgen.integers(0, 65535, (1, MICRO, 128, 128, 1), dtype=np.uint16),
             "hr": bgen.integers(0, 65535, (1, MICRO, 512, 512, 1), dtype=np.uint16)}
    vgg = VGG19Features(35, dtype=torch.bfloat16).to(device).requires_grad_(False)
    step_ms, peak_gb = {}, {}
    for impl in ("fused", "module"):
        state = create_swin_train_state(torch.Generator().manual_seed(seed),
                                        dtype=torch.bfloat16, fused=impl == "fused",
                                        device=device)
        step = make_swin_train_step(state, accum_steps=1, criterion_g=CombinedGANLoss(
            pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005, vgg_apply=vgg))
        torch.cuda.reset_peak_memory_stats()
        step_ms[impl] = cuda_ms(lambda: step(batch, 1e-4, 1e-4), reps=3, warmup=2, calls=2)
        peak_gb[impl] = torch.cuda.max_memory_allocated() / 1e9
        if impl == "fused":
            ops, busy_ms, idle = device_profile(lambda: step(batch, 1e-4, 1e-4))
            log("profile", f"fused train step on {card}: device busy {busy_ms:.3f} ms per "
                           f"step, idle share {idle:.4f}; top device ops per step: " + "; ".join(
                               f"{name[:60]} {t:.3f} ms x{n}" for name, t, n in ops[:10]))
        del state, step
        torch.cuda.empty_cache()
    log("train-throughput", f"micro {MICRO} x accum 1, 128->512 on {card}: fused "
        f"{MICRO * 1e3 / step_ms['fused']:.3f} patches/s ({step_ms['fused']:.2f} ms/step, "
        f"peak {peak_gb['fused']:.2f} GB), nn.Module bf16 "
        f"{MICRO * 1e3 / step_ms['module']:.3f} patches/s ({step_ms['module']:.2f} ms/step, "
        f"peak {peak_gb['module']:.2f} GB)")

    # 12. the hybrid's kernels against their plain versions at config #2's shapes
    bw_hat = HYBRID_BATCH * (128 // 8) ** 2  # 2048 windows: batch 8 of 128x128
    hgen = torch.Generator().manual_seed(seed + 6)
    hargs = k1_inputs(hgen, device, bw=bw_hat, c=90, heads=6, hidden=360)
    conv_x = (0.1 * torch.randn(bw_hat, 64, 90, generator=hgen)).to(device, torch.bfloat16)
    mask = torch.from_numpy(shift_window_attn_mask(128, 128, 8, 4)).to(device)
    hkw = dict(num_heads=6, scale=15**-0.5, conv_scale=0.01)
    k5_err, k5_bound, k5_ms, k5_plain = {}, {}, {}, {}
    for tag, m in (("unshifted", None), ("shifted", mask)):
        a = (hargs[0], conv_x, m, *hargs[1:])
        got = fused_hab_block(*a, **hkw)
        torch.cuda.synchronize()
        want = hab_block_reference(*a, **hkw)
        k5_err[tag] = (got.float() - want.float()).abs().max().item()
        k5_bound[tag] = K1_TOL * max(1.0, want.float().abs().max().item())
        k5_ms[tag] = cuda_ms(lambda: fused_hab_block(*a, **hkw))
        k5_plain[tag] = cuda_ms(lambda: hab_block_reference(*a, **hkw), reps=5, warmup=1, calls=2)
        if not torch.isfinite(got).all() or not k5_err[tag] <= k5_bound[tag]:
            raise SystemExit(f"K5 ({tag}) disagrees with its plain version: {k5_err[tag]}")
    log("k5", f"Bw={bw_hat} C=90 heads=6 hidden=360 bf16 on {card}: " + "; ".join(
        f"{t}: max|kernel-plain|={k5_err[t]:.3e} (bound {k5_bound[t]:.3e}), kernel "
        f"{k5_ms[t]:.4f} ms, plain {k5_plain[t]:.4f} ms" for t in k5_err))
    oargs = [hargs[0], *(torch.randn(bw_hat, n, 90, generator=hgen).to(device, torch.bfloat16)
                         for n in (64, 144, 144)),
             (0.5 * torch.randn(6, 64, 144, generator=hgen)).to(device), *hargs[6:]]
    okw = dict(num_heads=6, scale=15**-0.5)
    got = fused_ocab_block(*oargs, **okw)
    torch.cuda.synchronize()
    want = ocab_block_reference(*oargs, **okw)
    k6_err = (got.float() - want.float()).abs().max().item()
    k6_bound = K1_TOL * max(1.0, want.float().abs().max().item())
    k6_times = (cuda_ms(lambda: fused_ocab_block(*oargs, **okw)),
                cuda_ms(lambda: ocab_block_reference(*oargs, **okw), reps=5, warmup=1, calls=2))
    log("k6", f"Bw={bw_hat} nq=64 nk=144 C=90 heads=6 hidden=360 bf16 on {card}: "
              f"max|kernel-plain|={k6_err:.3e} (bound {k6_bound:.3e}), kernel "
              f"{k6_times[0]:.4f} ms, plain {k6_times[1]:.4f} ms")
    if not torch.isfinite(got).all() or not k6_err <= k6_bound:
        raise SystemExit(f"K6 disagrees with its plain version: {k6_err} > {k6_bound}")
    del hargs, conv_x, oargs, got, want
    rgen = np.random.default_rng(seed + 7)
    f, g = HYBRID["num_feat"], HYBRID["num_grow_ch"]
    xr = torch.from_numpy(0.5 * rgen.standard_normal((HYBRID_BATCH, f, 256 * 256)).astype(
        np.float32)).to(device, torch.bfloat16)
    ks = [torch.from_numpy((rgen.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                            * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32)).to(device)
          for i in range(5)]
    bs = [torch.from_numpy((0.05 * rgen.standard_normal(g if i < 4 else f)).astype(np.float32))
          .to(device) for i in range(5)]
    rkw = dict(h=256, w=256)
    got = fused_rdb_cm(xr, ks, bs, **rkw)
    torch.cuda.synchronize()
    want = rdb_cm_reference(xr, ks, bs, **rkw)
    k7_err = (got.float() - want.float()).abs().max().item()
    k7_bound = K1_TOL * max(1.0, want.float().abs().max().item())
    k7_times = (cuda_ms(lambda: fused_rdb_cm(xr, ks, bs, **rkw), reps=10),
                cuda_ms(lambda: rdb_cm_reference(xr, ks, bs, **rkw), reps=5, warmup=1, calls=2))
    log("k7", f"B={HYBRID_BATCH} F={f} G={g} 256x256 bf16 on {card}: max|kernel-plain|="
              f"{k7_err:.3e} (bound {k7_bound:.3e}), kernel {k7_times[0]:.4f} ms, plain "
              f"{k7_times[1]:.4f} ms (fp32 convs, no TF32)")
    if not torch.isfinite(got).all() or not k7_err <= k7_bound:
        raise SystemExit(f"K7 disagrees with its plain version: {k7_err} > {k7_bound}")
    del xr, ks, bs, got, want
    torch.cuda.empty_cache()

    # 13. the hybrid slice through the CLI (its main path: counts from 0)
    hybrid = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(seed))
    hat_counters = (fused_hab_block, fused_ocab_block, fused_rdb_cm)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed), {"test": N_IMAGES})
        run = root / "outputs" / "T1_DDP_SwinIR"
        (run / "checkpoints").mkdir(parents=True)
        torch.save({"model_state_dict": hybrid.state_dict()},
                   run / "checkpoints" / "best_hybrid_model.pth")
        for fn in hat_counters:
            fn.launches = 0
        t0 = time.perf_counter()
        result = cli_main(["infer", "--arch", "hat", "--impl", "fused", "--folder", str(run),
                           "--data-root", str(root / "data")])
        torch.cuda.synchronize()
        hat_s = time.perf_counter() - t0
        hat_launches = {fn.__name__: fn.launches for fn in hat_counters}
        out = run / "test_results"
        missing = [f"test_{i:04d}_{s_}" for i in range(N_IMAGES) for s_ in ("sr.tiff", "tris.png")
                   if not (out / f"test_{i:04d}_{s_}").exists()]
        if not (out / "test_metrics.csv").exists():
            missing.append("test_metrics.csv")
        csv_rows = (out / "test_metrics.csv").read_text().strip().splitlines() if not missing else []
        log("hat-slice", f"infer --arch hat --impl fused: {result['num_images']} images, "
                         f"PSNR={result['psnr']:.4f} dB SSIM={result['ssim']:.6f}, launches "
                         + ", ".join(f"{k} {v}" for k, v in hat_launches.items())
                         + f", {hat_s:.2f} s wall; test_metrics.csv rows {len(csv_rows) - 1}")
        if missing or result["num_images"] != N_IMAGES or len(csv_rows) != N_IMAGES + 1:
            raise SystemExit(f"hat infer artifacts missing: {missing}, csv rows {len(csv_rows)}")
        if not (np.isfinite(result["psnr"]) and np.isfinite(result["ssim"])):
            raise SystemExit("hat infer metrics are not finite")
        for fn, per_image in zip(hat_counters, (24, 4, 36)):
            if hat_launches[fn.__name__] != per_image * N_IMAGES:
                raise SystemExit(f"expected {per_image * N_IMAGES} {fn.__name__} launches, "
                                 f"counted {hat_launches[fn.__name__]}")

    # 14. fused bf16 hybrid against the fp32 module, one patch
    hybrid = hybrid.to(device).eval()
    fused_h = make_fused_hybrid(hybrid)
    hybrid16 = copy.deepcopy(hybrid).to(torch.bfloat16)
    with torch.no_grad():
        ref = hybrid(x)
        got = fused_h(x).float()
        ref16 = hybrid16(x.to(torch.bfloat16)).float()
    if got.shape != (1, 512, 512, 1) or not torch.isfinite(got).all():
        raise SystemExit(f"fused hybrid gave {tuple(got.shape)} or non-finite values")
    rel, rel16 = rel_l2(got, ref), rel_l2(ref16, ref)
    log("hat-forward", f"128->512, rel L2 to the fp32 module: fused bf16 {rel:.3e}, "
                       f"nn.Module bf16 {rel16:.3e} (bound max({FORWARD_REL_L2}, 2x)); fused "
                       f"max abs {(got - ref).abs().max().item():.3e}")
    if not rel <= max(FORWARD_REL_L2, 2 * rel16):
        raise SystemExit(f"fused hybrid disagrees with the module: {rel} vs {rel16}")
    del ref, got, ref16

    # 15. hybrid throughput at batch 8 and the fused forward's profile
    x8 = x.repeat(HYBRID_BATCH, 1, 1, 1)
    torch.cuda.reset_peak_memory_stats()
    hyb_ms = cuda_ms(lambda: fused_h(x8), reps=5, warmup=2, calls=2)
    hyb_peak = torch.cuda.max_memory_allocated() / 1e9
    x8_16 = x8.to(torch.bfloat16)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        hyb16_ms = cuda_ms(lambda: hybrid16(x8_16), reps=5, warmup=2, calls=2)
        hyb16_peak = torch.cuda.max_memory_allocated() / 1e9
    log("hat-throughput", f"batch {HYBRID_BATCH}, 128->512 on {card}: fused "
        f"{HYBRID_BATCH * 1e3 / hyb_ms:.3f} patches/s ({hyb_ms:.3f} ms, peak {hyb_peak:.2f} GB), "
        f"nn.Module bf16 {HYBRID_BATCH * 1e3 / hyb16_ms:.3f} patches/s ({hyb16_ms:.3f} ms, "
        f"peak {hyb16_peak:.2f} GB)")
    ops, busy_ms, idle = device_profile(lambda: fused_h(x8))
    log("hat-profile", f"fused hybrid forward, batch {HYBRID_BATCH} on {card}: device busy "
                       f"{busy_ms:.3f} ms per forward, idle share {idle:.4f}; top device ops: "
                       + "; ".join(f"{name[:60]} {t:.3f} ms x{n}" for name, t, n in ops[:10]))
    del hybrid, hybrid16, fused_h, x8, x8_16
    torch.cuda.empty_cache()

    # 16. K8 against its plain version at the hybrid train step's shapes,
    # with K7's stashing forward at the same micro-batch
    kgen = np.random.default_rng(seed + 8)
    b2 = HAT_MICRO
    xb = torch.from_numpy(0.5 * kgen.standard_normal((b2, f, 256 * 256)).astype(
        np.float32)).to(device, torch.bfloat16)
    dyb = torch.from_numpy(1e-2 * kgen.standard_normal((b2, f, 256 * 256)).astype(
        np.float32)).to(device, torch.bfloat16)
    ks = [torch.from_numpy((kgen.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                            * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32)).to(device)
          for i in range(5)]
    bs = [torch.from_numpy((0.05 * kgen.standard_normal(g if i < 4 else f)).astype(np.float32))
          .to(device) for i in range(5)]
    stash = torch.empty(b2, 256 * 256, f + 4 * g, dtype=torch.bfloat16, device=device)
    same_k7 = torch.equal(fused_rdb_cm(xb, ks, bs, **rkw, stash=stash),
                          fused_rdb_cm(xb, ks, bs, **rkw))
    got8 = fused_rdb_cm_bwd(xb, dyb, ks, bs, **rkw, stash=stash)
    again = fused_rdb_cm_bwd(xb, dyb, ks, bs, **rkw, stash=stash)
    torch.cuda.synchronize()
    got8 = [got8[0], *got8[1], *got8[2]]
    same_bits = all(torch.equal(a, b) for a, b in zip(got8, [again[0], *again[1], *again[2]]))
    want8 = rdb_cm_bwd_reference(xb, dyb, ks, bs, **rkw)
    want8 = [want8[0], *want8[1], *want8[2]]
    names8 = ["dx"] + [f"dW{i}" for i in range(1, 6)] + [f"db{i}" for i in range(1, 6)]
    errs8 = {}
    for name, a, b in zip(names8, got8, want8):
        if not torch.isfinite(a).all():
            raise SystemExit(f"K8's {name} is not finite")
        errs8[name] = rel_l2(a, b)
    k8_err = (got8[0].float() - want8[0].float()).abs().max().item()
    del again, want8
    packed7 = rdb_cm.pack_rdb_weights(ks, bs, device)
    packed8 = rdb_bwd.pack_rdb_bwd_weights(ks, device)
    k8_times = (cuda_ms(lambda: fused_rdb_cm_bwd(xb, dyb, ks, bs, **rkw, stash=stash,
                                                 packed=packed8), reps=10),
                cuda_ms(lambda: rdb_cm_bwd_reference(xb, dyb, ks, bs, **rkw), reps=5, warmup=1,
                        calls=2))
    k7b2_times = (cuda_ms(lambda: fused_rdb_cm(xb, ks, bs, **rkw, packed=packed7, stash=stash),
                          reps=10),
                  cuda_ms(lambda: rdb_cm_reference(xb, ks, bs, **rkw), reps=5, warmup=1,
                          calls=2))
    k8_bound = least_ms(hat_work(b=b2)["K8"])
    log("k8", f"B={b2} F={f} G={g} 256x256 bf16, dy ~ N(0, 1e-2) on {card}: rel L2 vs plain "
              f"(bound {BWD_REL_L2}): " + ", ".join(f"{k} {v:.3e}" for k, v in errs8.items())
              + f"; max|dx-plain|={k8_err:.3e}; two runs bit-identical: {same_bits}")
    log("k8", f"K8 {k8_times[0]:.4f} ms (bound {k8_bound[0]:.4f} ms, {k8_bound[1]}), plain "
              f"{k8_times[1]:.4f} ms; K7 with stash at B={b2} {k7b2_times[0]:.4f} ms (bound "
              f"{least_ms(hat_work(b=b2)['K7'])[0]:.4f} ms), plain {k7b2_times[1]:.4f} ms; "
              f"K7's output with and without the stash identical: {same_k7}")
    bad = {k: v for k, v in errs8.items() if not v <= BWD_REL_L2}
    if bad or not same_bits or not same_k7:
        raise SystemExit(f"K8 disagrees with its plain version {bad}, or is not reproducible "
                         f"({same_bits}), or the stash changed K7's output ({same_k7})")
    del xb, dyb, ks, bs, stash, got8, packed7, packed8
    torch.cuda.empty_cache()

    # 17. fused bf16 trunk and fused hybrid generator gradients against fp32
    # autograd of the nn.Module
    hyb = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(seed)).to(device)
    hyb16 = copy.deepcopy(hyb).to(torch.bfloat16)
    tgen = torch.Generator().manual_seed(seed + 9)
    feat = (0.5 * torch.randn(1, 256, 256, f, generator=tgen)).to(device)
    tprobe = torch.randn(1, 256, 256, f, generator=tgen).to(device)

    def module_trunk(net, xin):
        t = xin.permute(0, 3, 1, 2)
        for rrdb in net.rrdb_trunk:
            t = rrdb(t)
        return t.permute(0, 2, 3, 1)

    def fused_trunk(net, xin):
        return fused_rrdb_trunk_cm_ad(
            [[([c.weight for c in rdb.convs()], [c.bias for c in rdb.convs()])
              for rdb in (rrdb.rdb1, rrdb.rdb2, rrdb.rdb3)] for rrdb in net.rrdb_trunk], xin)

    def grads(forward, net, xin, probe_, names):
        xi = xin.clone().requires_grad_()
        net.zero_grad(set_to_none=True)
        (forward(xi).float() * probe_).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in names]

    lines = []
    for what, names, want_fn, ref_fn, got_fn, xin, probe_ in (
        ("trunk", ["rrdb_trunk.0.rdb1.conv1.weight", "rrdb_trunk.0.rdb1.conv5.bias",
                   "rrdb_trunk.11.rdb3.conv5.weight"],
         lambda xi: module_trunk(hyb, xi), lambda xi: module_trunk(hyb16, xi),
         lambda xi: fused_trunk(hyb, xi), feat, tprobe),
        ("generator", ["hat.conv_first.weight", "hat.layers.0.residual_group.blocks.0.attn.qkv.weight",
                       "conv_adapt.weight", "rrdb_trunk.0.rdb1.conv1.weight", "conv_last.weight"],
         hyb, hyb16, make_fused_hybrid_train(hyb), x, probe),
    ):
        want_g = grads(want_fn, hyb, xin, probe_, names)
        ref16 = grads(ref_fn, hyb16, xin.to(torch.bfloat16), probe_, names)
        got_g = grads(got_fn, hyb, xin.to(torch.bfloat16) if what == "trunk" else xin, probe_,
                      names)
        for name, gt, w, r in zip(["input", *names], got_g, want_g, ref16):
            g_err, g_err16 = rel_l2(gt, w), rel_l2(r, w)
            lines.append(f"{what} {name} {g_err:.3e} (nn.Module bf16 {g_err16:.3e})")
            if not (torch.isfinite(gt).all() and g_err <= max(GRAD_REL_L2, 2 * g_err16)):
                raise SystemExit(f"fused {what} gradient of {name} disagrees: {g_err} vs "
                                 f"{g_err16}")
    log("hat-autograd", "fused bf16 vs fp32 autograd, rel L2 (bound max(%g, 2x nn.Module bf16)): "
        % GRAD_REL_L2 + "; ".join(lines))
    del hyb, hyb16, feat, tprobe
    torch.cuda.empty_cache()

    # 18. the hybrid training slice through the CLI (its main path: counts from 0)
    train_counters = (fused_rdb_cm, fused_rdb_cm_bwd)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed + 10),
                    {"train": HAT_TRAIN_PAIRS, "test": N_IMAGES})
        for fn in train_counters:
            fn.launches = 0
        t0 = time.perf_counter()
        last = cli_main(["train", "--arch", "hat", "--target", "T1", "--bf16",
                         "--batch-size", str(HAT_MICRO), "--accum-steps", str(HAT_ACCUM),
                         "--epochs", "2", "--warmup-epochs", "1", "--max-steps-per-epoch", "2",
                         "--ckpt-interval", "1", "--img-interval", "1", "--csv-interval", "1",
                         "--data-root", str(root / "data"), "--outputs-root",
                         str(root / "outputs"), "--seed", str(seed)])
        torch.cuda.synchronize()
        hat_train_s = time.perf_counter() - t0
        hat_train_launches = {fn.__name__: fn.launches for fn in train_counters}
        run = root / "outputs" / "T1"
        steps = 2 * 2
        per_step = 3 * HYBRID["num_rrdb"] * HAT_ACCUM  # 288
        rows = [r.split(",") for r in (run / "train_log.csv").read_text().strip().splitlines()]
        ck = run / "checkpoints"
        missing = [n for n in ("hybrid_epoch_1.pth", "hybrid_epoch_2.pth", "best_hybrid_model.pth",
                               "best_hybrid_model_EMA.pth") if not (ck / n).exists()]
        missing += [n for n in ("epoch_001_preview.png", "epoch_002_preview.png")
                    if not (run / "previews" / n).exists()]
        init = create_hat_train_state(torch.Generator().manual_seed(seed), device="cpu")
        ep1, ep2 = (torch.load(ck / f"hybrid_epoch_{e}.pth", map_location="cpu",
                               weights_only=False) for e in (1, 2))

        def differs(a, b, suffix):
            return any(not torch.equal(v, b[k]) for k, v in a.items() if k.endswith(suffix))

        moved = {"G warmup": differs(init.g.state_dict(), ep1["net_g"], ""),
                 "G GAN": differs(ep1["net_g"], ep2["net_g"], ""),
                 "D warmup (must not)": differs(init.d.state_dict(), ep1["net_d"], ""),
                 "D GAN": differs(ep1["net_d"], ep2["net_d"], "weight_orig"),
                 "EMA": differs(ep2["net_g"], ep2["ema"], "")}
        del init, ep1, ep2
        log("hat-train", f"train --arch hat --bf16, micro {HAT_MICRO} x accum {HAT_ACCUM}, 2 "
                         f"epochs (warmup, GAN) x 2 steps: G={last['g_total']:.5f} "
                         f"L1={last['l1']:.5f} D={last['d_total']:.5f} PSNR={last['psnr']:.4f} "
                         f"dB SSIM={last['ssim']:.5f}, {hat_train_s:.2f} s wall; launches "
                         + ", ".join(f"{k} {v}" for k, v in hat_train_launches.items())
                         + f"; moved {moved}; train_log.csv rows {len(rows) - 1}")
        result = cli_main(["infer", "--arch", "hat", "--impl", "fused", "--folder", str(run),
                           "--data-root", str(root / "data")])
        log("hat-train", f"infer --arch hat --impl fused of the trained run: "
                         f"{result['num_images']} images, PSNR={result['psnr']:.4f} dB "
                         f"SSIM={result['ssim']:.6f}")
        # K7 also runs in the two previews (one no-grad forward each)
        want_launches = {"fused_rdb_cm_bwd": per_step * steps,
                         "fused_rdb_cm": per_step * steps + 3 * HYBRID["num_rrdb"] * 2}
        if hat_train_launches != want_launches:
            raise SystemExit(f"expected launches {want_launches}, counted {hat_train_launches}")
        if missing or len(rows) != 3 or rows[0][0] != "Epoch" or float(rows[1][4]) != 0.0:
            raise SystemExit(f"hat train artifacts missing {missing} or train_log.csv {rows}")
        expect = {k: k != "D warmup (must not)" for k in moved}
        if moved != expect:
            raise SystemExit(f"weights moved {moved}, expected {expect}")
        if not all(np.isfinite(last[k]) for k in ("g_total", "l1", "d_total", "psnr", "ssim")):
            raise SystemExit(f"non-finite hat train metrics: {last}")
        if result["num_images"] != N_IMAGES or not np.isfinite(result["psnr"]):
            raise SystemExit("infer of the trained hybrid failed")

    # 19./20. hybrid GAN step throughput, fused vs nn.Module, and the profile
    tb = np.random.default_rng(seed + 11)

    def hat_batch(micro, accum):
        return {"lr": tb.integers(0, 65535, (accum, micro, 128, 128, 1), dtype=np.uint16),
                "hr": tb.integers(0, 65535, (accum, micro, 512, 512, 1), dtype=np.uint16)}

    hat_step_ms, hat_step_peak = {}, {}
    for impl, micro, accum in (("fused", HAT_MICRO, HAT_ACCUM), ("module", HAT_MICRO, HAT_ACCUM),
                               ("fused", 8, 2)):
        st = create_hat_train_state(torch.Generator().manual_seed(seed), dtype=torch.bfloat16,
                                    fused=impl == "fused", device=device)
        stp = make_hat_train_step(st, accum_steps=accum, criterion_g=CombinedGANLoss(
            pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005, vgg_apply=vgg))
        hb = hat_batch(micro, accum)
        torch.cuda.reset_peak_memory_stats()
        key = f"{impl} {micro}x{accum}"
        hat_step_ms[key] = cuda_ms(lambda: stp(hb, 1e-4, 1e-4), reps=3, warmup=1, calls=1)
        hat_step_peak[key] = torch.cuda.max_memory_allocated() / 1e9
        if key == f"fused {HAT_MICRO}x{HAT_ACCUM}":
            ops, busy_ms, idle = device_profile(lambda: stp(hb, 1e-4, 1e-4), steps=1)
            groups = {"K7": ("rdb_kernel",), "K8": ("chain_kernel", "wgrad_kernel",
                                                    "reduce_kernel"),
                      "AdamW+EMA": ("multi_tensor_apply",)}
            split = {k: sum(t for name, t, _ in ops if any(p in name for p in pats))
                     for k, pats in groups.items()}
            split["rest"] = sum(t for _, t, _ in ops) - sum(split.values())
            # the step's other parts, timed alone at its shapes, per step
            xin = torch.from_numpy(hb["lr"][0].astype(np.float32) / 65535.0).to(device)
            hr = torch.from_numpy(hb["hr"][0].astype(np.float32) / 65535.0).to(device)
            dgen = torch.Generator(device).manual_seed(0)

            def hat_fb():
                params = {k: v.to(torch.bfloat16) for k, v in st.g.hat.named_parameters()}
                out = functional_call(st.g.hat, params,
                                                 (xin.to(torch.bfloat16), False, dgen))
                out.float().sum().backward()

            sr = hr.to(torch.bfloat16).requires_grad_()

            def d_fb():
                fake, real = st.d(sr, True), st.d(hr, True).detach()
                torch.autograd.grad((fake.float() - real.float()).mean(), sr)
                fake, real = st.d(sr.detach(), True), st.d(hr, True)
                (real.float() - fake.float()).mean().backward()

            def vgg_fb():
                with torch.no_grad():
                    tf = vgg(hr)
                torch.autograd.grad((vgg(sr) - tf).abs().mean(), sr)

            parts = {name: accum * cuda_ms(fn, reps=3, warmup=1, calls=2)
                     for name, fn in (("HAT fwd+bwd", hat_fb), ("D (4 fwd, 2 bwd)", d_fb),
                                      ("VGG fwd+bwd", vgg_fb))}
            st.g.zero_grad(set_to_none=True)
            st.d.zero_grad(set_to_none=True)
            log("hat-train-profile",
                f"fused hybrid GAN step, micro {micro} x accum {accum} on {card}: device busy "
                f"{busy_ms:.3f} ms per step, idle share {idle:.4f}; by kernel group per step: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
                + "; timed alone per step: " + ", ".join(f"{k} {v:.3f} ms"
                                                        for k, v in parts.items())
                + "; top device ops: " + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                                                    for name, t, n in ops[:10]))
            del xin, hr, sr
        del st, stp, hb
        torch.cuda.empty_cache()
    log("hat-train-throughput", f"hybrid GAN step, 128->512 on {card}: " + "; ".join(
        f"{k} {int(k.split()[1].split('x')[0]) * int(k.split('x')[1]) * 1e3 / ms:.3f} patches/s "
        f"({ms:.2f} ms/step, peak {hat_step_peak[k]:.2f} GB)" for k, ms in hat_step_ms.items()))

    work = block_work(768)
    work.update({k: v for k, v in block_work(bw_train).items() if k != "K1"})
    work.update(hat_work(bw_hat))
    rows = [
        ("fused_swin_block", "K1", "swin_block.cu", 1220, launches, err, (k1_ms, plain_ms)),
        ("swin_block_fwd_h", "K2", "swin_block.cu", 918, train_launches["swin_block_fwd_h"],
         k2_err, times["K2"]),
        ("swin_block_bwd_mlp", "K3", "swin_block_train.cu", 951,
         train_launches["swin_block_bwd_mlp"], k3_err, times["K3"]),
        ("swin_block_bwd_attn", "K4", "swin_block_train.cu", 989,
         train_launches["swin_block_bwd_attn"], k4_err, times["K4"]),
        # K5's time is the mean of its unshifted and shifted calls, half each
        # on the main path
        ("fused_hab_block", "K5", "hab_block.cu", 310, hat_launches["fused_hab_block"],
         max(k5_err.values()), (statistics.mean(k5_ms.values()),
                                statistics.mean(k5_plain.values()))),
        ("fused_ocab_block", "K6", "ocab.cu", 145, hat_launches["fused_ocab_block"], k6_err,
         k6_times),
        ("fused_rdb_cm", "K7", "rdb_cm.cu", 186, hat_launches["fused_rdb_cm"], k7_err, k7_times),
        ("fused_rdb_cm_bwd", "K8", "rdb_cm_bwd.cu", 338, hat_train_launches["fused_rdb_cm_bwd"],
         k8_err, k8_times),
    ]
    replaced = {"K5": SWIN, "K6": "superresolution_def_tpu/kernels/ocab.py",
                "K7": "superresolution_def_tpu/kernels/fused_rdb_cm.py",
                "K8": "superresolution_def_tpu/kernels/fused_rdb_cm_bwd.py"}
    records = []
    for name, key, src, line, n, e, (ms, pms) in rows:
        bms, by = least_ms(work[key])
        records.append({
            "name": name, "route": "cuda",
            "source": f"superresolution_def_tpu_torch/csrc/{src}",
            "replaces": f"{replaced.get(key, SWIN)}:{line}", "launches": n, "max_abs_err": e,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes a whole Swin/HAB block, its
            # backward, an OCAB tail, a dense block or its backward
            "library_ms": None,
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
