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
    ``torch.profiler`` top device ops and idle share.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it fails at once:
the port has no CPU path here.
"""

from __future__ import annotations

import argparse
import copy
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
    from superresolution_def_tpu_torch.kernels import _build, swin_block
    from superresolution_def_tpu_torch.kernels import (
        fused_swin_block,
        make_fused_swinir,
        swin_block_bwd_attn,
        swin_block_bwd_mlp,
        swin_block_fwd_h,
    )
    from superresolution_def_tpu_torch.models import SwinIR
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss,
        VGG19Features,
        create_swin_train_state,
        make_swin_train_step,
    )

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
    lib_path, train_lib_path = _build.build_all(["swin_block", "swin_block_train"])
    swin_block._kernel_library()
    swin_block._train_library()
    build_s = time.perf_counter() - t0
    log("build", f"swin_block.cu -> {lib_path.name}, swin_block_train.cu -> "
                 f"{train_lib_path.name}, both in {build_s:.1f} s")
    for line in _build.build_log("swin_block").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build", line.strip().replace("ptxas info    : ", ""))

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

    work = block_work(768)
    work.update({k: v for k, v in block_work(bw_train).items() if k != "K1"})
    rows = [
        ("fused_swin_block", "K1", "swin_block.cu", 1220, launches, err, (k1_ms, plain_ms)),
        ("swin_block_fwd_h", "K2", "swin_block.cu", 918, train_launches["swin_block_fwd_h"],
         k2_err, times["K2"]),
        ("swin_block_bwd_mlp", "K3", "swin_block_train.cu", 951,
         train_launches["swin_block_bwd_mlp"], k3_err, times["K3"]),
        ("swin_block_bwd_attn", "K4", "swin_block_train.cu", 989,
         train_launches["swin_block_bwd_attn"], k4_err, times["K4"]),
    ]
    records = []
    for name, key, src, line, n, e, (ms, pms) in rows:
        bms, by = least_ms(work[key])
        records.append({
            "name": name, "route": "cuda",
            "source": f"superresolution_def_tpu_torch/csrc/{src}",
            "replaces": f"{SWIN}:{line}", "launches": n, "max_abs_err": e, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            # no single PyTorch call computes a whole Swin block or its backward
            "library_ms": None,
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
