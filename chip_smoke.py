#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each printing a line, any failure ending the run with a non-zero
exit code:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every CUDA source (all at once, one nvcc each), with time,
   the ptxas lines of each kernel, ptxas's registers and spills of K1's,
   K2's, K5's and K9a's instantiations of the wgmma forward
   (``swin_fwd_wg_kernel<3, 32, false>``, ``<3, 32, true>``,
   ``hab_fwd_wg_kernel<2, 16>``, ``hab_fwd_h_wg_kernel<2, 16>``) and of K4b's
   three phases (``swin_fwd_h32_wg_kernel<3, 32>``, ``mlp_bwd_f32_kernel<3>``,
   ``attn_wg_f32_kernel<3, 32>``), and the dynamic shared memory of K1/K2's,
   K5/K9a's and K4b's kernels and of K7's five conv kernels;
3. K1 (``fused_swin_block``) against its plain PyTorch version at the
   flagship shapes (Bw=768, C=180, 6 heads, hidden 720, bf16), run twice to
   the same bits and on weights packed once (``pack_swin_block_weights``,
   as the inference forward passes them) to the bits of a call that packs
   them itself, with its time on weights packed once, with one window a
   block instead of two, and packing on every call;
4. the inference slice: a synthetic 128->512 test split and a seeded flagship
   SwinIR checkpoint through ``cli.main infer --arch swin --impl fused``,
   counting K1's launches (36 per image);
5. the fused bf16 forward against the fp32 ``nn.Module`` forward on one patch;
6. patches/s of the fused forward and of the bf16 ``nn.Module`` forward;
7. the training kernels' build (``swin_block_train.cu``): ptxas registers
   and spills of every kernel (K3/K9b's ``mlp_bwd_kernel``, K4/K9c's
   ``attn_wg_kernel`` and their packings), and the dynamic shared memory of
   K3's window kernel, K9b's, K4's (C=180) and K9c's (C=96) with their
   windows a block, and the shared weight-gradient product;
8. K2/K3/K4 against their plain versions at the flagship train shapes
   (Bw=2048: micro 8 of 128x128, bf16), K2's ``out`` within K1's bound of
   K1's (K2 is a wgmma design of its own), K2, K3 and K4 each
   run twice to the same bits, K4's weight packing (``attn_pack_kernel``)
   bit for bit its plain version at C=180 and C=96, with times, and K2's,
   K3's and K4's device time per kernel (window kernels, weight-gradient
   products, column sums, weight packings);
9. the differentiable fused SwinIR (K2 forward, K3 + K4 backward) against
   autograd of the fp32 ``nn.Module`` on one patch;
10. the training slice: ``cli.main train --arch swin --bf16`` for 2 epochs of
    2 steps (micro 8) on a synthetic 16/4 train/val split, counting K2/K3/K4
    launches (36 each per step), then ``infer --impl fused`` of its EMA
    checkpoint;
11. train patches/s of the fused bf16 step and of the same step with the
    bf16 ``nn.Module`` generator, their peak memory, and the fused step's
    ``torch.profiler`` top device ops, idle share and device time by kernel
    group (K2, K3, K4, their weight-gradient products and column sums; a
    group whose patterns match no device time fails the phase, here and in
    phases 15, 20 and 25);
12. the HAT-hybrid kernels against their plain versions at the served
    config's shapes (BASELINE config #2, batch 8 of 128x128): K5
    (``fused_hab_block``, Bw=2048, C=90, 6 heads, hidden 360) unshifted and
    shifted, each run twice to the same bits and timed on weights padded and
    packed once as the hybrid's forward passes them, K6 (``fused_ocab_block``,
    64 queries against 144 overlap keys, the first 14 zero; run twice and on
    weights padded and packed once to the same bits, timed on those as the
    hybrid's forward passes them, and with the padding and packing on every
    call beside it) and K7 (``fused_rdb_cm``, B=8, F=48 at 256x256, G=24, run twice to the
    same bits), with times and K7's device time per kernel (the x
    transpose and its five convs);
13. the hybrid slice: a seeded config-#2 ``best_hybrid_model.pth`` through
    ``cli.main infer --arch hat --impl fused`` on the synthetic test split,
    counting K5/K6/K7 launches (24, 4 and 36 per image) and checking every
    artifact, ``test_metrics.csv`` included;
14. the fused bf16 hybrid against the fp32 ``nn.Module`` on one patch,
    beside the bf16 ``nn.Module``'s own distance;
15. patches/s at batch 8 of the fused hybrid and of the bf16 ``nn.Module``,
    and the fused forward's ``torch.profiler`` top device ops, idle share
    and device time by kernel group (K5, K6, K7) with each group's share;
16. K8 (``fused_rdb_cm_bwd``, the dense-block backward) against its plain
    version at the hybrid train step's shapes (B=2, F=48, G=24, 256x256,
    bf16, dy ~ N(0, 1e-2)), run twice to show the same bits, with K7's
    stashing forward at B=2 (against its plain version, and its output the
    same without the stash), with times, K8's and the stashing K7's device
    time per kernel (``stack_kernel``, ``wgrad_kernel``, ``dx_kernel``; K7's
    transpose and convs) and K8's dynamic shared memory (phase 2 prints
    their ptxas lines);
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
20. the fused hybrid step's ``torch.profiler`` breakdown (K7, K8's three
    kernels, AdamW and EMA, the rest) and idle share, with the HAT
    backbone, D and VGG timed alone at the step's shapes;
21. the fused-HAB training kernels' build lines (``ocab_train.cu``, built
    with phase 2's; K9a, K9b and K9c are entry points of ``hab_block.cu`` and
    ``swin_block_train.cu``, whose lines phases 2 and 7 print): ptxas
    registers and spills;
22. K9a (``hab_fwd_h``), K9b (``hab_bwd_mlp``), K9c (``hab_bwd_attn``),
    K10a (``ocab_fwd_h``) and K10b (``ocab_bwd_attn``) against their plain
    versions at the fused-HAB step's shapes (Bw=512: micro 2 of 128x128,
    C=90, 6 heads, hidden 360, bf16; K9 unshifted and shifted, drop-path
    scales that drop one of the two samples, K10 on a real overlap gather,
    dout ~ N(0, 1e-2)), K9a-c and K10b each run twice to show the same bits,
    with times, and K9c's device time per kernel (window kernel,
    weight-gradient products, column sums, weight packing) unshifted and
    shifted, and K10b's (window kernel, weight-gradient product, column
    sums);
23. the fused-HAB hybrid generator's gradients against fp32 autograd of the
    ``nn.Module`` on one patch, beside the bf16 ``nn.Module``'s own distance
    (with phase 17);
24. the fused-HAB training slice: ``cli.main train --arch hat --bf16
    --fused-hab`` for 2 epochs (warmup, GAN) of 2 steps of micro 2 x accum
    8, counting K9a/K9b/K9c/K10a/K10b launches (192, 224, 192, 32, 32 per
    step) and K7/K8 (288 each), then ``infer --arch hat --impl fused`` of the
    trained run;
25. patches/s and peak memory of the fused-HAB GAN step at micro 2 x accum
    8 and micro 8 x accum 2 (beside phase 19's fused step), and its
    ``torch.profiler`` idle share, device kernel launches per step and device
    time by kernel group (K9a, K9b, K9c, K10a, K10b, their products and
    column sums, K7, K8), failing if K13's ablation modes
    (``swin_stage_wg_kernel<``) ran;
26. K11 (``window_attention_nomask`` for K11a and K11c, one instantiation,
    and ``window_attention_masked`` for K11b) against its plain version in
    bf16 at the attention modules' shapes: SwinIR's (Bw=768, 6 heads, 64
    keys, head_dim 30), HAB's unshifted and shifted (Bw=2048, head_dim 15,
    the 256-window shift mask) and OCAB's (144 keys), on q, k, v that are
    views of one qkv tensor as the modules pass them (relative L2 <= 1e-3;
    the bf16 kernel gathers them in place, ``repacks`` stays 0),
    plus one fp32 case;
    the raise under autograd; per shape its time, bound, plain time and
    ``F.scaled_dot_product_attention``'s;
27. K12 (``fused_rdb``, the NHWC dense block) against its plain version at
    B=8, F=48, G=24, 256x256 bf16, and against K7 on the same data within
    K1's bound (K12 runs K7's conv kernels on K7's packing with x read in
    place: whether the two give the same bits is printed), with its time,
    plain time, device time per conv kernel and K7's time in the same run;
28. the attention modules with ``attn_impl="pallas"``: the config-#1 SwinIR
    ``nn.Module`` in bf16 at batch 3 (36 mask-less K11 launches a forward)
    and the config-#2 hybrid at batch 8 (16 mask-less, 4 of them its OCABs'
    as counted by forward hooks, and 12 masked), none of them repacking q,
    k or v, each against the fp32 ``"xla"`` module and with its patches/s
    beside the bf16
    ``"xla"`` module's (and the fused K1 forward's for SwinIR);
29. ``make_fused_hybrid(trunk_impl="kernel")`` at batch 8: 36 K12 launches
    a forward, agreement with the fp32 module, patches/s beside the default
    K7 trunk;
30. K4b (``swin_block_bwd``, the block's backward from x and dout with the
    forward recomputed, in three wgmma phases) at the flagship train shapes
    (Bw=2048, bf16, dout ~ N(0, 1e-2)) against its plain version and against
    K3 + K4 on K2's h (relative L2 per output), run twice to show the same
    bits, with its time beside K3 + K4's and the plain version's, K1 + K4b
    beside K2 + K3 + K4, its device time per kernel (each phase, the weight
    packings, products and column sums; no first-design kernel and none of
    K13's ablation modes), and its phases' ptxas registers, spills and
    shared memory;
31. the fused SwinIR GAN step with ``backward="recompute"`` (K1 forward,
    K4b backward): its bf16 gradients against fp32 autograd on one patch,
    its launches in one counted step (36 K1 and 36 K4b, no K2, K3 or K4),
    patches/s and peak memory at micro 8 x accum 1 alternated with
    ``backward="split"`` (split, recompute, recompute, split), and one
    recompute step's ``torch.profiler`` device time by kernel group (K1,
    K4b's three phases, the packings, the products and column sums), failing
    if a first-design kernel or K13's ablation modes ran;
32. K13 (``swin_stage_block``, the stage-ablation block: K1's wgmma kernel
    with a stage taken out or the activation swapped) in each of its nine
    modes, and ``mlp_polygelu`` with zero coefficients, on weights packed
    once, against its plain version (relative L2) on K1's operands and on
    the ablation tool's (Bw=2048, C=180, std 0.02 bf16), with K1's own
    distance to ``mlp_tanhgelu``'s plain version, ``mlp_tanhgelu`` bit for
    bit K1 (it launches K1's instantiation), ``allheads`` bit for bit
    ``full``'s and ``full`` packing on the call bit for bit ``full`` on
    weights packed once; on K1's operands the activations (erf, tanh,
    sigmoid, none, the zeroed polynomial) must lie further apart than the
    bound, so a swapped one fails; ``full``'s and ``mlp_tanhgelu``'s times
    beside K1's at Bw=2048 on weights packed once; then the tool
    (``tools/swin_stage_ablation.py``) over all nine modes: 36-block chains
    timed per mode;
33. [prep]: bench.py's synthetic registered sky (HR 2048² at 2e-4 deg/px,
    the observatory frame 512² at 4x the scale, made with the port's
    ``TanWCS``, ``write_fits`` and ``reproject_bilinear``) through
    ``fused_prep_target`` (stride 128, hr 512, lr 128: 169 pairs) twice on
    the card and once with ``device="cpu"``: the same pair names, raw FITS
    patches within 1e-5 and the same headers, TIFFs equal but for at most
    0.1% of pixels by 1 LSB, the HR stats identical and the LR stats within
    1e-6 relative; the card's pairs/s (the better of two) with the phase
    times the function logs, then ``cli.main split`` of the card's output
    (135/16/18, every pair once, every path there) and the staged
    ``extract_patches`` + ``normalize_target`` on the card with its pairs/s;
34. [upscale]: a seeded flagship SwinIR as ``checkpoints/best_gan_model.pth``
    and a 512 x 640 16-bit FITS star field (BZERO 32768) through ``cli.main
    upscale`` (2048 x 2560 out), then ``tiled_sr`` of the same normalized
    frame (35 tiles of 128 with overlap 16, 5 calls of 8) through the fp32
    ``nn.Module`` and ``make_fused_swinir`` (K1: 180 launches) and, for the
    config-#2 hybrid, the fp32 module, the bf16 module and
    ``make_fused_hybrid`` (K5/K6/K7: 120/20/180 launches), each fused output
    within PERF.md §2's bound of the fp32 module's (relative L2 <= 2e-2; the
    hybrid's max(2e-2, 2x the bf16 module's)), with wall time and tiles/s;
35. [dp-step]: the data-parallel steps (``make_*_train_step(mesh=)``, the
    batches staged by ``prefetch_to_mesh``) in an NCCL world of one (env://
    on localhost, as torchrun sets it), bit for bit the plain steps on the
    same seed and batches (G, D with its u/v, EMA, metrics; cuDNN
    deterministic for both): the flagship SwinIR split step (micro 8,
    K2/K3/K4) for two steps, the config-#4 hybrid step (micro 2 x accum 2,
    K7/K8) for a warm-up and a GAN step; then both kinds' ms a step on
    fresh batches, alternated;
36. [dp-train]: ``cli.main train --arch swin --bf16`` in that world, 1
    epoch of 2 steps on phase 10's split: 72 K2/K3/K4 launches each, rank
    0's checkpoints, ``metrics.csv`` and TensorBoard ``Metrics/PSNR``;
37. [spatial] (run by phase 34 on its frame): ``make_spatial_swinir``
    (flagship SwinIR) and ``make_spatial_hybrid`` (config #2) with
    ``attn_impl="pallas"`` on the whole 512 x 640 frame at one rank, within
    relative L2 1e-5 of the fp32 modules with ``attn_impl="pallas"``, 36
    K11a, and 16 K11a + 12 K11b launches, wall time and peak memory;
38. [upscale-mesh] (run by phase 34): ``upscale --mesh`` in an NCCL world
    of one writes the TIFF bits of ``upscale``; ``upscale --spatial``
    writes a frame of the right shape (its relative L2 to the tiled frame
    printed, without a bound). Each of phases 35-38 destroys its process
    group before it ends;
39. [run-loop]: the steps as the epoch loops drive them
    (``prefetch_to_mesh``, ``cli/trainers.py``'s ``_run_steps`` with its
    read of the step ``_RUNAHEAD_SYNC`` back, one ``_drain``): 16 flagship
    swin split steps (micro 8, K2/K3/K4) and 16 fused-HAB hybrid GAN steps
    (micro 2 x accum 8, K7/K8, K9a-c, K10a-b), after two warm-up steps each,
    under ``torch.cuda.set_sync_debug_mode("error")`` (off only around the
    loop's reads), with their launches, finite metrics and ms a step; each
    step's device idle share and host synchronizations per step in a
    ``torch.profiler`` trace (8 swin steps, 1 fused-HAB step); the NaN guard
    on the card (swin, micro 8 x accum 2): a D loss NaN on every micro-batch
    keeps G's and D's weights to the bit and D's (u, v) at the D phases'
    power iterations, a NaN G loss keeps G to the bit and gives D the bits
    of a finite step.
40. [learns]: ``tools/train_learns.py``'s synthetic skies (64 pairs at HR
    512, written by the native writer) and ``train --arch swin --bf16`` at
    full width for 2 epochs with a torchvision-layout VGG19 ``.pth`` made in
    the phase: every TIFF read decoded natively, 2 finite CSV rows, K2/K3/K4
    (and K1 in the EMA validation) launched, the codec's files/s; and
    ``SRVGGNetCompact()`` (128->512) on the card within relative L2 1e-4 of
    the CPU, fp32, TF32 off.
41. [remat]: the JAX package's rematerialization at full width, bf16, the
    variants of each case stepping one state in turns: the swin split step
    (micro 8 x 1, K2/K3/K4) and the hybrid K7/K8 step (micro 2 x 8 and
    8 x 2) with ``remat_loss`` off and on, the hybrid at 8 x 2 also with
    ``remat`` (its HAT RHAGs), and the bf16 SwinIR module step (fused off,
    micro 8) with ``remat`` off and on: after one step from the same start
    the plain variant's bits (cuDNN deterministic), then 5 timed steps a
    variant under ``torch.cuda.set_sync_debug_mode("error")``, their median
    ms (CUDA events), peak memory and launches a step; every rematerialized
    variant must peak lower. [d-learns]: ``UNetDiscriminatorSNHAT`` alone,
    40 steps of the hybrid step's D phase on synthetic HR against its LR
    nearest-upsampled, bf16 and fp32 (TF32 off), ``remat_loss`` off and on,
    its loss at steps 0, 10, 20 and 40; it fails where the bf16 D stalls
    near ln 2 while the fp32 D learns.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it fails at once:
the port has no CPU path here.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import importlib
import itertools
import json
import math
import os
import re
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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
# parameters of the backbone whose gradients phase 23 checks
HAB_CHECKED = [
    "hat.conv_first.weight",
    "hat.layers.0.residual_group.blocks.0.attn.qkv.weight",
    "hat.layers.0.residual_group.blocks.1.attn.relative_position_bias_table",
    "hat.layers.1.residual_group.blocks.3.mlp.fc2.weight",
    "hat.layers.2.residual_group.blocks.5.norm1.weight",
    "hat.layers.3.residual_group.overlap_attn.qkv.weight",
    "hat.layers.3.residual_group.overlap_attn.relative_position_bias_table",
    "hat.layers.3.residual_group.overlap_attn.mlp.fc1.weight",
    "conv_adapt.weight",
]
SOURCES = ["swin_block", "swin_block_train", "swin_block_bwd", "hab_block", "ocab", "rdb_cm",
           "rdb_cm_bwd", "ocab_train", "window_attention", "fused_rdb", "swin_stage_ablation"]
# K11 against its plain version, bf16 relative L2: both keep the Pallas
# rounding points (fp32 scores, bias and softmax; bf16 probabilities and
# output), so they differ only by fp32 summation order (about 5e-5 on the
# H100). A kernel that rounded the scores and bias to bf16, as the XLA path
# does, lands near SDPA's own distance (about 3e-3) and fails.
K11_REL_L2 = 1e-3
# K12 against its plain version, bf16 relative L2: bf16 x1..x4 and output,
# fp32 sums in another order
K12_REL_L2 = 2e-2
K11_FP32_TOL = 1e-5  # max |kernel - plain| in fp32: the same arithmetic reordered
# K13 against its plain version, bf16 relative L2: K1's arithmetic and
# rounding points, sums in another order. On K1's operands (u = fc1 of LN2
# about 0.6, where the activations part) the H100 read 1.0e-4..3.4e-4 per
# mode, on the first design and on the wgmma body alike, while the modes
# differ from one another by 8.0e-4 (erf against tanh GELU), 3.1e-3 (erf
# against sigmoid) and more: a mode that ran another activation, or a
# polygelu that lost its coefficients, fails
K13_REL_L2 = 5e-4
# clock cycles of kernel_split's edge kernels (torch.cuda._sleep): ~50 ms
SPIN_CYCLES = 100_000_000


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
        # the recompute backward's least work: qkv, the two attention
        # products, proj and fc1 forward, the 14 backward products; x and
        # dout in, dx out, the weights read and every gradient written once
        "K4b": (bw * (3 * qkv + 6 * attn + 3 * proj + 5 * mlp),
                3 * rows + w_attn + w_mlp + (w_attn + w_mlp) * 2 + 2 * heads * n * n * 4),
    }


def hat_work(bw: int = 2048, c: int = 90, heads: int = 6, hidden: int = 360, nk: int = 144,
             b: int = 8, b_train: int = HAT_MICRO, hw: int = 256 * 256, f: int = 48,
             g: int = 24, shifted_share: float = 0.5, bw_train: int = HAT_MICRO * 256) -> dict:
    """FLOPs and bytes of K5-K10 at the hybrid's shapes. K5: x and conv_x
    in, out (bf16), the weights, and the (256, 64, 64) fp32 mask for its
    shifted half of the calls; K6: x, q, out and the 144-key k and v
    windows, the weights and the bias; K7 (batch ``b``): x in and out, the
    weights. K8 (the train micro-batch ``b_train``): the least work is dx's
    transposed convs and dW, each one product per forward weight and pixel
    (2 x 269,568 FLOP a pixel at 48/24), with no recompute; x, dy in and dx
    out (bf16), the weights read (bf16), dW and db written (fp32). K9 and
    K10 at the train step's ``bw_train`` windows: K9a is K5 with h written;
    K9b and K9c count as K3 and K4 (the MLP's forward recomputed and its four
    backward products; qkv recomputed, its two backward products, proj's
    two, and six attention products), their windows read and written once,
    the weights read (bf16) and their gradients written (fp32), K9c's
    (heads, 64, 64) bias gradient and mask share; K10a is K6 with h written;
    K10b reads q, k, v, dh and writes dq, dk, dv (bf16) and the proj and
    bias gradients once, and does the scores, the attention output, da,
    dq, dk and dv products and do and dWproj."""
    n = 64
    hd = c // heads
    rows = bw * n * c * 2
    w_block = (3 * c * c + c * c + 2 * c * hidden) * 2
    mlp = 2 * 2 * n * c * hidden
    k5 = bw * (2 * n * c * 3 * c + 2 * 2 * n * n * hd * heads + 2 * n * c * c + mlp)
    k6 = bw * (2 * 2 * n * nk * c + 2 * n * c * c + mlp)
    bt = bw_train
    rows_t = bt * n * c * 2
    keys_t = bt * nk * c * 2
    w_attn, w_mlp = (3 * c * c + c * c) * 2, 2 * c * hidden * 2
    mask = shifted_share * 256 * n * n * 4
    per_pixel = sum(2 * 9 * (f + i * g) * (g if i < 4 else f) for i in range(5))
    w_rdb = sum(9 * (f + i * g) * (g if i < 4 else f) * 2 for i in range(5))
    return {
        "K5": (k5, 3 * rows + w_block + shifted_share * 256 * n * n * 4),
        "K6": (k6, 3 * rows + 2 * bw * nk * c * 2 + (c * c + 2 * c * hidden) * 2
               + heads * n * nk * 4),
        "K7": (b * hw * per_pixel, 2 * b * f * hw * 2 + w_rdb),
        "K8": (2 * b_train * hw * per_pixel,
               3 * b_train * f * hw * 2 + w_rdb + w_rdb * 2 + (4 * g + f) * 4),
        "K9a": (k5 // bw * bt, 4 * rows_t + w_block + mask + 2 * bt * 4),
        "K9b": (bt * 5 * mlp // 2, 3 * rows_t + w_mlp + w_mlp * 2 + bt * 4),
        "K9c": (bt * (3 * 2 * n * c * 3 * c + 2 * 2 * n * c * c + 6 * 2 * n * n * hd * heads),
                3 * rows_t + w_attn + w_attn * 2 + heads * n * n * 4 + mask + bt * 4),
        "K10a": (k6 // bw * bt, 4 * rows_t + 2 * keys_t + (c * c + 2 * c * hidden) * 2
                 + heads * n * nk * 4),
        "K10b": (bt * (6 * 2 * n * nk * c + 2 * 2 * n * c * c),
                 3 * rows_t + 4 * keys_t + c * c * 2 * 3 + heads * n * nk * 4 * 2),
    }


def least_ms(work: tuple) -> tuple[float, str]:
    """Least milliseconds for (flops, bytes) on the card, and what sets it."""
    t_ops, t_bytes = work[0] / PEAK_BF16_FLOPS * 1e3, work[1] / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def short_name(kernel: str) -> str:
    """A device kernel's name without its namespace, return type and arguments."""
    return kernel.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def split_rows(rows, calls: int) -> tuple[dict, dict, list]:
    """Device milliseconds per call by kernel name from the profiler's
    (name, device microseconds, launches recorded) rows over ``calls``
    calls, longest first; the launches by name; and the names whose count
    is not a whole multiple of ``calls``: a kernel launched the same number
    of times every call that records another count lost records, and its
    time per call would read low."""
    split, counts = {}, {}
    for name, us, n in rows:
        split[name] = split.get(name, 0.0) + us / 1e3 / calls
        counts[name] = counts.get(name, 0) + n
    lost = sorted(name for name, n in counts.items() if n % calls)
    return dict(sorted(split.items(), key=lambda kv: -kv[1])), counts, lost


def kernel_split(fn, calls: int = 10, tries: int = 3) -> dict:
    """Device milliseconds per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``calls`` calls after one untimed call
    (``split_rows``). The launches the profiler recorded, by kernel name,
    are left in ``kernel_split.counts``. A profile that lost records is
    taken again, ``tries`` profiles in all; then the phase fails.

    On the H100 profiles lost records: the first call's first kernels when
    recording started at once, and later in a long run those of whole
    calls. So each profile records its ``calls`` after a warm-up cycle of
    as many, between two spin kernels of ~50 ms that take any loss at the
    window's edges and are left out of the split."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up cycle, then the recorded one
                torch.cuda._sleep(SPIN_CYCLES)
                for _ in range(calls):
                    fn()
                torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
                prof.step()
        rows = []
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            if (t > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                    and "spin_kernel" not in e.key):
                rows.append((e.key, t, e.count))
        split, kernel_split.counts, lost = split_rows(rows, calls)
        if not lost:
            return split
    raise SystemExit(f"kernel_split: {tries} profiles of {calls} calls each lost launch records "
                     f"of {lost}: {kernel_split.counts}")


def group_split(ops: list, groups: dict, phase: str) -> dict:
    """Device ms per kernel group of ``device_profile``'s ops: a group sums
    the ops whose names match any of its regular expressions. A group that
    matches no device time fails the phase: its patterns no longer name
    the kernels it stands for."""
    split = {k: sum(t for name, t, _ in ops if any(re.search(p_, name) for p_ in pats))
             for k, pats in groups.items()}
    empty = {k: groups[k] for k, v in split.items() if not v > 0}
    if empty:
        raise SystemExit(f"[{phase}] kernel groups that matched no device time: {empty}")
    return split


def ptxas_stats(log_text: str, fragment: str) -> str:
    """ptxas's registers, spills and stack of the kernel whose mangled name
    contains ``fragment``, from a build log."""
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and fragment in line:
            stats = [x.strip().replace("ptxas info    : ", "") for x in lines[i + 1:i + 4]
                     if "spill" in x or "registers" in x]
            return "; ".join(stats)
    raise SystemExit(f"no ptxas statistics for {fragment} in the build log")


def device_busy(prof) -> tuple[float, float]:
    """The device's busy microseconds in a ``torch.profiler`` run (the union
    of its ops' intervals) and the span from its first op to its last. A
    ``record_function`` range also leaves a device-side annotation spanning
    its work, idle gaps included: those are not ops."""
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.name not in LOOP_RANGES)
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
    return busy, kernels[-1][1] - kernels[0][0]


def device_profile(fn, steps: int = 2) -> tuple[list, float, float]:
    """Device ops (name, ms per step, calls per step) of ``steps`` calls of
    ``fn``, longest first, the device's busy ms per step and its idle share
    of the kernels' span. The host's ops by self time, longest first, are
    left in ``device_profile.host`` (name, ms per step, calls per step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    busy, span = device_busy(prof)
    ops = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((e.key, t / 1e3 / steps, e.count // steps))
    ops.sort(key=lambda o: -o[1])
    device_profile.host = sorted(
        ((e.key, e.self_cpu_time_total / 1e3 / steps, e.count // steps)
         for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda o: -o[1])
    return ops, busy / 1e3 / steps, 1.0 - busy / span

def write_fits_u16(path: Path, counts: np.ndarray, header: dict) -> None:
    """A 16-bit FITS frame: BITPIX 16 with BZERO 32768, as cameras write them."""
    cards = {"SIMPLE": "T", "BITPIX": 16, "NAXIS": 2, "NAXIS1": counts.shape[1],
             "NAXIS2": counts.shape[0], "BZERO": 32768.0, "BSCALE": 1.0, **header}
    head = b"".join(
        f"{k:<8}= {v if not isinstance(v, str) or v == 'T' else repr(v):>20}".ljust(80).encode()
        for k, v in cards.items()) + b"END".ljust(80)
    body = (counts.astype(np.int32) - 32768).astype(">i2").tobytes()
    path.write_bytes(head + b" " * (-len(head) % 2880) + body + b"\0" * (-len(body) % 2880))


def prep_phase(seed: int, device: torch.device, card: str) -> None:
    """33. [prep]: fused dataset prep (BASELINE config #5) on the card against
    the same call on the CPU, ``split`` of its output, and the staged steps."""
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.data import load_manifest, read_tiff_u16
    from superresolution_def_tpu_torch.prep import (
        TanWCS, extract_patches, fused_prep_target, normalize_target, read_fits,
        reproject_bilinear, write_fits)

    size, scale = 2048, 2e-4  # bench.py's synthetic registered sky
    cut = dict(stride=128, hr_size=512, lr_size=128)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(seed)
        sky = (rng.random((size, size)) * 0.6 + 0.2).astype(np.float32)
        w_h = TanWCS((10.0, 20.0), (size / 2, size / 2), cdelt=[-scale, scale])
        w_o = TanWCS((10.0, 20.0), (size / 8, size / 8), cdelt=[-scale * 4, scale * 4])
        write_fits(root / "hub" / "reg_h.fits", sky, w_h.to_header())
        obs = np.nan_to_num(reproject_bilinear(sky, w_h, w_o, (size // 4, size // 4),
                                               device=device))
        write_fits(root / "obs" / "reg_o.fits", obs, w_o.to_header())

        runs = {}
        for name, dev in (("card0", device), ("card1", device), ("cpu", "cpu")):
            lines, stats = [], {}
            t0 = time.perf_counter()
            n = fused_prep_target(root / "hub", root / "obs", root / name / "6_patches_final",
                                  root / name / "7_dataset_ready_LOG", **cut, log=lines.append,
                                  device=dev, stats=stats)
            runs[name] = dict(n=n, s=time.perf_counter() - t0, stats=stats, log=lines)
        best = min(("card0", "card1"), key=lambda k: runs[k]["s"])
        r = runs[best]
        log("prep", f"fused_prep_target on {card}: {r['n']} pairs (HR 2048² at 2e-4 deg/px, "
                    f"obs 512², stride 128, hr 512, lr 128) in {r['s']:.3f} s = "
                    f"{r['n'] / r['s']:.3f} pairs/s, the better of two ({runs['card0']['s']:.3f}, "
                    f"{runs['card1']['s']:.3f} s); the same call on the CPU "
                    f"{runs['cpu']['s']:.3f} s = {runs['cpu']['n'] / runs['cpu']['s']:.3f} pairs/s")
        log("prep", "phases on the card (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["stats"]["phases"].items())
            + "; on the CPU: " + ", ".join(
                f"{k} {v:.4f}" for k, v in runs["cpu"]["stats"]["phases"].items()))
        for line in r["log"]:
            log("prep", f"  {line}")
        t0 = time.perf_counter()
        ops, busy_ms, idle = device_profile(lambda: fused_prep_target(
            root / "hub", root / "obs", root / "prof" / "6_patches_final",
            root / "prof" / "7_dataset_ready_LOG", **cut, log=lambda *a: None, device=device),
            steps=1)
        prof_ms = 1e3 * (time.perf_counter() - t0)
        log("prep", f"one profiled fused_prep_target: device busy {busy_ms:.3f} ms "
                    f"({busy_ms / (1e3 * r['s']):.2%} of the best unprofiled wall; the profiled "
                    f"run's wall {prof_ms:.1f} ms), idle share of the kernels' span "
                    f"{idle:.4f}; top device ops: " + "; ".join(
                        f"{name[:50]} {t:.3f} ms x{n}" for name, t, n in ops[:6]))

        card_dir, cpu_dir = root / best, root / "cpu"
        names = sorted(p.name for p in (card_dir / "7_dataset_ready_LOG").glob("pair_*"))
        same_names = (names == sorted(p.name for p in (cpu_dir / "7_dataset_ready_LOG")
                                      .glob("pair_*"))
                      == sorted(p.name for p in (card_dir / "6_patches_final").glob("pair_*")))
        fits_err, headers_same, n_px, n_diff, max_lsb = 0.0, True, 0, 0, 0
        for name in names:
            for f in ("hubble.fits", "observatory.fits"):
                a = read_fits(card_dir / "6_patches_final" / name / f)
                b = read_fits(cpu_dir / "6_patches_final" / name / f)
                fits_err = max(fits_err, float(np.abs(a.data - b.data).max()))
                headers_same &= a.header == b.header
            for f in ("hubble.tiff", "observatory.tiff"):
                a = read_tiff_u16(card_dir / "7_dataset_ready_LOG" / name / f).astype(np.int64)
                b = read_tiff_u16(cpu_dir / "7_dataset_ready_LOG" / name / f).astype(np.int64)
                d = np.abs(a - b)
                n_px, n_diff, max_lsb = n_px + d.size, n_diff + int((d > 0).sum()), max(
                    max_lsb, int(d.max()))
        hr_card, hr_cpu = r["stats"]["hr"], runs["cpu"]["stats"]["hr"]
        lr_card, lr_cpu = r["stats"]["lr"], runs["cpu"]["stats"]["lr"]
        lr_rel = max(abs(a - b) / abs(b) for a, b in zip(lr_card, lr_cpu))
        log("prep", f"card against CPU: {len(names)} pairs, names equal {same_names}; raw FITS "
                    f"max abs {fits_err:.3e} (bound 1e-5), headers equal {headers_same}; TIFF "
                    f"pixels differing {n_diff} of {n_px} ({n_diff / n_px:.3e}, bound 1e-3), "
                    f"by at most {max_lsb} LSB (bound 1); HR lo/hi {hr_card} vs {hr_cpu}; LR "
                    f"lo/hi {lr_card} vs {lr_cpu}, rel {lr_rel:.3e} (bound 1e-6)")
        if not (r["n"] == runs["cpu"]["n"] == len(names) == 169 and same_names and headers_same
                and fits_err <= 1e-5 and n_diff <= 1e-3 * n_px and max_lsb <= 1
                and hr_card == hr_cpu and lr_rel <= 1e-6):
            raise SystemExit("fused prep on the card disagrees with the CPU")

        counts = cli_main(["split", "--data-root", str(root), "--target", best])[best]
        splits = {k: load_manifest(card_dir / "8_dataset_split" / "splits_json" / f"{k}.json")
                  for k in ("train", "val", "test")}
        ids = sorted(e.patch_id for es in splits.values() for e in es)
        paths_ok = all(Path(p).exists() for es in splits.values() for e in es
                       for p in (e.hubble_path, e.ground_path))
        log("prep", f"split: {counts}, every pair once {ids == names}, paths exist {paths_ok}")
        if counts != {"train": 135, "val": 16, "test": 18} or ids != names or not paths_ok:
            raise SystemExit(f"split of the fused output is wrong: {counts}")

        quiet = dict(log=lambda *a: None, device=device)
        t0 = time.perf_counter()
        n3 = extract_patches(root / "hub", root / "obs", root / "staged" / "6_patches_final",
                             **cut, **quiet)
        t3 = time.perf_counter()
        n4 = normalize_target(root / "staged" / "6_patches_final",
                              root / "staged" / "7_dataset_ready_LOG", **quiet)
        t4 = time.perf_counter()
        log("prep", f"staged extract_patches + normalize_target on {card}: {n4} pairs in "
                    f"{t4 - t0:.3f} s = {n4 / (t4 - t0):.3f} pairs/s (step 3 {t3 - t0:.3f} s, "
                    f"step 4 {t4 - t3:.3f} s)")
        if not n3 == n4 == 169:
            raise SystemExit(f"staged prep wrote {n3} and {n4} pairs, not 169")


# the spatial forwards against the fp32 modules, relative L2: at one rank
# they differ only in how the 3x3 convs get their padding (a halo
# concatenated, or the conv's own), so cuDNN may pick other algorithms
SPATIAL_REL_L2 = 1e-5


@contextlib.contextmanager
def world_of_one():
    """torchrun's environment for a world of one process on card 0 (env://
    on a free localhost port): what ``initialize_distributed`` reads. Any
    process group left at the end is destroyed, and the environment restored."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           # NCCL's bootstrap on the loopback, unless the caller names an interface
           "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def state_bits(state) -> dict:
    """G, D (with its spectral u, v) and the EMA copy, on the host."""
    return {f"{part}.{k}": v.detach().cpu().clone() for part in ("g", "d", "ema")
            for k, v in getattr(state, part).state_dict().items()}


def dp_step_phase(seed: int, device: torch.device, card: str) -> None:
    """35. [dp-step]: the data-parallel GAN steps in an NCCL world of one,
    through ``prefetch_to_mesh``, bit for bit the plain steps on the same
    seed and batches: the flagship SwinIR split step (micro 8, bf16,
    K2/K3/K4) for two steps, and the config-#4 hybrid step (micro 2 x accum
    2, K7/K8) for one warm-up and one GAN step; then both kinds' step times
    on fresh batches, alternated (plain, DP, DP, plain)."""
    from superresolution_def_tpu_torch.kernels import (
        fused_rdb_cm, fused_rdb_cm_bwd, swin_block_bwd_attn, swin_block_bwd_mlp,
        swin_block_fwd_h)
    from superresolution_def_tpu_torch.parallel import (
        initialize_distributed, make_mesh, prefetch_to_mesh)
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss, VGG19Features, create_hat_train_state, create_swin_train_state,
        make_hat_train_step, make_swin_train_step)

    bgen = np.random.default_rng(seed + 40)

    def batches(micro, accum, n):
        return [{"lr": bgen.integers(0, 65535, (accum, micro, 128, 128, 1), dtype=np.uint16),
                 "hr": bgen.integers(0, 65535, (accum, micro, 512, 512, 1), dtype=np.uint16)}
                for _ in range(n)]

    def run(step, data, warmups, mesh):
        """The step on each batch (staged by ``prefetch_to_mesh`` with a
        mesh): its metrics and CUDA-event ms a step."""
        stream = (prefetch_to_mesh(iter(data), mesh) if mesh is not None
                  else contextlib.nullcontext((b, b) for b in data))
        metrics, ms = [], []
        with stream as pairs:
            for (_, b), warmup in zip(pairs, warmups):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                m = step(b, 1e-4, 1e-4, **({} if warmup is None else {"warmup": warmup}))
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                metrics.append({k: float(v) for k, v in m.items()})
        return metrics, ms

    # both runs must pick the same convolution algorithms, backward included
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with world_of_one():
            initialize_distributed("cuda")
            mesh = make_mesh()
            vgg = VGG19Features(35, dtype=torch.bfloat16).to(device).requires_grad_(False)
            cases = (
                ("swin", "micro 8, two GAN steps", MICRO, 1, (None, None),
                 (swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn), 36),
                ("hybrid", "micro 2 x accum 2, warm-up then GAN", HAT_MICRO, 2, (True, False),
                 (fused_rdb_cm, fused_rdb_cm_bwd), 36 * 2))
            for arch, desc, micro, accum, warmups, counters, per_step in cases:
                data = batches(micro, accum, len(warmups))
                kinds = {}
                for kind in ("plain", "dp"):
                    gen = torch.Generator().manual_seed(seed)
                    crit = CombinedGANLoss(pixel_weight=1.0,
                                           perceptual_weight=0.5 if arch == "swin" else 1.0,
                                           adversarial_weight=0.005, vgg_apply=vgg)
                    aug = torch.Generator().manual_seed(seed + 41)
                    dp = mesh if kind == "dp" else None
                    if arch == "swin":
                        state = create_swin_train_state(gen, dtype=torch.bfloat16, fused=True,
                                                        device=device)
                        step = make_swin_train_step(state, accum_steps=accum, criterion_g=crit,
                                                    generator=aug, mesh=dp)
                    else:
                        state = create_hat_train_state(gen, dtype=torch.bfloat16, fused=True,
                                                       device=device)
                        step = make_hat_train_step(
                            state, accum_steps=accum, criterion_g=crit, generator=aug,
                            drop_generator=torch.Generator(device).manual_seed(seed + 42),
                            mesh=dp)
                    for fn in counters:
                        fn.launches = 0
                    metrics, ms = run(step, data, warmups, dp)
                    kinds[kind] = (state, step, dp, metrics, ms, state_bits(state),
                                   {fn.__name__: fn.launches for fn in counters})
                (*_, m0, ms0, bits0, n0), (*_, m1, ms1, bits1, n1) = kinds["plain"], kinds["dp"]
                differ = [k for k, v in bits0.items() if not torch.equal(v, bits1[k])]
                want = {fn.__name__: per_step * len(data) for fn in counters}
                # the steps' times on fresh batches, alternated
                timed = {"plain": [], "dp": []}
                for kind in ("plain", "dp", "dp", "plain"):
                    _, step, dp, *_ = kinds[kind]
                    timed[kind] += run(step, batches(micro, accum, 2), (warmups[-1],) * 2, dp)[1]
                log("dp-step", f"{arch} ({desc}, bf16) on {card}: the DP step through "
                               f"prefetch_to_mesh in an NCCL world of one vs the plain step: "
                               f"G, D (u, v), EMA bit-identical: {not differ} ({len(differ)} "
                               f"of {len(bits0)} tensors differ); metrics identical: "
                               f"{m0 == m1}; checked steps' ms " + ", ".join(
                                   f"{a:.2f} (plain {b:.2f})" for a, b in zip(ms1, ms0))
                               + "; alternated, ms a step: DP " + ", ".join(
                                   f"{t:.2f}" for t in timed["dp"]) + " (median "
                               f"{statistics.median(timed['dp']):.2f}), plain " + ", ".join(
                                   f"{t:.2f}" for t in timed["plain"]) + " (median "
                               f"{statistics.median(timed['plain']):.2f}); launches dp {n1}, "
                               f"plain {n0}; last metrics {m1[-1]}")
                if differ or m0 != m1 or n0 != want or n1 != want:
                    raise SystemExit(f"[dp-step] {arch}: the DP step differs from the plain "
                                     f"step ({differ[:5]}, metrics {m0} vs {m1}) or launches "
                                     f"{n1}/{n0} != {want}")
                del kinds
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic


def read_scalars(path: Path, tag: str) -> list[tuple[int, float]]:
    """(step, value) of every ``tag`` scalar in a TensorBoard event file,
    the framing's CRCs checked."""
    from superresolution_def_tpu_torch.obs.tbevents import _masked_crc

    raw, off, out = path.read_bytes(), 0, []
    while off < len(raw):
        (length,) = struct.unpack_from("<Q", raw, off)
        data = raw[off + 12:off + 12 + length]
        crcs = struct.unpack_from("<I", raw, off + 8) + struct.unpack_from("<I", raw,
                                                                            off + 12 + length)
        if crcs != (_masked_crc(raw[off:off + 8]), _masked_crc(data)):
            raise SystemExit(f"{path}: a record's CRC does not match")
        at = data.find(tag.encode())
        if at >= 0:  # Event field 2 (step) follows the wall time; Value field 2 the float
            out.append((data[10], struct.unpack_from("<f", data, at + len(tag) + 1)[0]))
        off += 12 + length + 4
    return out


def dp_train_phase(seed: int, device: torch.device, card: str) -> None:
    """36. [dp-train]: ``train --arch swin --bf16`` in an NCCL world of one,
    1 epoch of 2 steps (micro 8) on phase 10's synthetic split: K2/K3/K4
    launches (36 each a step) and rank 0's artifacts, the TensorBoard
    event file's ``Metrics/PSNR`` among them."""
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.kernels import (
        swin_block_bwd_attn, swin_block_bwd_mlp, swin_block_fwd_h)

    counters = (swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed + 4),
                    {"train": TRAIN_PAIRS, "val": VAL_PAIRS})
        for fn in counters:
            fn.launches = 0
        with world_of_one():
            t0 = time.perf_counter()
            last = cli_main(["train", "--arch", "swin", "--target", "T1", "--bf16",
                             "--batch-size", str(MICRO), "--accum-steps", "1", "--epochs", "1",
                             "--data-root", str(root / "data"),
                             "--outputs-root", str(root / "outputs"), "--seed", str(seed)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        run = root / "outputs" / "T1_DDP_SwinIR"
        rows = (run / "metrics.csv").read_text().strip().splitlines()[1:]
        events = sorted((run / "tensorboard").glob("events.out.tfevents.*"))
        psnr = read_scalars(events[0], "Metrics/PSNR") if events else []
        ckpts = sorted(p.name for p in (run / "checkpoints").glob("*.pth"))
        steps = TRAIN_PAIRS // MICRO
        log("dp-train", f"train --bf16 in an NCCL world of one, micro {MICRO}, 1 epoch x "
                        f"{steps} steps on {card}: loss_g={last['loss_g']:.5f} "
                        f"loss_d={last['loss_d']:.5f} val PSNR={last['psnr']:.4f} dB, "
                        f"{wall:.2f} s wall; launches " + ", ".join(
                            f"{k} {v}" for k, v in launches.items())
                        + f"; rank 0 wrote {ckpts}, metrics.csv rows {len(rows)}, "
                        f"TensorBoard Metrics/PSNR {psnr}")
        if any(n != 36 * steps for n in launches.values()):
            raise SystemExit(f"[dp-train] expected {36 * steps} launches each, counted {launches}")
        if (ckpts != ["best_gan_model.pth", "latest_checkpoint.pth"] or len(rows) != 1
                or len(psnr) != 1 or psnr[0][0] != 1
                or abs(psnr[0][1] - last["psnr"]) > 1e-4 * abs(last["psnr"])
                or not np.isfinite([last["loss_g"], last["loss_d"]]).all()):
            raise SystemExit(f"[dp-train] artifacts: checkpoints {ckpts}, csv rows {len(rows)}, "
                             f"Metrics/PSNR {psnr} vs {last['psnr']}, losses {last}")


# [run-loop]: steps a loop runs under the sync check, and the runtime calls
# that make the host wait for the device (``cudaMemcpy`` is the blocking copy)
RUN_LOOP_STEPS = 16
# its record_function ranges: a step, the loop's run-ahead read, the drain
LOOP_RANGES = ("step", "run-ahead read", "drain")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def loop_syncs(prof, reads: int) -> tuple[int, int]:
    """Host synchronizations of a profiled loop's steps: the synchronizing
    runtime calls inside its ``step`` ranges, and the device-to-host copies
    less the loop's own (one for each of its ``reads`` run-ahead reads, one
    for the drain)."""
    events = list(prof.events())
    steps = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == "step" and e.device_type == torch.autograd.DeviceType.CPU]
    calls = sum(e.name in SYNC_CALLS and any(a <= e.time_range.start <= b for a, b in steps)
                for e in events)
    copies = sum(e.device_type == torch.autograd.DeviceType.CUDA and "DtoH" in e.name
                 and not getattr(e, "is_user_annotation", False) for e in events)
    return calls, copies - reads - 1


def run_loop_phase(seed: int, device: torch.device, card: str) -> None:
    """39. [run-loop]: the epoch loops' steps as ``cli/trainers.py`` drives
    them (``prefetch_to_mesh``, ``_run_steps`` with its read of the step
    ``_RUNAHEAD_SYNC`` back, ``_drain``). (a) After two warm-up steps, 16
    flagship swin split steps (micro 8, bf16, K2/K3/K4) and 16 fused-HAB
    hybrid GAN steps (micro 2 x accum 8, K7/K8, K9a-c, K10a-b) under
    ``torch.cuda.set_sync_debug_mode("error")``, off only around the loop's
    run-ahead reads: a step that makes the host wait raises. Their launches,
    their metrics (finite, every micro-batch valid) and CUDA-event ms a step.
    (b) The NaN guard on the card, on fresh swin states at micro 8 x accum 2
    with cuDNN deterministic: a D loss that is NaN on every micro-batch
    leaves ``valid_batches`` 0, G and D's ``weight_orig`` their bits and
    D's (u, v) where the D phases' power iterations take them (four, from
    the start); a NaN G loss leaves G its bits and D the bits of a finite
    step on the same batch (D's window and (u, v) kept). (c) Each step's
    device idle share and host synchronizations per step (synchronizing
    runtime calls and device-to-host copies in the ``torch.profiler``
    trace, the loop's own reads apart), over 8 swin steps and 1 fused-HAB step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from superresolution_def_tpu_torch.cli import trainers
    from superresolution_def_tpu_torch.kernels import (
        fused_rdb_cm, fused_rdb_cm_bwd, hab_bwd_attn, hab_bwd_mlp, hab_fwd_h, ocab_bwd_attn,
        ocab_fwd_h, swin_block_bwd_attn, swin_block_bwd_mlp, swin_block_fwd_h)
    from superresolution_def_tpu_torch.models.spectral_norm import SNConv2d, _l2norm
    from superresolution_def_tpu_torch.parallel import make_mesh, prefetch_to_mesh
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss, DiscriminatorLoss, VGG19Features, create_hat_train_state,
        create_swin_train_state, make_hat_train_step, make_swin_train_step)

    mesh = make_mesh(device)
    bgen = np.random.default_rng(seed + 50)
    vgg = VGG19Features(35, dtype=torch.bfloat16).to(device).requires_grad_(False)

    def batches(micro, accum, n):
        return [{"lr": bgen.integers(0, 65535, (accum, micro, 128, 128, 1), dtype=np.uint16),
                 "hr": bgen.integers(0, 65535, (accum, micro, 512, 512, 1), dtype=np.uint16)}
                for _ in range(n)]

    def swin(crit_d=None, crit_g=None, accum=1):
        state = create_swin_train_state(torch.Generator().manual_seed(seed),
                                        dtype=torch.bfloat16, fused=True, device=device)
        crit_g = crit_g or CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                           adversarial_weight=0.005, vgg_apply=vgg)
        return state, make_swin_train_step(state, accum_steps=accum, criterion_g=crit_g,
                                           criterion_d=crit_d,
                                           generator=torch.Generator().manual_seed(seed + 51))

    def hybrid():
        state = create_hat_train_state(torch.Generator().manual_seed(seed),
                                       dtype=torch.bfloat16, fused=True, fused_hab=True,
                                       device=device)
        return state, make_hat_train_step(
            state, accum_steps=HAT_ACCUM, criterion_g=CombinedGANLoss(
                pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005,
                vgg_apply=vgg), generator=torch.Generator().manual_seed(seed + 52),
            drop_generator=torch.Generator(device).manual_seed(seed + 53))

    wait = trainers._wait_for

    def loop(step, data, *args, sync_mode=0, **kwargs):
        """``step`` on ``data`` as the trainers' loop runs it, the sync debug
        mode ``sync_mode`` inside the steps and off around the loop's reads."""
        def read(value):
            torch.cuda.set_sync_debug_mode(0)
            try:
                with record_function("run-ahead read"):
                    return wait(value)
            finally:
                torch.cuda.set_sync_debug_mode(sync_mode)

        def traced(*a, **k):
            with record_function("step"):
                return step(*a, **k)

        trainers._wait_for = read
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            with prefetch_to_mesh(iter(data), mesh) as stream:
                metrics, _ = trainers._run_steps(stream, traced, None, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            trainers._wait_for = wait
        return metrics

    kinds = (
        ("swin split", swin, MICRO, 1, (), 8,
         {swin_block_fwd_h: 36, swin_block_bwd_mlp: 36, swin_block_bwd_attn: 36}),
        ("fused-HAB", hybrid, HAT_MICRO, HAT_ACCUM, (False,), 1,
         {hab_fwd_h: 192, hab_bwd_mlp: 224, hab_bwd_attn: 192, ocab_fwd_h: 32,
          ocab_bwd_attn: 32, fused_rdb_cm: 288, fused_rdb_cm_bwd: 288}))
    for name, make, micro, accum, warmup, profiled, per_step in kinds:
        t_kind = time.perf_counter()
        state, step = make()
        loop(step, batches(micro, accum, 2), 1e-4, 1e-4, *warmup)  # packing, cached tables
        torch.cuda.synchronize()
        for fn in per_step:
            fn.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        data = batches(micro, accum, RUN_LOOP_STEPS)
        t0 = time.perf_counter()
        start.record()
        metrics = loop(step, data, 1e-4, 1e-4, *warmup, sync_mode="error")
        end.record()
        rows = trainers._drain(metrics, list(metrics[0]))
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in per_step}
        want = {fn.__name__: n * RUN_LOOP_STEPS for fn, n in per_step.items()}
        ms = start.elapsed_time(end) / RUN_LOOP_STEPS
        # (c) one profiled run: the device's idle share, the host's waits
        data = batches(micro, accum, profiled)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_metrics = loop(step, data, 1e-4, 1e-4, *warmup)
            with record_function("drain"):
                trainers._drain(prof_metrics, list(prof_metrics[0]))
        busy, span = device_busy(prof)
        reads = profiled // trainers._RUNAHEAD_SYNC
        calls, copies = loop_syncs(prof, reads)
        log("run-loop", f"{name} step on {card}: {RUN_LOOP_STEPS} steps as the loop drives "
                        f"them under set_sync_debug_mode('error'), no synchronizing call; "
                        f"{ms:.2f} ms a step (CUDA events), host wall "
                        f"{1e3 * wall / RUN_LOOP_STEPS:.2f} ms a step with the drain; "
                        f"launches {launches}; first and last "
                        f"metrics {rows[0]}, {rows[-1]}; profiled over {profiled} steps: busy "
                        f"{busy / 1e3 / profiled:.3f} ms a step, idle "
                        f"{100 * (1 - busy / span):.2f}%, host synchronizations a step inside "
                        f"the steps: "
                        f"{calls / profiled:.3f} synchronizing calls, {copies / profiled:.3f} "
                        f"device-to-host copies beside the loop's {reads} run-ahead read(s) "
                        f"and drain; {time.perf_counter() - t_kind:.1f} s for this kind")
        finite = np.isfinite(rows).all()
        valid = name != "swin split" or all(r[list(metrics[0]).index("valid_batches")] == accum
                                             for r in rows)
        if launches != want or not finite or not valid or calls or copies:
            raise SystemExit(f"[run-loop] {name}: launches {launches} (want {want}), metrics "
                             f"finite {finite}, every micro-batch valid {valid}, the profiled "
                             f"steps' synchronizing calls {calls} and device-to-host copies "
                             f"{copies} (want 0)")
        del state, step, metrics, prof
        torch.cuda.empty_cache()

    # (b) the guard on the card: NaN times the loss sends NaN gradients in,
    # which only a select drops
    class NaNDLoss(DiscriminatorLoss):
        def __call__(self, real_pred, fake_pred):
            loss, parts = super().__call__(real_pred, fake_pred)
            return loss * float("nan"), parts

    class NaNGLoss(CombinedGANLoss):
        def __call__(self, *args):
            loss, parts = super().__call__(*args)
            return loss * float("nan"), parts

    def snapshot(state):
        return ({k: v.clone() for k, v in state.g.state_dict().items()},
                {k: v.clone() for k, v in state.d.state_dict().items()})

    accum = 2
    data = batches(MICRO, accum, 1)[0]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_step = swin(accum=accum)
        ref_step(data, 1e-4, 1e-4)
        _, d_finite = snapshot(ref)
        del ref, ref_step
        results = {}
        for case in ("D", "G"):
            state, step = swin(crit_d=NaNDLoss() if case == "D" else None,
                               crit_g=NaNGLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                               adversarial_weight=0.005, vgg_apply=vgg)
                               if case == "G" else None, accum=accum)
            g0, d0 = snapshot(state)
            # where the D phases alone take (u, v): two power iterations a micro-batch
            uv = {}
            with torch.no_grad():
                for mname, m in state.d.named_modules():
                    if isinstance(m, SNConv2d):
                        w2d, u = m.weight_mat(), m.weight_u
                        for _ in range(2 * accum):
                            v = _l2norm(w2d.T @ u)
                            u = _l2norm(w2d @ v)
                        uv[f"{mname}.weight_u"], uv[f"{mname}.weight_v"] = u, v
            m = {k: float(v) for k, v in step(data, 1e-4, 1e-4).items()}
            g1, d1 = snapshot(state)
            g_kept = all(torch.equal(v, g0[k]) for k, v in g1.items())
            if case == "D":
                w_kept = all(torch.equal(v, d0[k]) for k, v in d1.items()
                             if k.endswith("weight_orig"))
                uv_diff = max(float((d1[k] - v).abs().max()) for k, v in uv.items())
                uv_bits = all(torch.equal(d1[k], v) for k, v in uv.items())
                ok = m["valid_batches"] == 0 and g_kept and w_kept and uv_bits
                results[case] = (f"valid {m['valid_batches']}, G bits kept {g_kept}, D "
                                 f"weight_orig bits kept {w_kept}, (u, v) the D phases' bits "
                                 f"{uv_bits} (max |diff| {uv_diff:.3e})")
            else:
                d_same = [k for k, v in d1.items() if not torch.equal(v, d_finite[k])]
                d_moved = any(not torch.equal(v, d0[k]) for k, v in d1.items()
                              if k.endswith("weight_orig"))
                ok = m["valid_batches"] == 0 and g_kept and not d_same and d_moved
                results[case] = (f"valid {m['valid_batches']}, G bits kept {g_kept}, D (weights, "
                                 f"u, v) the bits of the finite step {not d_same} "
                                 f"({len(d_same)} tensors differ), D moved {d_moved}")
            if not ok:
                raise SystemExit(f"[run-loop] {case}-NaN guard on the card: {results[case]}")
            del state, step
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("run-loop", f"NaN guard on {card} (flagship swin split step, micro {MICRO} x accum "
                    f"{accum}, every micro-batch NaN): D-NaN: {results['D']}; G-NaN: "
                    f"{results['G']}")
    torch.cuda.empty_cache()


def spatial_phase(device: torch.device, card: str, img01: np.ndarray, swinir, hybrid) -> None:
    """37. [spatial]: ``make_spatial_swinir`` (the flagship SwinIR) and
    ``make_spatial_hybrid`` (config #2) with ``attn_impl="pallas"`` on the
    whole [upscale] frame in an NCCL world of one, against the fp32 module
    forward with ``attn_impl="pallas"``, and their K11 launches."""
    from superresolution_def_tpu_torch.kernels.window_attention import (
        window_attention_masked, window_attention_nomask)
    from superresolution_def_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_spatial_hybrid, make_spatial_swinir)

    counters = (window_attention_nomask, window_attention_masked)
    x = torch.from_numpy(np.ascontiguousarray(img01[None, :, :, None])).to(device)
    with world_of_one():
        initialize_distributed("cuda")
        mesh = make_mesh()
        for arch, net, make, want in (
                ("SwinIR", swinir, make_spatial_swinir, (36, 0)),
                ("hybrid", hybrid, make_spatial_hybrid, (16, 12))):
            net = copy.deepcopy(net).to(device).eval()
            for m in net.modules():
                if hasattr(m, "attn_impl"):
                    m.attn_impl = "pallas"
            fn = make(mesh, net, attn_impl="pallas")
            with torch.no_grad():
                dense = net(x)
            torch.cuda.synchronize()
            for f in counters:
                f.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got = fn(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            launches = tuple(f.launches for f in counters)
            rel = float((got - dense).norm() / dense.norm())
            max_abs = float((got - dense).abs().max())
            log("spatial", f"{arch} fp32, attn_impl=pallas, the {img01.shape[0]}x"
                           f"{img01.shape[1]} frame H-sharded over an NCCL world of one on "
                           f"{card}: rel L2 to the module {rel:.3e} (bound {SPATIAL_REL_L2:.0e}),"
                           f" max |diff| {max_abs:.3e}, {wall:.3f} s wall, peak {peak:.2f} GB; "
                           f"K11a {launches[0]}, K11b {launches[1]} launches")
            if not (rel <= SPATIAL_REL_L2 and launches == want and torch.isfinite(got).all()
                    and got.shape == (1, 4 * img01.shape[0], 4 * img01.shape[1], 1)):
                raise SystemExit(f"[spatial] {arch}: rel L2 {rel} > {SPATIAL_REL_L2}, launches "
                                 f"{launches} != {want} or shape {tuple(got.shape)}")
            del net, fn, dense, got
            torch.cuda.empty_cache()


def upscale_mesh_phase(frame: Path, run: Path, sr_cli: np.ndarray, card: str) -> None:
    """38. [upscale-mesh]: ``upscale --mesh`` in an NCCL world of one writes
    the TIFF bits of ``upscale`` without it; ``upscale --spatial`` writes a
    frame of the right shape (its distance to the tiled frame has no bound:
    tile blending differs at the seams)."""
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.data import read_tiff_u16

    out, wall = {}, {}
    for flag in ("--mesh", "--spatial"):
        with world_of_one():
            t0 = time.perf_counter()
            res = cli_main(["upscale", str(frame), "--folder", str(run), flag,
                            "--out", str(run / f"sr{flag[1:]}.tiff")])
            wall[flag] = time.perf_counter() - t0
        out[flag] = read_tiff_u16(res["out"])
    same = np.array_equal(out["--mesh"], sr_cli)
    rel = float(np.linalg.norm(out["--spatial"].astype(np.float64) - sr_cli)
                / np.linalg.norm(sr_cli.astype(np.float64)))
    log("upscale-mesh", f"on {card}: upscale --mesh (NCCL world of one) {wall['--mesh']:.2f} s "
                        f"wall, the TIFF bits of upscale: {same}; upscale --spatial "
                        f"{wall['--spatial']:.2f} s wall, {out['--spatial'].shape}, rel L2 to "
                        f"the tiled frame {rel:.3e} (no bound: the tiles' seams)")
    if not same or out["--spatial"].shape != sr_cli.shape or out["--spatial"].std() == 0:
        raise SystemExit(f"[upscale-mesh] --mesh bits equal {same}, --spatial shape "
                         f"{out['--spatial'].shape} std {out['--spatial'].std()}")



# [learns]: the convergence path of tools/train_learns.py, cut to 2 epochs of
# a 64-pair synthetic split (51/6/7), and SRVGGNetCompact's forward
LEARNS_PAIRS, LEARNS_EPOCHS = 64, 2
# SRVGGNetCompact on the card against the CPU, fp32 with TF32 off: 18 convs
# in other summation orders
SRVGG_REL_L2 = 1e-4


def learns_phase(seed: int, device: torch.device, card: str) -> None:
    """40. [learns]: ``tools/train_learns.py``'s dataset (64 synthetic skies
    at HR 512, written by the native writer, the seed-42 split) and
    ``train_swin_run`` at full width for 2 epochs, bf16, fused, its
    ``vgg_weights`` a torchvision-layout ``.pth`` saved here from a seeded
    ``VGG19Features`` (nothing is downloaded). It fails unless every TIFF the
    iterators read was decoded natively (the codec's count against the files
    the epochs read), the CSV has 2 rows of finite metrics, and K2, K3, K4
    (36 a step) and K1 (36 an EMA validation forward) launched. It prints
    both epochs' PSNR, the wall time and the codec's decode rate (files/s,
    warm). Then one ``SRVGGNetCompact()`` forward at its defaults (64
    features, 16 convs, 128 -> 512) on the card against the same weights on
    the CPU, fp32 with TF32 off: relative L2 <= ``SRVGG_REL_L2``."""
    from superresolution_def_tpu_torch.cli.trainers import SwinTrainConfig, train_swin_run
    from superresolution_def_tpu_torch.data import fast_tiff, load_manifest
    from superresolution_def_tpu_torch.kernels import (
        fused_swin_block, swin_block_bwd_attn, swin_block_bwd_mlp, swin_block_fwd_h)
    from superresolution_def_tpu_torch.models import SRVGGNetCompact
    from superresolution_def_tpu_torch.tools.train_learns import build_dataset
    from superresolution_def_tpu_torch.train import VGG19Features

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        build_dataset(root / "data", n_pairs=LEARNS_PAIRS, seed=seed, hr_size=512)
        t_data = time.perf_counter() - t_phase
        torch.save(VGG19Features(generator=torch.Generator().manual_seed(seed + 5)).state_dict(),
                   root / "vgg19.pth")
        split = {k: load_manifest(root / "data" / "SYN" / "8_dataset_split" / "splits_json"
                                  / f"{k}.json") for k in ("train", "val")}
        steps = len(split["train"]) // MICRO
        # each epoch: its train batches (drop_last) and the whole val split, 2 files a pair
        files = 2 * LEARNS_EPOCHS * (steps * MICRO + len(split["val"]))
        counters = (swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn, fused_swin_block)
        for fn in counters:
            fn.launches = 0
        fast_tiff.decoded = 0
        t0 = time.perf_counter()
        last = train_swin_run(SwinTrainConfig(
            targets=("SYN",), data_root=str(root / "data"), outputs_root=str(root / "out"),
            epochs=LEARNS_EPOCHS, use_bf16=True, vgg_weights=str(root / "vgg19.pth"),
            seed=seed, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        decoded = fast_tiff.decoded
        launches = {fn.__name__: fn.launches for fn in counters}
        rows = (root / "out" / "SYN_DDP_SwinIR" / "metrics.csv").read_text().strip().splitlines()
        values = [[float(v) for v in r.split(",")] for r in rows[1:]]
        paths = [p for e in split["train"] for p in (e.hubble_path, e.ground_path)]
        fast_tiff.read_batch_u16(paths[::2], 512, 512)  # warm: the run read them all
        t0 = time.perf_counter()
        for _ in range(3):
            fast_tiff.read_batch_u16(paths[::2], 512, 512)
            fast_tiff.read_batch_u16(paths[1::2], 128, 128)
        rate = 3 * len(paths) / (time.perf_counter() - t0)
    psnr = [v[3] for v in values]
    log("learns", f"tools/train_learns.py's data: {LEARNS_PAIRS} skies at HR 512 "
                  f"({len(split['train'])}/{len(split['val'])} train/val) in {t_data:.2f} s; "
                  f"train --bf16 fused with a torchvision-layout VGG19 .pth on {card}, "
                  f"{LEARNS_EPOCHS} epochs x {steps} steps (micro {MICRO}): val PSNR by epoch "
                  f"{psnr}, loss_g {last['loss_g']:.5f}, {wall:.2f} s wall; launches "
                  + ", ".join(f"{k} {v}" for k, v in launches.items())
                  + f"; native decodes {decoded} of {files} files read; the codec reads "
                  f"{rate:.1f} files/s (8 threads, warm, 512² and 128² files)")
    want = {"swin_block_fwd_h": 36 * steps * LEARNS_EPOCHS,
            "swin_block_bwd_mlp": 36 * steps * LEARNS_EPOCHS,
            "swin_block_bwd_attn": 36 * steps * LEARNS_EPOCHS,
            "fused_swin_block": 36 * len(split["val"]) * LEARNS_EPOCHS}
    if decoded != files:
        raise SystemExit(f"[learns] {decoded} native decodes, {files} files read")
    if len(values) != LEARNS_EPOCHS or not np.isfinite(values).all():
        raise SystemExit(f"[learns] metrics.csv: {rows}")
    if launches != want:
        raise SystemExit(f"[learns] launches {launches}, expected {want}")

    srvgg = SRVGGNetCompact(generator=torch.Generator().manual_seed(seed)).eval()
    x = torch.rand(1, 128, 128, 3, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want_sr = srvgg(x)
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            on_card, x_card = srvgg.to(device), x.to(device)
            got = on_card(x_card)
            srvgg_ms = cuda_ms(lambda: on_card(x_card), reps=5, calls=2)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rel = rel_l2(got.cpu(), want_sr)
    log("learns", f"SRVGGNetCompact() (64 features, 16 convs, prelu) 128->512 on {card}: "
                  f"shape {tuple(got.shape)}, relative L2 to the CPU {rel:.3e} (bound "
                  f"{SRVGG_REL_L2}, fp32, TF32 off), {srvgg_ms:.3f} ms a forward; the phase "
                  f"{time.perf_counter() - t_phase:.1f} s")
    if tuple(got.shape) != (1, 512, 512, 3) or not rel <= SRVGG_REL_L2:
        raise SystemExit(f"[learns] SRVGGNetCompact on the card: rel L2 {rel}")


# [remat]: timed steps a variant after its first (the bits' step, also its
# warm-up), alternated over the variants; [d-learns]: D-alone steps, and the
# steps whose D loss it prints
REMAT_TIMED = 5
D_LEARNS_STEPS, D_LEARNS_READ = 40, (0, 10, 20, 40)


def remat_phase(seed: int, device: torch.device, card: str) -> None:
    """41. [remat]: the JAX package's rematerialization on the card, full
    width, bf16, every variant of a case stepping one state in turns: the
    flagship swin split step (micro 8 x 1, K2/K3/K4) and the config-#4
    hybrid K7/K8 step (micro 2 x 8 and 8 x 2) with ``remat_loss`` off and
    on, the hybrid at 8 x 2 also with ``remat`` (its HAT RHAGs around the
    trunk), and the bf16 SwinIR module step (``fused=False``, micro 8) with
    ``remat`` off and on. For each variant: the parameters, (u, v) and EMA
    after one step from the same start, cuDNN deterministic, the bits of
    the plain variant's (each variant's warm-up); then ``REMAT_TIMED`` steps
    a variant, alternated
    (CUDA events, median), each under ``torch.cuda.set_sync_debug_mode(
    "error")`` on batches staged on the card, its peak memory
    (``reset_peak_memory_stats`` before each step) and its kernel launches
    a step. It fails unless every rematerialized variant peaks lower than
    the plain one, gives its bits, launches the plain step's kernels as
    often (36 K2/K3/K4, 288 or 72 K7/K8 a step) and finite metrics. Then
    [d-learns] (:func:`d_learns`)."""
    from superresolution_def_tpu_torch.kernels import (
        fused_rdb_cm, fused_rdb_cm_bwd, swin_block_bwd_attn, swin_block_bwd_mlp, swin_block_fwd_h)
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss, VGG19Features, create_hat_train_state, create_swin_train_state,
        make_hat_train_step, make_swin_train_step)

    t_phase = time.perf_counter()
    bgen = np.random.default_rng(seed + 60)
    vgg = VGG19Features(35, dtype=torch.bfloat16).to(device).requires_grad_(False)
    swin_k = (swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn)
    hat_k = (fused_rdb_cm, fused_rdb_cm_bwd)

    def batch(micro, accum):
        """A batch staged on the card as int16 bits, as ``prefetch_to_mesh``
        leaves it: no upload inside the step."""
        return {k: torch.from_numpy(bgen.integers(0, 65535, (accum, micro, n, n, 1),
                                                  dtype=np.uint16).view(np.int16)).to(device)
                for k, n in (("lr", 128), ("hr", 512))}

    def swin(fused):
        state = create_swin_train_state(torch.Generator().manual_seed(seed),
                                        dtype=torch.bfloat16, fused=fused, device=device)
        gens = [torch.Generator().manual_seed(seed + 61)]
        crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                               adversarial_weight=0.005, vgg_apply=vgg)
        steps = {flag: make_swin_train_step(state, accum_steps=1, criterion_g=crit,
                                            generator=gens[0], remat_loss=flag)
                 for flag in (False, True)}
        return state, gens, steps, state.g, ()

    def hybrid(accum):
        state = create_hat_train_state(torch.Generator().manual_seed(seed),
                                       dtype=torch.bfloat16, fused=True, device=device)
        gens = [torch.Generator().manual_seed(seed + 62),
                torch.Generator(device).manual_seed(seed + 63)]
        crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=1.0,
                               adversarial_weight=0.005, vgg_apply=vgg)
        steps = {flag: make_hat_train_step(state, accum_steps=accum, criterion_g=crit,
                                           generator=gens[0], drop_generator=gens[1],
                                           remat_loss=flag)
                 for flag in (False, True)}
        return state, gens, steps, state.g.hat, (False,)

    cases = (
        ("swin split step, micro 8 x 1", lambda: swin(True), MICRO, 1,
         ("plain", "remat_loss"), dict.fromkeys(swin_k, 36)),
        ("hybrid K7/K8 step, micro 2 x 8", lambda: hybrid(HAT_ACCUM), HAT_MICRO, HAT_ACCUM,
         ("plain", "remat_loss"), dict.fromkeys(hat_k, 36 * HAT_ACCUM)),
        ("hybrid K7/K8 step, micro 8 x 2", lambda: hybrid(2), 8, 2,
         ("plain", "remat_loss", "remat"), dict.fromkeys(hat_k, 36 * 2)),
        ("SwinIR module step (fused off), micro 8 x 1", lambda: swin(False), MICRO, 1,
         ("plain", "remat"), dict.fromkeys(swin_k, 0)),
    )
    results = {}
    for name, make, micro, accum, variants, per_step in cases:
        t_case = time.perf_counter()
        state, gens, steps, remat_module, args = make()
        start = {part: copy.deepcopy(getattr(state, part).state_dict())
                 for part in ("g", "d", "ema", "g_opt", "d_opt")}
        gen_start = [g.get_state() for g in gens]

        def run(variant, data, sync_mode="error"):
            """One step of ``variant``; under the sync check a step that waits
            for the device raises."""
            remat_module.remat = variant == "remat"
            step = steps[variant == "remat_loss"]
            torch.cuda.set_sync_debug_mode(sync_mode)
            try:
                return step(data, 1e-4, 1e-4, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        # (a) the bits after one step from the same start; each variant's
        # warm-up too (the first calls upload the cached tables), so unchecked
        first, bits, ok_metrics = batch(micro, accum), {}, True
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for variant in variants:
                for part, sd in start.items():
                    getattr(state, part).load_state_dict(sd)
                for g, st in zip(gens, gen_start):
                    g.set_state(st)
                m = run(variant, first, 0)
                ok_metrics &= all(math.isfinite(float(v)) for v in m.values())
                bits[variant] = state_bits(state)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        differ = {v: [k for k, t in bits[v].items() if not torch.equal(t, bits["plain"][k])]
                  for v in variants[1:]}
        del bits
        # (b) alternated timed steps: ms, peak memory, launches a step
        data = batch(micro, accum)
        order = [v for i in range(REMAT_TIMED) for v in (variants if i % 2 == 0
                                                        else variants[::-1])]
        ms = {v: [] for v in variants}
        peak = dict.fromkeys(variants, 0)
        launches = {v: dict.fromkeys((fn.__name__ for fn in per_step), 0) for v in variants}
        for variant in order:
            before = {fn: fn.launches for fn in per_step}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            m = run(variant, data)
            t1.record()
            t1.synchronize()
            ms[variant].append(t0.elapsed_time(t1))
            peak[variant] = max(peak[variant], torch.cuda.max_memory_allocated())
            ok_metrics &= all(math.isfinite(float(v)) for v in m.values())
            for fn, n in before.items():
                launches[variant][fn.__name__] += fn.launches - n
        want = {fn.__name__: n * REMAT_TIMED for fn, n in per_step.items()}
        med = {v: statistics.median(t) for v, t in ms.items()}
        log("remat", f"{name} on {card}, bf16: " + "; ".join(
            f"{v}: median {med[v]:.2f} ms a step of {REMAT_TIMED} ("
            + ", ".join(f"{t:.2f}" for t in ms[v]) + f"), peak {peak[v] / 1e9:.2f} GB, "
            f"launches {launches[v]}" + (f", bits of plain after one step: {not differ[v]} "
                                         f"({len(differ[v])} tensors differ)"
                                         if v != "plain" else "")
            for v in variants) + f"; no host sync under set_sync_debug_mode('error'); "
            f"metrics finite {ok_metrics}; {time.perf_counter() - t_case:.1f} s")
        results[name] = med
        bad = [v for v in variants[1:] if differ[v] or peak[v] >= peak["plain"]]
        bad += [v for v in variants if launches[v] != want]
        if bad or not ok_metrics:
            raise SystemExit(f"[remat] {name}: {bad} (want lower peak than plain "
                             f"{peak['plain']}, the plain bits, launches {want}), metrics "
                             f"finite {ok_metrics}: peaks {peak}, differ {differ}, "
                             f"launches {launches}")
        remat_module.remat = False
        del state, steps, start
        torch.cuda.empty_cache()
    swin_m, hat_m = results[cases[0][0]], results[cases[1][0]]
    log("remat", "at the trainers' default splits, remat_loss on against off: swin (micro 8 x "
                 f"1) {swin_m['remat_loss']:.2f} against {swin_m['plain']:.2f} ms, hybrid "
                 f"(micro 2 x 8) {hat_m['remat_loss']:.2f} against {hat_m['plain']:.2f} ms "
                 "a step: the faster is the default")
    d_learns(seed, device, card)
    log("remat", f"the phase {time.perf_counter() - t_phase:.1f} s")


def d_learns(seed: int, device: torch.device, card: str) -> None:
    """[d-learns]: ``UNetDiscriminatorSNHAT`` alone (num_feat 64) for
    ``D_LEARNS_STEPS`` AdamW steps (lr 1e-4, betas 0.9/0.99, weight decay
    0.01, the hybrid's) of the hybrid step's own D phase
    (``train.steps.hat_d_phase``, RaGAN) on 2 fixed pairs at 512²: real is
    ``data/synth.py``'s HR, fake its LR nearest-upsampled x4. In bf16 and in
    fp32 (TF32 off), ``remat_loss`` off and on; the D loss at steps
    ``D_LEARNS_READ``. It fails where the bf16 D stalls near ln 2 (above
    0.68 at the last step) while the fp32 D falls below 0.6."""
    from superresolution_def_tpu_torch.data import synth_batch_u16
    from superresolution_def_tpu_torch.models import UNetDiscriminatorSNHAT
    from superresolution_def_tpu_torch.ops import resize_nearest
    from superresolution_def_tpu_torch.train import DiscriminatorLoss
    from superresolution_def_tpu_torch.train.steps import hat_d_phase, to01

    t0 = time.perf_counter()
    pairs = synth_batch_u16(2, 512, seed=seed)
    real = to01(pairs["hr"], device)
    fake = resize_nearest(to01(pairs["lr"], device), 4)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    read = {}
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            for remat in (False, True):
                d = UNetDiscriminatorSNHAT(num_in_ch=1, num_feat=64, dtype=dtype,
                                           generator=torch.Generator().manual_seed(seed))
                d = d.to(device)
                opt = torch.optim.AdamW(d.parameters(), lr=1e-4, betas=(0.9, 0.99), eps=1e-8,
                                        weight_decay=0.01)
                losses = []
                for _ in range(D_LEARNS_STEPS + 1):
                    opt.zero_grad()
                    losses.append(hat_d_phase(d, DiscriminatorLoss(), fake, real, 1,
                                              remat).detach().float())
                    opt.step()
                read[str(dtype).removeprefix("torch."), remat] = [
                    float(losses[i]) for i in D_LEARNS_READ]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log("d-learns", f"UNetDiscriminatorSNHAT alone on {card}, {D_LEARNS_STEPS} RaGAN AdamW "
                    f"steps (lr 1e-4, wd 0.01, micro 2) on synthetic HR against its LR "
                    f"nearest-upsampled, D loss at steps {list(D_LEARNS_READ)} (ln 2 = "
                    f"{math.log(2):.4f}): " + "; ".join(
                        f"{dt}{' (TF32 off)' if dt == 'float32' else ''} remat_loss "
                        f"{'on' if r else 'off'}: " + ", ".join(f"{v:.4f}" for v in vals)
                        for (dt, r), vals in read.items())
                    + f"; {time.perf_counter() - t0:.1f} s")
    stalled = [k for k, v in read.items() if k[0] == "bfloat16" and v[-1] > 0.68]
    falls = all(v[-1] < 0.6 for k, v in read.items() if k[0] == "float32")
    if stalled and falls:
        raise SystemExit(f"[d-learns] the bf16 D stalls near ln 2 where the fp32 D learns: "
                         f"{read}")


def upscale_phase(seed: int, device: torch.device, card: str) -> None:
    """34. [upscale]: ``upscale`` of a whole 16-bit FITS frame with the
    flagship SwinIR, then ``tiled_sr`` through K1 and, for the hybrid,
    through K5/K6/K7, each against the fp32 ``nn.Module`` on the same tiles."""
    from superresolution_def_tpu_torch.cli.infer import tiled_sr
    from superresolution_def_tpu_torch.cli.main import main as cli_main
    from superresolution_def_tpu_torch.data import read_tiff_u16
    from superresolution_def_tpu_torch.kernels import (
        fused_hab_block, fused_ocab_block, fused_rdb_cm, fused_swin_block, make_fused_hybrid,
        make_fused_swinir)
    from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
    from superresolution_def_tpu_torch.ops.normalize import log_stretch_normalize, robust_minmax
    from superresolution_def_tpu_torch.prep import TanWCS, read_fits

    h, w, tile, overlap = 512, 640, 128, 16  # the 128-px tiles do not divide 640
    ys = len(range(0, h - tile + 1, tile - 2 * overlap)) + ((h - tile) % (tile - 2 * overlap) > 0)
    xs = len(range(0, w - tile + 1, tile - 2 * overlap)) + ((w - tile) % (tile - 2 * overlap) > 0)
    n_tiles, n_calls = ys * xs, -(-(ys * xs) // 8)
    rng = np.random.default_rng(seed + 34)
    yy, xx = np.mgrid[0:h, 0:w]
    counts = 800.0 + 40.0 * rng.standard_normal((h, w))
    for cy, cx, amp, sig in zip(rng.uniform(0, h, 60), rng.uniform(0, w, 60),
                                rng.uniform(500, 40000, 60), rng.uniform(0.8, 3.0, 60)):
        counts += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
    counts = np.clip(counts, 0, 65535)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        frame = root / "m42.fits"
        write_fits_u16(frame, counts, TanWCS((83.8, -5.4), (w / 2, h / 2),
                                            cdelt=[-2e-4, 2e-4]).to_header())
        raw = read_fits(frame).data
        if not np.array_equal(raw, counts.astype(np.int32).astype(np.float32)):
            raise SystemExit("the 16-bit FITS frame does not read back")
        lo, hi = robust_minmax(raw, device=device)
        img01 = log_stretch_normalize(raw, lo, hi, device=device).cpu().numpy()

        model = SwinIR(**FLAGSHIP, generator=torch.Generator().manual_seed(seed + 34))
        run = root / "run"
        (run / "checkpoints").mkdir(parents=True)
        torch.save({"net_g": model.state_dict()}, run / "checkpoints" / "best_gan_model.pth")
        t0 = time.perf_counter()
        res = cli_main(["upscale", str(frame), "--folder", str(run)])
        cli_s = time.perf_counter() - t0
        sr_cli = read_tiff_u16(res["out"])
        log("upscale", f"upscale {frame.name} ({h}x{w}, 16-bit FITS, {n_tiles} tiles of {tile} "
                       f"with overlap {overlap}) -> {sr_cli.shape}, {cli_s:.2f} s wall with the "
                       f"checkpoint's load, on {card}; robust_minmax lo {float(lo):.6f} hi "
                       f"{float(hi):.6f}")
        if sr_cli.shape != (4 * h, 4 * w) or sr_cli.std() == 0:
            raise SystemExit(f"upscale gave {sr_cli.shape}, std {sr_cli.std()}")
        upscale_mesh_phase(frame, run, sr_cli, card)

        hybrid = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(seed + 35))
        for arch, net, make, counters, per_call in (
                ("SwinIR", model, make_fused_swinir, (fused_swin_block,), (36,)),
                ("hybrid", hybrid, make_fused_hybrid,
                 (fused_hab_block, fused_ocab_block, fused_rdb_cm), (24, 4, 36))):
            net = net.to(device).eval()
            forwards = {"fp32 nn.Module": net, "fused bf16": make(net)}
            if arch == "hybrid":
                forwards["bf16 nn.Module"] = lambda x, m=copy.deepcopy(net).to(
                    torch.bfloat16): m(x.to(torch.bfloat16))
            outs, walls, call_ms = {}, {}, {}
            x8 = torch.rand(8, tile, tile, 1, generator=torch.Generator().manual_seed(seed)).to(
                device)
            for name, fwd in forwards.items():
                # warm at the timed shape: one padded call of 8
                tiled_sr(fwd, img01[:tile, :2 * tile], tile=tile, overlap=overlap, device=device)
                for fn in counters:
                    fn.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = tiled_sr(fwd, img01, tile=tile, overlap=overlap, device=device)
                walls[name] = time.perf_counter() - t0
                if name == "fused bf16":
                    launches = {fn.__name__: fn.launches for fn in counters}
                with torch.no_grad():  # one call's device time, at the tiles' shape
                    call_ms[name] = cuda_ms(lambda: fwd(x8), reps=3, warmup=1, calls=1)
            ref = outs["fp32 nn.Module"]
            rel = {k: float(np.linalg.norm(v - ref) / np.linalg.norm(ref))
                   for k, v in outs.items() if k != "fp32 nn.Module"}
            bound = FORWARD_REL_L2 if arch == "SwinIR" else max(FORWARD_REL_L2,
                                                                 2 * rel["bf16 nn.Module"])
            log("upscale", f"tiled_sr of the frame, {arch} at full width, {n_tiles} tiles in "
                           f"{n_calls} calls of 8 on {card}: " + ", ".join(
                               f"{k} {walls[k]:.3f} s = {n_tiles / walls[k]:.2f} tiles/s "
                               f"(device {n_calls} x {call_ms[k]:.3f} ms a call of 8 = "
                               f"{n_calls * call_ms[k] / 1e3 / walls[k]:.1%} of it)"
                               for k in outs)
                + "; rel L2 to the fp32 module: " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
                + f" (bound {bound:.3e}); launches " + ", ".join(f"{k} {v}" for k, v in
                                                                 launches.items()))
            want = {fn.__name__: n_calls * n for fn, n in zip(counters, per_call)}
            if not (rel["fused bf16"] <= bound and np.isfinite(outs["fused bf16"]).all()
                    and outs["fused bf16"].shape == (4 * h, 4 * w, 1) and launches == want):
                raise SystemExit(f"tiled {arch} through its kernels disagrees: rel "
                                 f"{rel['fused bf16']} > {bound}, or launches {launches} != {want}")
            del forwards, outs, net
            torch.cuda.empty_cache()
        spatial_phase(device, card, img01, model, hybrid)


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
    ocab_train_mod = importlib.import_module("superresolution_def_tpu_torch.kernels.ocab_train")
    wattn = importlib.import_module("superresolution_def_tpu_torch.kernels.window_attention")
    rdb_nhwc = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb")
    # the module, not the function of the same name that the package exports
    rdb_cm = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb_cm")
    rdb_bwd = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb_cm_bwd")
    stage = importlib.import_module("superresolution_def_tpu_torch.kernels.swin_stage_ablation")
    from superresolution_def_tpu_torch.tools import swin_stage_ablation as ablation_tool
    from superresolution_def_tpu_torch.kernels import (
        fused_hab_block,
        hab_bwd_attn,
        hab_bwd_attn_reference,
        hab_bwd_mlp,
        hab_bwd_mlp_reference,
        hab_fwd_h,
        hab_fwd_h_reference,
        ocab_bwd_attn,
        ocab_bwd_attn_reference,
        ocab_fwd_h,
        ocab_fwd_h_reference,
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
        pack_hab_weights,
        pack_ocab_weights,
        pack_swin_block_weights,
        rdb_cm_bwd_reference,
        rdb_cm_reference,
        swin_block_bwd,
        swin_block_bwd_attn,
        swin_block_bwd_mlp,
        swin_block_fwd_h,
        swin_stage_block,
    )
    from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
    from superresolution_def_tpu_torch.models.hat import OCAB
    from superresolution_def_tpu_torch.ops import overlap_windows, shift_window_attn_mask
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
    swin_block._bwd_library()
    hab_block._library()
    ocab._library()
    rdb_cm._library()
    rdb_bwd._library()
    ocab_train_mod._library()
    wattn._library()
    rdb_nhwc._library()
    stage._library()
    build_s = time.perf_counter() - t0
    log("build", ", ".join(f"{k}.cu -> {v.name}" for k, v in paths.items())
        + f", all {len(SOURCES)} at once in {build_s:.1f} s")
    for name in ("swin_block", "hab_block", "ocab", "rdb_cm", "rdb_cm_bwd", "window_attention",
                 "fused_rdb", "swin_stage_ablation", "swin_block_bwd"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", f"{name}: " + line.strip().replace("ptxas info    : ", ""))

    for key, src, fragment in (
            ("K1 swin_fwd_wg_kernel<3, 32, false>", "swin_block",
             "swin_fwd_wg_kernelILi3ELi32ELb0E"),
            ("K2 swin_fwd_wg_kernel<3, 32, true>", "swin_block",
             "swin_fwd_wg_kernelILi3ELi32ELb1E"),
            ("K5 hab_fwd_wg_kernel<2, 16>", "hab_block", "hab_fwd_wg_kernelILi2ELi16E"),
            ("K9a hab_fwd_h_wg_kernel<2, 16>", "hab_block", "hab_fwd_h_wg_kernelILi2ELi16E"),
            ("K6 ocab_fwd_wg_kernel<2, 16, false>", "ocab", "ocab_fwd_wg_kernelILi2ELi16ELb0E"),
            ("K10a ocab_fwd_wg_kernel<2, 16, true>", "ocab", "ocab_fwd_wg_kernelILi2ELi16ELb1E"),
            ("K4b's recompute swin_fwd_h32_wg_kernel<3, 32>", "swin_block_bwd",
             "swin_fwd_h32_wg_kernelILi3ELi32E"),
            ("K4b's MLP phase mlp_bwd_f32_kernel<3>", "swin_block_bwd",
             "mlp_bwd_f32_kernelILi3E"),
            ("K4b's attention phase attn_wg_f32_kernel<3, 32>", "swin_block_bwd",
             "attn_wg_f32_kernelILi3ELi32E"),
            ("K10b ocab_bwd_wg_kernel<16>", "ocab_train", "ocab_bwd_wg_kernelILi16E"),
            ("K12's conv5 nhwc_conv_kernel<48, 144, 48, true>", "fused_rdb",
             "nhwc_conv_kernelILi48ELi144ELi48ELb1E")):
        log("build", f"{key} (the flagship's or HAT's widths): "
            + ptxas_stats(_build.build_log(src), fragment))
    klib = swin_block._kernel_library()
    hlib = hab_block._library()
    log("build", "dynamic shared memory: K1's and K2's kernel (swin_fwd_wg_kernel) at C=180, 6 "
        f"heads, hidden 720 {klib.swin_block_smem_bytes(180, 6, 720)} B "
        f"({klib.swin_block_windows(180, 6, 720)} windows a block); K5's (hab_fwd_wg_kernel) "
        f"at C=96 (90 in device memory), 6 heads, hidden 360 "
        f"{hlib.hab_block_smem_bytes(96, 90, 6, 360)} B "
        f"({hlib.hab_block_windows(96, 90, 6, 360)} windows a block; K9a's the same); K6's and "
        f"K10a's (ocab_fwd_wg_kernel) at C=96 (90 in device memory), 6 heads, hidden 360 "
        f"{ocab._library().ocab_block_smem_bytes(96, 90, 6, 360)} B (windows a block and "
        f"gather stages a window {divmod(ocab._library().ocab_block_shape(96, 90, 6, 360), 10)}"
        f"); K4b's "
        f"phases at C=180, 6 heads, hidden 720 (the largest) "
        f"{swin_block._bwd_library().swin_bwd_block_smem_bytes(180, 6, 720)} B; K7's five convs "
        "(conv_kernel) at F/G = 48/24: " + ", ".join(
            f"conv{i + 1} {b} B" for i, b in enumerate(rdb_cm.smem_bytes(48, 24)))
        + "; K12's (nhwc_conv_kernel): " + ", ".join(
            f"conv{i + 1} {b} B" for i, b in enumerate(rdb_nhwc.smem_bytes(48, 24)))
        + "; K10b's window kernel (ocab_bwd_wg_kernel) at C=96 (90 in device memory), "
        f"head_dim 15: {ocab_train_mod._library().ocab_bwd_attn_smem_bytes(96, 15)} B")

    # 3. K1 against its plain version at the flagship shapes
    gen = torch.Generator().manual_seed(seed)
    args = k1_inputs(gen, device)
    kw = dict(num_heads=6, scale=30**-0.5)
    got = fused_swin_block(*args, **kw)
    # the inference forward packs each block's weights once
    packed1 = pack_swin_block_weights(args[3], args[6], args[10], args[12], num_heads=6)
    k1_same = (torch.equal(got, fused_swin_block(*args, **kw))
               and torch.equal(got, fused_swin_block(*args, **kw, packed=packed1)))
    torch.cuda.synchronize()
    want = swin_block.swin_block_reference(*args, **kw)
    err = (got.float() - want.float()).abs().max().item()
    bound = K1_TOL * max(1.0, want.float().abs().max().item())
    k1_ms = cuda_ms(lambda: fused_swin_block(*args, **kw, packed=packed1))
    k1_pack_ms = cuda_ms(lambda: fused_swin_block(*args, **kw))
    vec1, w1d = swin_block._block_dicts(*args[1:5], *args[6:])
    k1_one_ms = cuda_ms(lambda: swin_block._launch_forward(
        args[0], vec1, w1d, args[5], 6, 30**-0.5, False, packed=packed1, windows=1))
    plain_ms = cuda_ms(lambda: swin_block.swin_block_reference(*args, **kw))
    log("k1", f"Bw=768 C=180 heads=6 hidden=720 bf16: max|kernel-plain|={err:.3e} "
              f"(bound {bound:.3e}); twice, and on weights packed once, bit-identical: "
              f"{k1_same}; on {card}: kernel {k1_ms:.4f} ms on weights packed once (two windows "
              f"a block), {k1_one_ms:.4f} ms with one window a block, {k1_pack_ms:.4f} ms "
              f"packing on every call; plain {plain_ms:.4f} ms")
    if not err <= bound or not k1_same:
        raise SystemExit(f"K1 disagrees with its plain version: {err} > {bound}, or gave other "
                         f"bits on a second run or on weights packed once ({k1_same})")
    del packed1

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
    tlib = swin_block._train_library()
    log("build-train", "dynamic shared memory: K3's window kernel (mlp_bwd_kernel) at C=180, "
        f"hidden 720 {tlib.swin_bwd_mlp_smem_bytes(180, 720)} B, K9b's at C=92, hidden 360 "
        f"{tlib.swin_bwd_mlp_smem_bytes(92, 360)} B; K4's window kernel (attn_wg_kernel) at "
        f"C=180, 6 heads {tlib.swin_bwd_attn_smem_bytes(180, 6)} B "
        f"({tlib.swin_bwd_attn_windows(180, 6)} windows a block), K9c's at C=96, 6 heads "
        f"{tlib.swin_bwd_attn_smem_bytes(96, 6)} B ({tlib.swin_bwd_attn_windows(96, 6)} windows "
        f"a block); the weight-gradient product (wgrad_kernel) {tlib.swin_wgrad_smem_bytes()} B")

    # 8. K2/K3/K4 against their plain versions at the flagship train shapes
    bw_train = MICRO * (128 // 8) ** 2  # 2048 windows: micro 8 of 128x128
    targs = k1_inputs(torch.Generator().manual_seed(seed + 1), device, bw=bw_train)
    xw, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = targs
    dgen = torch.Generator().manual_seed(seed + 2)
    dout = (1e-2 * torch.randn(bw_train, 64, 180, generator=dgen)).to(device, torch.bfloat16)
    out, h = swin_block_fwd_h(*targs, **kw)
    again2 = swin_block_fwd_h(*targs, **kw)
    k2_same = torch.equal(out, again2[0]) and torch.equal(h, again2[1])
    # K2 is K1's wgmma kernel with the store of h: against K1 within K1's
    # bound (the same products in the same order, so the bits agree today)
    k1_out = fused_swin_block(*targs, **kw)
    k2_k1_err = (out.float() - k1_out.float()).abs().max().item()
    k2_k1_bound = K1_TOL * max(1.0, k1_out.float().abs().max().item())
    del again2, k1_out
    want_out, want_h = swin_block.swin_block_fwd_h_reference(*targs, **kw)
    k2_err = (out.float() - want_out.float()).abs().max().item()
    k2_bound = K1_TOL * max(1.0, want_out.float().abs().max().item())
    k2_h_err = (h.float() - want_h.float()).abs().max().item()
    k2_h_bound = K1_TOL * max(1.0, want_h.float().abs().max().item())
    mlp_args = (h, dout, ln2_w, ln2_b, w1, b1, w2)
    attn_args = (xw, dout, ln1_w, ln1_b, wqkv, bqkv, bias, wproj)
    mlp = swin_block_bwd_mlp(*mlp_args)
    k3_same = all(torch.equal(a, b) for a, b in zip(mlp, swin_block_bwd_mlp(*mlp_args)))
    attn = swin_block_bwd_attn(*attn_args, **kw)
    k4_same = all(torch.equal(a, b) for a, b in zip(attn, swin_block_bwd_attn(*attn_args, **kw)))
    # K4/K9c's weight packing against its plain version, bit for bit, at
    # K4's and K9c's kernel widths
    pack_same = {}
    for pc in (180, 96):
        pw_qkv, pw_proj = wqkv[:pc, :3 * pc].contiguous(), wproj[:pc, :pc].contiguous()
        packed = torch.empty(tlib.swin_bwd_attn_pack_bytes(pc, 6) // 2, dtype=torch.bfloat16,
                             device=device)
        swin_block._check(tlib.swin_bwd_attn_pack_bf16(
            pw_qkv.data_ptr(), pw_proj.data_ptr(), pc, 6, packed.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "swin_bwd_attn_pack_bf16")
        torch.cuda.synchronize()
        pack_same[pc] = torch.equal(packed, swin_block.attn_pack_reference(pw_qkv, pw_proj, 6))
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
                 f"K2 max|out-plain|={k2_err:.3e} (bound {k2_bound:.3e}), max|h-plain|="
                 f"{k2_h_err:.3e} (bound {k2_h_bound:.3e}), max|out-K1 out|={k2_k1_err:.3e} "
                 f"(bound {k2_k1_bound:.3e}); K2 twice bit-identical: {k2_same}")
    log("k2-k4", "rel L2 vs plain (bound %g): " % BWD_REL_L2
                 + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log("k2-k4", f"on {card}: " + ", ".join(
        f"{k} {t[0]:.4f} ms (plain {t[1]:.4f} ms)" for k, t in times.items())
        + f"; K3 twice bit-identical: {k3_same}; K4 twice bit-identical: {k4_same}; K4/K9c's "
          f"weight packing bit for bit its plain version at C=180, 96: {pack_same}")
    for key, fn in (("K2", lambda: swin_block_fwd_h(*targs, **kw)),
                    ("K3", lambda: swin_block_bwd_mlp(*mlp_args)),
                    ("K4", lambda: swin_block_bwd_attn(*attn_args, **kw))):
        log("k2-k4", f"{key} device ms per call by kernel: " + ", ".join(
            f"{short_name(name)} {t:.4f}"
            for name, t in kernel_split(fn).items()))
    if not k2_k1_err <= k2_k1_bound or not k2_same:
        raise SystemExit(f"K2's out differs from K1's beyond K1's bound ({k2_k1_err}), or K2 "
                         f"gave other bits on a second run ({k2_same})")
    if not k3_same or not k4_same:
        raise SystemExit(f"K3 or K4 gave other bits on a second run of the same inputs "
                         f"({k3_same}, {k4_same})")
    if not all(pack_same.values()):
        raise SystemExit(f"K4/K9c's weight packing differs from its plain version: {pack_same}")
    if not k2_err <= k2_bound or not k2_h_err <= k2_h_bound:
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
            # K2 packs with K3's and K4's packing kernels (the same names):
            # their time counts under K3 and K4. K1 and K2 are one kernel
            # template, told apart by STORE_H (K2's true)
            groups = {"K2": (r"swin_fwd_wg_kernel<\d+, \d+, true>",),
                      "K3": ("mlp_bwd_kernel", "mlp_pack_kernel"),
                      "K4": ("attn_wg_kernel", "attn_pack_kernel"),
                      "K3/K4 wgrad+colsum": ("wgrad_kernel", "colsum_kernel")}
            split = group_split(ops, groups, "profile")
            log("profile", f"fused train step on {card}: device busy {busy_ms:.3f} ms per "
                           f"step, idle share {idle:.4f}; by kernel group per step: "
                           + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
                           + "; top device ops per step: " + "; ".join(
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
    k5_err, k5_bound, k5_ms, k5_plain, k5_same = {}, {}, {}, {}, {}
    # the hybrid's forward pads and packs each block's weights once
    pad5 = hab_block.pad_hab_operands(*hargs[1:5], *hargs[6:], num_heads=6)
    pack5 = pack_hab_weights(pad5, num_heads=6)
    for tag, m in (("unshifted", None), ("shifted", mask)):
        a = (hargs[0], conv_x, m, *hargs[1:])
        got = fused_hab_block(*a, **hkw)
        k5_same[tag] = (torch.equal(got, fused_hab_block(*a, **hkw)) and torch.equal(
            got, fused_hab_block(*a, **hkw, padded=pad5, packed=pack5)))
        torch.cuda.synchronize()
        want = hab_block_reference(*a, **hkw)
        k5_err[tag] = (got.float() - want.float()).abs().max().item()
        k5_bound[tag] = K1_TOL * max(1.0, want.float().abs().max().item())
        k5_ms[tag] = cuda_ms(lambda: fused_hab_block(*a, **hkw, padded=pad5, packed=pack5))
        k5_plain[tag] = cuda_ms(lambda: hab_block_reference(*a, **hkw), reps=5, warmup=1, calls=2)
        if not torch.isfinite(got).all() or not k5_err[tag] <= k5_bound[tag]:
            raise SystemExit(f"K5 ({tag}) disagrees with its plain version: {k5_err[tag]}")
        if not k5_same[tag]:
            raise SystemExit(f"K5 ({tag}) gave other bits on a second run or on weights "
                             "padded and packed once")
    log("k5", f"Bw={bw_hat} C=90 heads=6 hidden=360 bf16 on {card}, timed on weights padded "
        "and packed once: " + "; ".join(
            f"{t}: max|kernel-plain|={k5_err[t]:.3e} (bound {k5_bound[t]:.3e}), twice and "
            f"packed once bit-identical {k5_same[t]}, kernel {k5_ms[t]:.4f} ms, plain "
            f"{k5_plain[t]:.4f} ms" for t in k5_err))
    del pad5, pack5
    oargs = [hargs[0], *(torch.randn(bw_hat, n, 90, generator=hgen).to(device, torch.bfloat16)
                         for n in (64, 144, 144)),
             (0.5 * torch.randn(6, 64, 144, generator=hgen)).to(device), *hargs[6:]]
    oargs[2][:, :14] = 0  # the overlap gather's out-of-image keys of an edge window
    oargs[3][:, :14] = 0
    okw = dict(num_heads=6, scale=15**-0.5)
    # the hybrid's forward pads and packs each OCAB's weights once
    pad6 = ocab.pad_ocab_operands(*oargs[5:])
    okw6 = dict(okw, padded=pad6, packed=pack_ocab_weights(pad6, num_heads=6, channels=90))
    got = fused_ocab_block(*oargs, **okw)
    k6_same = (torch.equal(got, fused_ocab_block(*oargs, **okw))
               and torch.equal(got, fused_ocab_block(*oargs, **okw6)))
    torch.cuda.synchronize()
    want = ocab_block_reference(*oargs, **okw)
    k6_err = (got.float() - want.float()).abs().max().item()
    k6_bound = K1_TOL * max(1.0, want.float().abs().max().item())
    k6_times = (cuda_ms(lambda: fused_ocab_block(*oargs, **okw6)),
                cuda_ms(lambda: ocab_block_reference(*oargs, **okw), reps=5, warmup=1, calls=2))
    k6_per_call = cuda_ms(lambda: fused_ocab_block(*oargs, **okw))
    log("k6", f"Bw={bw_hat} nq=64 nk=144 (the first 14 zero) C=90 heads=6 hidden=360 bf16 on "
              f"{card}: max|kernel-plain|={k6_err:.3e} (bound {k6_bound:.3e}), twice and packed "
              f"once bit-identical {k6_same}, kernel {k6_times[0]:.4f} ms on weights padded and "
              f"packed once ({k6_per_call:.4f} ms padding and packing on every call), plain "
              f"{k6_times[1]:.4f} ms")
    if not torch.isfinite(got).all() or not k6_err <= k6_bound or not k6_same:
        raise SystemExit(f"K6 disagrees with its plain version: {k6_err} > {k6_bound}, or gave "
                         f"other bits on a second run or on weights packed once ({k6_same})")
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
    k7_same = torch.equal(got, fused_rdb_cm(xr, ks, bs, **rkw))
    torch.cuda.synchronize()
    want = rdb_cm_reference(xr, ks, bs, **rkw)
    k7_err = (got.float() - want.float()).abs().max().item()
    k7_bound = K1_TOL * max(1.0, want.float().abs().max().item())
    # timed on weights packed once, as the forwards pass them
    packed7 = rdb_cm.pack_rdb_cm_weights(ks, bs, device)
    k7_times = (cuda_ms(lambda: fused_rdb_cm(xr, ks, bs, **rkw, packed=packed7), reps=10),
                cuda_ms(lambda: rdb_cm_reference(xr, ks, bs, **rkw), reps=5, warmup=1, calls=2))
    log("k7", f"B={HYBRID_BATCH} F={f} G={g} 256x256 bf16 on {card}: max|kernel-plain|="
              f"{k7_err:.3e} (bound {k7_bound:.3e}), rel L2 {rel_l2(got, want):.3e}, kernel "
              f"{k7_times[0]:.4f} ms, plain "
              f"{k7_times[1]:.4f} ms (fp32 convs, no TF32); twice bit-identical: {k7_same}")
    log("k7", f"B={HYBRID_BATCH} device ms per call by kernel: " + ", ".join(
        f"{short_name(name)} {t:.4f}" for name, t in
        kernel_split(lambda: fused_rdb_cm(xr, ks, bs, **rkw, packed=packed7)).items()))
    if not torch.isfinite(got).all() or not k7_err <= k7_bound or not k7_same:
        raise SystemExit(f"K7 disagrees with its plain version: {k7_err} > {k7_bound}, or gave "
                         f"other bits on a second run ({k7_same})")
    del xr, ks, bs, got, want, packed7
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
    # K5 runs hab_fwd_wg_kernel; K6 the wgmma body's OCAB mode without the
    # h store (K10a's has it); K7 its transpose and five convs
    split = group_split(ops, {"K5": ("hab_fwd_wg_kernel<",),
                              "K6": (r"ocab_fwd_wg_kernel<\d+, \d+, false>",),
                              "K7": ("conv_kernel<", "stash_x_kernel")}, "hat-profile")
    log("hat-profile", f"fused hybrid forward, batch {HYBRID_BATCH} on {card}: device busy "
                       f"{busy_ms:.3f} ms per forward, idle share {idle:.4f}; by kernel group "
                       "per forward: " + ", ".join(
                           f"{k} {v:.3f} ms ({v / busy_ms:.1%} of busy)" for k, v in split.items())
                       + "; top device ops: "
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
    got7 = fused_rdb_cm(xb, ks, bs, **rkw, stash=stash)
    same_k7 = torch.equal(got7, fused_rdb_cm(xb, ks, bs, **rkw))
    want7 = rdb_cm_reference(xb, ks, bs, **rkw).float()
    k7b2_err = (got7.float() - want7).abs().max().item()
    k7b2_bound = K1_TOL * max(1.0, want7.abs().max().item())
    del got7, want7
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
    packed7 = rdb_cm.pack_rdb_cm_weights(ks, bs, device)
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
              f"K7's output with and without the stash identical: {same_k7}, max|K7-plain|="
              f"{k7b2_err:.3e} (bound {k7b2_bound:.3e})")
    k8_split = kernel_split(lambda: fused_rdb_cm_bwd(xb, dyb, ks, bs, **rkw, stash=stash,
                                                     packed=packed8))
    log("k8", f"K7 with stash at B={b2} device ms per call by kernel: " + ", ".join(
        f"{short_name(name)} {t:.4f}" for name, t in kernel_split(
            lambda: fused_rdb_cm(xb, ks, bs, **rkw, packed=packed7, stash=stash)).items()))
    smem8 = (ctypes.c_longlong * 3)()
    ts8 = rdb_bwd._library().rdb_cm_bwd_smem_bytes(f, g, ctypes.addressof(smem8))
    log("k8", "device ms per call by kernel: " + ", ".join(
        f"{short_name(name)} {t:.4f}" for name, t in k8_split.items())
        + f"; dynamic shared memory: stack_kernel {smem8[0]} B ({ts8}x{ts8} tiles), "
          f"wgrad_kernel {smem8[1]} B, dx_kernel {smem8[2]} B")
    bad = {k: v for k, v in errs8.items() if not v <= BWD_REL_L2}
    if bad or not same_bits or not same_k7 or not k7b2_err <= k7b2_bound:
        raise SystemExit(f"K8 disagrees with its plain version {bad}, or is not reproducible "
                         f"({same_bits}), or the stash changed K7's output ({same_k7}), or K7 "
                         f"with the stash disagrees with its plain version ({k7b2_err})")
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
        # 23. the fused-HAB generator (K9, K10 in the backbone)
        ("fused-HAB generator", HAB_CHECKED, hyb, hyb16,
         make_fused_hybrid_train(hyb, fused_hab=True), x, probe),
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
            groups = {"K7": ("conv_kernel<", "stash_x_kernel"),
                      "K8": ("stack_kernel", "wgrad_kernel<", "dx_kernel"),
                      "AdamW+EMA": ("multi_tensor_apply",)}
            split = group_split(ops, groups, "hat-train-profile")
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
                + f"; device ops per step {sum(n for _, _, n in ops)}"
                + "; timed alone per step: " + ", ".join(f"{k} {v:.3f} ms"
                                                        for k, v in parts.items())
                + "; top device ops: " + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                                                    for name, t, n in ops[:10])
                + "; top host ops by self time: " + "; ".join(
                    f"{name[:50]} {t:.3f} ms x{n}" for name, t, n in device_profile.host[:12]))
            del xin, hr, sr
        del st, stp, hb
        torch.cuda.empty_cache()
    log("hat-train-throughput", f"hybrid GAN step, 128->512 on {card}: " + "; ".join(
        f"{k} {int(k.split()[1].split('x')[0]) * int(k.split('x')[1]) * 1e3 / ms:.3f} patches/s "
        f"({ms:.2f} ms/step, peak {hat_step_peak[k]:.2f} GB)" for k, ms in hat_step_ms.items()))

    # 21. the fused-HAB training kernels' build (done with phase 2's; K9a is
    # an entry of hab_block.cu, K9b and K9c of swin_block_train.cu, whose
    # lines phases 2 and 7 printed)
    for line in _build.build_log("ocab_train").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build-hab-train", "ocab_train: " + line.strip().replace("ptxas info    : ", ""))

    # 22. K9a-c and K10a-b against their plain versions at the fused-HAB
    # step's shapes
    bw_t = HAT_MICRO * (128 // 8) ** 2  # 512 windows: micro 2 of 128x128
    bf = torch.bfloat16
    kgen = torch.Generator().manual_seed(seed + 12)
    targs9 = k1_inputs(kgen, device, bw=bw_t, c=90, heads=6, hidden=360)
    x9, ln1_w, ln1_b, wqkv, bqkv, bias9, wproj, bproj, ln2_w, ln2_b, w1, b1, w2, b2 = targs9
    convx9 = (0.1 * torch.randn(bw_t, 64, 90, generator=kgen)).to(device, bf)
    dout9 = (1e-2 * torch.randn(bw_t, 64, 90, generator=kgen)).to(device, bf)
    per_image = bw_t // HAT_MICRO

    def per_sample(values):
        return torch.tensor(values, dtype=torch.float32).repeat_interleave(per_image).to(device)

    dp1 = per_sample([1 / 0.9, 0.0])  # sample 1's attention branch dropped
    dp2 = per_sample([0.0, 1 / 0.9])  # sample 0's MLP branch dropped
    mask128 = torch.from_numpy(shift_window_attn_mask(128, 128, 8, 4)).to(device)
    # the kernels' padded weights, made once as the training path caches them
    pad9 = hab_block.pad_hab_operands(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, w1,
                                      b1, w2, b2, num_heads=6)
    pad10 = ocab.pad_ocab_operands(*targs9[6:])
    pack10 = pack_ocab_weights(pad10, num_heads=6, channels=90)
    hkw9 = dict(num_heads=6, scale=15**-0.5)
    names9 = ["out", "h", "dh", "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2", "dx", "dln1_w",
              "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj"]
    errs9, same9, passed9, max9, t9, split9 = {}, {}, {}, {}, {}, {}
    for tag, m in (("unshifted", None), ("shifted", mask128)):
        fwd_args = (x9, convx9, m, dp1, dp2, *targs9[1:])
        mlp_args = lambda h_: (h_, dout9, dp2, ln2_w, ln2_b, w1, b1, w2)  # noqa: E731
        kw9a = dict(**hkw9, conv_scale=0.01, padded=pad9)
        kw9c = dict(**hkw9, padded=pad9)
        out9, h9 = hab_fwd_h(*fwd_args, **kw9a)
        fwd_again = hab_fwd_h(*fwd_args, **kw9a)
        mlp9 = hab_bwd_mlp(*mlp_args(h9), padded=pad9[6:11])
        attn_args = (x9, mlp9[0], m, dp1, ln1_w, ln1_b, wqkv, bqkv, bias9, wproj)
        attn9 = hab_bwd_attn(*attn_args, **kw9c)
        again = (*hab_bwd_mlp(*mlp_args(h9), padded=pad9[6:11]),
                 *hab_bwd_attn(*attn_args, **kw9c))
        torch.cuda.synchronize()
        same9[tag] = all(torch.equal(a, b_) for a, b_ in zip((out9, h9, *mlp9, *attn9),
                                                             (*fwd_again, *again)))
        # the dropped branches pass the cotangent through: dh = dout on
        # sample 0 (MLP dropped), dx = dh on sample 1 (attention dropped)
        passed9[tag] = (torch.equal(mlp9[0][:per_image], dout9[:per_image])
                        and torch.equal(attn9[0][per_image:], mlp9[0][per_image:]))
        wants = (*hab_fwd_h_reference(*fwd_args, **hkw9, conv_scale=0.01),
                 *hab_bwd_mlp_reference(*mlp_args(h9)),
                 *hab_bwd_attn_reference(*attn_args, **hkw9))
        gots = (out9, h9, *mlp9, *attn9)
        for name, got_t, want_t in zip(names9, gots, wants):
            if not torch.isfinite(got_t).all():
                raise SystemExit(f"K9's {name} ({tag}) is not finite")
            errs9[f"{tag} {name}"] = rel_l2(got_t, want_t)
        max9[tag] = {k: (gots[i].float() - wants[i].float()).abs().max().item()
                     for k, i in (("K9a", 0), ("K9b", 2), ("K9c", 9))}
        del again, fwd_again, wants
        t9[tag] = {
            "K9a": (cuda_ms(lambda: hab_fwd_h(*fwd_args, **kw9a)),
                    cuda_ms(lambda: hab_fwd_h_reference(*fwd_args, **hkw9, conv_scale=0.01),
                            **timing)),
            "K9b": (cuda_ms(lambda: hab_bwd_mlp(*mlp_args(h9), padded=pad9[6:11])),
                    cuda_ms(lambda: hab_bwd_mlp_reference(*mlp_args(h9)), **timing)),
            "K9c": (cuda_ms(lambda: hab_bwd_attn(*attn_args, **kw9c)),
                    cuda_ms(lambda: hab_bwd_attn_reference(*attn_args, **hkw9), **timing)),
        }
        split9[tag] = kernel_split(lambda: hab_bwd_attn(*attn_args, **kw9c))
    ogen = torch.Generator().manual_seed(seed + 13)
    kv9 = overlap_windows(torch.randn(HAT_MICRO, 128, 128, 180, generator=ogen).to(device, bf),
                          8, 12)  # the out-of-image keys are zero, as in training
    oargs9 = [x9, torch.randn(bw_t, 64, 90, generator=ogen).to(device, bf),
              kv9[..., :90].contiguous(), kv9[..., 90:].contiguous(),
              (0.5 * torch.randn(6, 64, 144, generator=ogen)).to(device), *targs9[6:]]
    bwd10 = (*oargs9[1:4], dout9, oargs9[4], wproj)
    kw10b = dict(**hkw9, padded_wproj=pad10[0])
    out10, h10 = ocab_fwd_h(*oargs9, **hkw9, padded=pad10, packed=pack10)
    g10 = ocab_bwd_attn(*bwd10, **kw10b)
    same10 = all(torch.equal(a, b_) for a, b_ in zip(g10, ocab_bwd_attn(*bwd10, **kw10b)))
    torch.cuda.synchronize()
    names10 = ["out", "h", "dq", "dk", "dv", "dbias", "dwproj", "dbproj"]
    gots10 = (out10, h10, *g10)
    wants10 = (*ocab_fwd_h_reference(*oargs9, **hkw9), *ocab_bwd_attn_reference(*bwd10, **hkw9))
    errs10 = {}
    for name, got_t, want_t in zip(names10, gots10, wants10):
        if not torch.isfinite(got_t).all():
            raise SystemExit(f"K10's {name} is not finite")
        errs10[name] = rel_l2(got_t, want_t)
    max10 = {"K10a": (out10.float() - wants10[0].float()).abs().max().item(),
             "K10b": max((gots10[i].float() - wants10[i].float()).abs().max().item()
                         for i in (2, 3, 4))}
    del wants10
    split10 = kernel_split(lambda: ocab_bwd_attn(*bwd10, **kw10b))
    split10_counts = kernel_split.counts
    t10 = {"K10a": (cuda_ms(lambda: ocab_fwd_h(*oargs9, **hkw9, padded=pad10, packed=pack10)),
                    cuda_ms(lambda: ocab_fwd_h_reference(*oargs9, **hkw9), **timing)),
           "K10b": (cuda_ms(lambda: ocab_bwd_attn(*bwd10, **kw10b)),
                    cuda_ms(lambda: ocab_bwd_attn_reference(*bwd10, **hkw9), **timing))}
    work_t = hat_work()
    log("k9-k10", f"Bw={bw_t} C=90 heads=6 hidden=360 bf16, dout ~ N(0, 1e-2), one sample "
                  f"dropped per branch: rel L2 vs plain (bound {BWD_REL_L2}): "
                  + ", ".join(f"{k} {v:.3e}" for k, v in {**errs9, **{
                      f"K10 {k}": v for k, v in errs10.items()}}.items()))
    log("k9-k10", f"bit-identical over two runs: K9a-c {same9}, K10b {same10}; dropped "
                  f"branches pass the cotangent through: {passed9}")
    log("k9-k10", f"on {card}: " + "; ".join(
        f"{k} {tag} {v[0]:.4f} ms (plain {v[1]:.4f} ms, bound {least_ms(work_t[k])[0]:.4f} ms)"
        for tag, d in t9.items() for k, v in d.items()) + "; " + "; ".join(
        f"{k} {v[0]:.4f} ms (plain {v[1]:.4f} ms, bound {least_ms(work_t[k])[0]:.4f} ms)"
        for k, v in t10.items()))
    for tag, split in split9.items():
        log("k9-k10", f"K9c {tag} device ms per call by kernel: " + ", ".join(
            f"{short_name(name)} {t:.4f}" for name, t in split.items()))
    log("k9-k10", "K10b device ms per call by kernel (window kernel, weight-gradient product, "
                  "column sums): " + ", ".join(
                      f"{short_name(name)} {t:.4f} (x{split10_counts[name]})"
                      for name, t in split10.items()))
    bad = {k: v for k, v in {**errs9, **errs10}.items() if not v <= BWD_REL_L2}
    if bad or not all(same9.values()) or not same10 or not all(passed9.values()):
        raise SystemExit(f"K9/K10 disagree with their plain versions {bad}, or are not "
                         f"reproducible ({same9}, {same10}), or a dropped branch leaks "
                         f"({passed9})")
    del targs9, x9, convx9, dout9, kv9, oargs9, out9, h9, mlp9, attn9, out10, h10, g10, pad9, pad10
    torch.cuda.empty_cache()

    # 24. the fused-HAB training slice through the CLI (its main path: counts
    # from 0)
    hab_counters = (hab_fwd_h, hab_bwd_mlp, hab_bwd_attn, ocab_fwd_h, ocab_bwd_attn,
                    fused_rdb_cm, fused_rdb_cm_bwd)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_split(root / "data", np.random.default_rng(seed + 14),
                    {"train": HAT_TRAIN_PAIRS, "test": N_IMAGES})
        for fn in hab_counters:
            fn.launches = 0
        t0 = time.perf_counter()
        last = cli_main(["train", "--arch", "hat", "--target", "T1", "--bf16", "--fused-hab",
                         "--batch-size", str(HAT_MICRO), "--accum-steps", str(HAT_ACCUM),
                         "--epochs", "2", "--warmup-epochs", "1", "--max-steps-per-epoch", "2",
                         "--ckpt-interval", "1", "--img-interval", "1", "--csv-interval", "1",
                         "--data-root", str(root / "data"), "--outputs-root",
                         str(root / "outputs"), "--seed", str(seed)])
        torch.cuda.synchronize()
        hab_train_s = time.perf_counter() - t0
        hab_launches = {fn.__name__: fn.launches for fn in hab_counters}
        run = root / "outputs" / "T1"
        rows = (run / "train_log.csv").read_text().strip().splitlines()
        ck = run / "checkpoints"
        ep1, ep2 = (torch.load(ck / f"hybrid_epoch_{e}.pth", map_location="cpu",
                               weights_only=False) for e in (1, 2))
        hab_key = "hat.layers.0.residual_group.blocks.1.attn.qkv.weight"
        moved_hab = not torch.equal(ep1["net_g"][hab_key], ep2["net_g"][hab_key])
        del ep1, ep2
        log("hab-train", f"train --arch hat --bf16 --fused-hab, micro {HAT_MICRO} x accum "
                         f"{HAT_ACCUM}, 2 epochs (warmup, GAN) x 2 steps: G={last['g_total']:.5f} "
                         f"L1={last['l1']:.5f} D={last['d_total']:.5f} PSNR={last['psnr']:.4f} "
                         f"dB SSIM={last['ssim']:.5f}, {hab_train_s:.2f} s wall; launches "
                         + ", ".join(f"{k} {v}" for k, v in hab_launches.items())
                         + f"; the backbone moved in the GAN epoch: {moved_hab}; "
                         f"train_log.csv rows {len(rows) - 1}")
        result = cli_main(["infer", "--arch", "hat", "--impl", "fused", "--folder", str(run),
                           "--data-root", str(root / "data")])
        log("hab-train", f"infer --arch hat --impl fused of the trained run: "
                         f"{result['num_images']} images, PSNR={result['psnr']:.4f} dB "
                         f"SSIM={result['ssim']:.6f}")
        # per micro-batch: 24 HABs (K9a, K9c; K9b also for the 4 OCABs), 4
        # OCABs (K10a, K10b), 36 dense blocks; each of the two previews runs
        # the training forward once under no_grad (K9a, K10a, K7)
        steps = 2 * 2
        per_micro = {"hab_fwd_h": 24, "hab_bwd_mlp": 28, "hab_bwd_attn": 24, "ocab_fwd_h": 4,
                     "ocab_bwd_attn": 4, "fused_rdb_cm": 36, "fused_rdb_cm_bwd": 36}
        preview = {"hab_fwd_h": 24, "ocab_fwd_h": 4, "fused_rdb_cm": 36}
        want_hab = {k: v * HAT_ACCUM * steps + 2 * preview.get(k, 0)
                    for k, v in per_micro.items()}
        if hab_launches != want_hab:
            raise SystemExit(f"expected launches {want_hab}, counted {hab_launches}")
        if len(rows) != 3 or not moved_hab:
            raise SystemExit(f"fused-HAB train_log.csv {rows}, backbone moved {moved_hab}")
        if not all(np.isfinite(last[k]) for k in ("g_total", "l1", "d_total", "psnr", "ssim")):
            raise SystemExit(f"non-finite fused-HAB train metrics: {last}")
        if result["num_images"] != N_IMAGES or not np.isfinite(result["psnr"]):
            raise SystemExit("infer of the fused-HAB trained hybrid failed")

    # 25. the fused-HAB GAN step: patches/s, peak memory, profile
    for micro, accum in ((HAT_MICRO, HAT_ACCUM), (8, 2)):
        st = create_hat_train_state(torch.Generator().manual_seed(seed), dtype=bf, fused=True,
                                    fused_hab=True, device=device)
        stp = make_hat_train_step(st, accum_steps=accum, criterion_g=CombinedGANLoss(
            pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005, vgg_apply=vgg))
        hb = hat_batch(micro, accum)
        torch.cuda.reset_peak_memory_stats()
        key = f"fused-HAB {micro}x{accum}"
        hat_step_ms[key] = cuda_ms(lambda: stp(hb, 1e-4, 1e-4), reps=3, warmup=1, calls=1)
        hat_step_peak[key] = torch.cuda.max_memory_allocated() / 1e9
        if micro == HAT_MICRO:
            ops, busy_ms, idle = device_profile(lambda: stp(hb, 1e-4, 1e-4), steps=1)
            # K8's weight-gradient kernel is the template wgrad_kernel<F, G>;
            # K9b/K9c/K10b share swin_block_train.cu's wgrad_kernel(...)
            # K9a is the wgmma forward's hab_fwd_h_wg_kernel<NCH, HP>, K10a
            # its OCAB mode; their weight packings (K5's; K10a's 4 a step)
            # share the pack kernels' names with K9b/K9c's, whose groups
            # take them
            groups = {"K9a": ("hab_fwd_h_wg_kernel<",),
                      "K9b": ("mlp_bwd_kernel", "mlp_pack_kernel"),
                      "K9c": ("attn_wg_kernel", "attn_pack_kernel"),
                      "K10a": (r"ocab_fwd_wg_kernel<\d+, \d+, true>",),
                      "K10b": ("ocab_bwd_wg_kernel<",),
                      "K9/K10 wgrad+colsum": (r"wgrad_kernel\(", "colsum_kernel"),
                      "K7": ("conv_kernel<", "stash_x_kernel"),
                      "K8": ("stack_kernel", "wgrad_kernel<", "dx_kernel")}
            split = group_split(ops, groups, "hab-train-profile")
            ablation = [name for name, _, _ in ops if "swin_stage_wg_kernel<" in name]
            if ablation:
                raise SystemExit(f"[hab-train-profile] the fused-HAB step ran K13's ablation "
                                 f"modes: {ablation}")
            split["rest"] = sum(t for _, t, _ in ops) - sum(split.values())
            log("hab-train-profile",
                f"fused-HAB hybrid GAN step, micro {micro} x accum {accum} on {card}: device "
                f"busy {busy_ms:.3f} ms per step, idle share {idle:.4f}, device ops per step "
                f"{sum(n for _, _, n in ops)}; by kernel group per step: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
                + "; top device ops: " + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                                                    for name, t, n in ops[:10])
                + "; top host ops by self time: " + "; ".join(
                    f"{name[:50]} {t:.3f} ms x{n}" for name, t, n in device_profile.host[:12]))
        del st, stp, hb
        torch.cuda.empty_cache()
    log("hab-train-throughput", f"hybrid GAN step, 128->512 on {card}: " + "; ".join(
        f"{k} {int(k.split()[1].split('x')[0]) * int(k.split('x')[1]) * 1e3 / ms:.3f} patches/s "
        f"({ms:.2f} ms/step, peak {hat_step_peak[k]:.2f} GB)" for k, ms in hat_step_ms.items()))

    # 26. K11 against its plain version and the library call at the attention
    # modules' shapes
    agen = np.random.default_rng(seed + 26)

    def attention_operands(bw, heads, hd, nk, dtype=bf):
        """q, k, v as the modules pass them (views of one qkv tensor; OCAB's k
        and v views of its gathered overlap windows) and a (heads, 64, nk) bias."""
        def t(*shape, dt=dtype):
            return torch.from_numpy(agen.standard_normal(shape, dtype=np.float32)).to(device, dt)

        if nk == 64:
            qkv = t(bw, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
        else:
            q = t(bw, 64, heads, hd).transpose(1, 2)
            kv = t(bw, nk, 2, heads, hd).permute(2, 0, 3, 1, 4)
            k, v = kv[0], kv[1]
        return q, k, v, t(heads, 64, nk, dt=torch.float32) * 0.5

    def attention_work(bw, heads, hd, nk, nw=0, itemsize=2):
        """QK^T and PV FLOPs; q, k, v read and out written once, the bias and
        the (nw, 64, nk) fp32 mask read once."""
        flops = 4 * bw * heads * 64 * nk * hd
        return flops, itemsize * bw * heads * hd * (2 * 64 + 2 * nk) + 4 * (heads + nw) * 64 * nk

    shift256 = torch.from_numpy(shift_window_attn_mask(128, 128, 8, 4)).to(device)  # (256, 64, 64)
    k11 = {}
    for tag, bw, hd, nk, masked in (("swin", 768, 30, 64, False), ("hab", 2048, 15, 64, False),
                                    ("hab-shifted", 2048, 15, 64, True),
                                    ("ocab", 2048, 15, 144, False)):
        q, k, v, b_ = attention_operands(bw, 6, hd, nk)
        m_ = shift256 if masked else None
        sc = hd**-0.5
        fn = wattn.window_attention_masked if masked else wattn.window_attention_nomask
        kargs = (q, k, v, b_, m_) if masked else (q, k, v, b_)
        repacks = fn.repacks
        got = fn(*kargs, scale=sc)
        torch.cuda.synchronize()
        if fn.repacks != repacks:
            raise SystemExit(f"K11 ({tag}) repacked the modules' views: {fn.repacks - repacks}")
        want = wattn.window_attention_reference(q, k, v, b_, m_, scale=sc)
        rel = rel_l2(got, want)
        err_ = (got.float() - want.float()).abs().max().item()
        # the one PyTorch call for the same function: SDPA on q * scale with
        # the bias (+ the mask, window b taking mask[b % nW]) as its float
        # mask, built outside the timing
        qs = q * torch.tensor(sc, dtype=bf, device=device)
        if masked:
            nwin = m_.shape[0]
            lib_mask = (b_[None] + m_[:, None]).to(bf)  # (nW, heads, 64, 64)
            lq, lk, lv = (t_.reshape(bw // nwin, nwin, 6, -1, hd) for t_ in (qs, k, v))
        else:
            lib_mask, (lq, lk, lv) = b_.to(bf), (qs, k, v)
        lib = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lib_mask, scale=1.0)
        lib_rel = rel_l2(lib.reshape(got.shape), want)
        k11[tag] = {
            "rel": rel, "err": err_, "lib_rel": lib_rel,
            "ms": cuda_ms(lambda: fn(*kargs, scale=sc)),
            "plain_ms": cuda_ms(lambda: wattn.window_attention_reference(q, k, v, b_, m_,
                                                                         scale=sc), reps=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=lib_mask, scale=1.0), reps=10),
            "bound": least_ms(attention_work(bw, 6, hd, nk, shift256.shape[0] if masked else 0)),
        }
        r = k11[tag]
        log("k11", f"{tag}: Bw={bw} heads=6 64x{nk} d={hd}{' masked nW=256' if masked else ''} "
                   f"bf16 on {card}: rel L2 vs plain {rel:.3e} (bound {K11_REL_L2}), max abs "
                   f"{err_:.3e}; kernel {r['ms']:.4f} ms (bound {r['bound'][0]:.4f} ms, "
                   f"{r['bound'][1]}), plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
                   f"(its rel L2 vs plain {lib_rel:.3e})")
        if not (torch.isfinite(got).all() and rel <= K11_REL_L2):
            raise SystemExit(f"K11 ({tag}) disagrees with its plain version: {rel}")
        del q, k, v, b_, got, want, qs, lq, lk, lv, lib, lib_mask
    q, k, v, b_ = attention_operands(256, 6, 30, 64, dtype=torch.float32)
    got = wattn.window_attention_nomask(q, k, v, b_, scale=30**-0.5)
    torch.cuda.synchronize()
    f32_err = (got - wattn.window_attention_reference(q, k, v, b_, scale=30**-0.5)).abs().max()
    try:
        wattn.window_attention(q.requires_grad_(), k, v, b_, scale=30**-0.5, impl="pallas")
        raised = False
    except RuntimeError:
        raised = True
    log("k11", f"fp32 Bw=256 heads=6 64x64 d=30: max|kernel-plain|={f32_err.item():.3e} (bound "
               f"{K11_FP32_TOL}); the mask-less instantiation is K11a's and K11c's; "
               f"raises under autograd: {raised}")
    if not f32_err.item() <= K11_FP32_TOL or not raised:
        raise SystemExit(f"K11 fp32 disagrees ({f32_err.item()}) or did not raise ({raised})")
    del q, k, v, b_, got

    # 27. K12 against its plain version and K7 at config #2's trunk shape
    kgen12 = np.random.default_rng(seed + 27)
    xr = torch.from_numpy(0.5 * kgen12.standard_normal((HYBRID_BATCH, 256, 256, f)).astype(
        np.float32)).to(device, bf)
    ks = [torch.from_numpy((kgen12.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                            * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32)).to(device)
          for i in range(5)]
    bs = [torch.from_numpy((0.05 * kgen12.standard_normal(g if i < 4 else f)).astype(np.float32))
          .to(device) for i in range(5)]
    packed7 = rdb_cm.pack_rdb_cm_weights(ks, bs, device)  # K7's packing serves K12 too
    xcm = xr.permute(0, 3, 1, 2).reshape(HYBRID_BATCH, f, 256 * 256).contiguous()
    got = rdb_nhwc.fused_rdb(xr, ks, bs, packed=packed7)
    torch.cuda.synchronize()
    want = rdb_nhwc.rdb_nhwc_reference(xr, ks, bs)
    k12_err = (got.float() - want.float()).abs().max().item()
    k12_rel = rel_l2(got, want)
    # K12 runs K7's convs on K7's packing, only x read in another layout:
    # held to K1's bound, and whether the bits are the same is printed
    k7cm = fused_rdb_cm(xcm, ks, bs, **rkw, packed=packed7).reshape(
        HYBRID_BATCH, f, 256, 256).permute(0, 2, 3, 1)
    k12_k7_err = (got.float() - k7cm.float()).abs().max().item()
    k12_k7_bound = K1_TOL * max(1.0, k7cm.float().abs().max().item())
    k12_k7_same = torch.equal(got, k7cm)
    del k7cm
    k12_split = kernel_split(lambda: rdb_nhwc.fused_rdb(xr, ks, bs, packed=packed7))
    k12_split_counts = kernel_split.counts
    k12_times = (cuda_ms(lambda: rdb_nhwc.fused_rdb(xr, ks, bs, packed=packed7), reps=10),
                 cuda_ms(lambda: rdb_nhwc.rdb_nhwc_reference(xr, ks, bs), reps=5, warmup=1,
                         calls=2))
    k7_same_run = cuda_ms(lambda: fused_rdb_cm(xcm, ks, bs, **rkw, packed=packed7), reps=10)
    k12_bound = least_ms(hat_work()["K7"])
    log("k12", f"B={HYBRID_BATCH} 256x256 F={f} G={g} NHWC bf16 on {card}: rel L2 vs plain "
               f"{k12_rel:.3e} (bound {K12_REL_L2}), max abs {k12_err:.3e}; max|K12-K7|="
               f"{k12_k7_err:.3e} (bound {k12_k7_bound:.3e}); K12 {k12_times[0]:.4f} ms (bound "
               f"{k12_bound[0]:.4f} ms, "
               f"{k12_bound[1]}), plain {k12_times[1]:.4f} ms, K7 in this run "
               f"{k7_same_run:.4f} ms; the same bits as K7: {k12_k7_same}")
    log("k12", "device ms per call by kernel: " + ", ".join(
        f"{short_name(name)} {t:.4f} (x{k12_split_counts[name]})"
        for name, t in k12_split.items()))
    if not (torch.isfinite(got).all() and k12_rel <= K12_REL_L2 and k12_k7_err <= k12_k7_bound):
        raise SystemExit(f"K12 disagrees: rel L2 {k12_rel}, against K7 {k12_k7_err}")
    del xr, xcm, ks, bs, got, want, packed7
    torch.cuda.empty_cache()

    # 28. the attention modules with attn_impl="pallas" (K11's main path:
    # counts from 0 before each forward, read after it)
    k11_counters = (wattn.window_attention_nomask, wattn.window_attention_masked)
    k11_launches = {}
    x3 = x.repeat(3, 1, 1, 1)
    swin32 = SwinIR(**FLAGSHIP, generator=torch.Generator().manual_seed(seed)).to(device).eval()
    swin_p = SwinIR(**FLAGSHIP, attn_impl="pallas").to(device, bf).eval()
    swin_p.load_state_dict(swin32.state_dict())
    swin_x = copy.deepcopy(swin32).to(bf)
    swin_fused = make_fused_swinir(swin32)
    with torch.no_grad():
        ref = swin32(x)
        for fn in k11_counters:
            fn.launches = fn.repacks = 0
        swin_p(x3.to(bf))
        torch.cuda.synchronize()
        k11_launches["swin"] = {fn.__name__: fn.launches for fn in k11_counters}
        k11_repacks = sum(fn.repacks for fn in k11_counters)
        rel_p = rel_l2(swin_p(x.to(bf)), ref)
        rel_x = rel_l2(swin_x(x.to(bf)), ref)
        swin_ms = {name: cuda_ms(lambda: fwd(x3), reps=10, warmup=2, calls=2) for name, fwd in (
            ("pallas", lambda v: swin_p(v.to(bf))), ("xla", lambda v: swin_x(v.to(bf))),
            ("fused K1", swin_fused))}
    log("attn-module", f"SwinIR config #1, batch 3, 128->512 on {card}: launches per forward "
        f"{k11_launches['swin']}, q/k/v repacked {k11_repacks}; rel L2 to the fp32 module: "
        f"attn_impl='pallas' bf16 {rel_p:.3e}, 'xla' bf16 {rel_x:.3e} (bound {FORWARD_REL_L2}); "
        "patches/s "
        + ", ".join(f"{k} {3e3 / ms:.3f} ({ms:.3f} ms)" for k, ms in swin_ms.items()))
    if k11_launches["swin"] != {"window_attention_nomask": 36, "window_attention_masked": 0}:
        raise SystemExit(f"expected 36 mask-less K11 launches, counted {k11_launches['swin']}")
    if k11_repacks:
        raise SystemExit(f"the pallas SwinIR's K11 launches repacked {k11_repacks} operands")
    if not rel_p <= FORWARD_REL_L2:
        raise SystemExit(f"the pallas SwinIR disagrees with the fp32 module: {rel_p}")
    del swin32, swin_p, swin_x, swin_fused, ref, x3

    hybrid = HybridHATRealESRGAN(**HYBRID, generator=torch.Generator().manual_seed(seed))
    hybrid = hybrid.to(device).eval()
    hyb_p = HybridHATRealESRGAN(**HYBRID, attn_impl="pallas").to(device, bf).eval()
    hyb_p.load_state_dict(hybrid.state_dict())
    hyb_x = copy.deepcopy(hybrid).to(bf)
    x8 = x.repeat(HYBRID_BATCH, 1, 1, 1)
    # the OCABs' share of the mask-less launches (64 x 144, the rest are the
    # unshifted HABs' 64 x 64), counted as OCAB forwards in the same run
    ocab_calls = [0]

    def count_ocab(*_):
        ocab_calls[0] += 1

    hooks = [m.register_forward_hook(count_ocab) for m in hyb_p.modules()
             if isinstance(m, OCAB)]
    with torch.no_grad():
        ref = hybrid(x)
        for fn in k11_counters:
            fn.launches = fn.repacks = 0
        hyb_p(x8.to(bf))
        torch.cuda.synchronize()
        k11_launches["hybrid"] = {fn.__name__: fn.launches for fn in k11_counters}
        k11_repacks = sum(fn.repacks for fn in k11_counters)
        k11_ocab = ocab_calls[0]
        for hook in hooks:
            hook.remove()
        rel_p = rel_l2(hyb_p(x.to(bf)), ref)
        rel_x = rel_l2(hyb_x(x.to(bf)), ref)
        hyb_ms = {name: cuda_ms(lambda: fwd(x8.to(bf)), reps=5, warmup=2, calls=2)
                  for name, fwd in (("pallas", hyb_p), ("xla", hyb_x))}
    log("attn-module", f"hybrid config #2, batch {HYBRID_BATCH}, 128->512 on {card}: launches "
        f"per forward {k11_launches['hybrid']} ({k11_ocab} of the mask-less at OCAB's 64x144), "
        f"q/k/v repacked {k11_repacks}; "
        f"rel L2 to the fp32 module: attn_impl='pallas' "
        f"bf16 {rel_p:.3e}, 'xla' bf16 {rel_x:.3e} (bound max({FORWARD_REL_L2}, 2x)); patches/s "
        + ", ".join(f"{k} {HYBRID_BATCH * 1e3 / ms:.3f} ({ms:.3f} ms)" for k, ms in hyb_ms.items()))
    # per forward: 12 unshifted HABs and 4 OCABs mask-less, 12 shifted HABs masked
    if k11_launches["hybrid"] != {"window_attention_nomask": 16, "window_attention_masked": 12}:
        raise SystemExit(f"expected 16 + 12 K11 launches, counted {k11_launches['hybrid']}")
    if k11_ocab != 4:
        raise SystemExit(f"expected 4 of the mask-less K11 launches at OCAB's, counted {k11_ocab}")
    if k11_repacks:
        raise SystemExit(f"the pallas hybrid's K11 launches repacked {k11_repacks} operands")
    if not rel_p <= max(FORWARD_REL_L2, 2 * rel_x):
        raise SystemExit(f"the pallas hybrid disagrees with the fp32 module: {rel_p} vs {rel_x}")
    del hyb_p, hyb_x

    # 29. make_fused_hybrid(trunk_impl="kernel") (K12's main path: counts from 0)
    fused_k = make_fused_hybrid(hybrid, trunk_impl="kernel")
    fused_c = make_fused_hybrid(hybrid)
    with torch.no_grad():
        rdb_nhwc.fused_rdb.launches = 0
        fused_k(x8)
        torch.cuda.synchronize()
        k12_launches = rdb_nhwc.fused_rdb.launches
        got = fused_k(x).float()
    rel_k = rel_l2(got, ref)
    trunk_ms = {"kernel (K12)": cuda_ms(lambda: fused_k(x8), reps=5, warmup=2, calls=2),
                "cm (K7)": cuda_ms(lambda: fused_c(x8), reps=5, warmup=2, calls=2)}
    log("k12-hybrid", f"make_fused_hybrid trunk_impl='kernel', batch {HYBRID_BATCH} on {card}: "
        f"{k12_launches} K12 launches per forward; rel L2 to the fp32 module {rel_k:.3e} (bound "
        f"max({FORWARD_REL_L2}, 2x the bf16 module's {rel_x:.3e})); patches/s "
        + ", ".join(f"{k} {HYBRID_BATCH * 1e3 / ms:.3f} ({ms:.3f} ms)" for k, ms in trunk_ms.items()))
    if k12_launches != 36:
        raise SystemExit(f"expected 36 K12 launches per forward, counted {k12_launches}")
    if not (torch.isfinite(got).all() and rel_k <= max(FORWARD_REL_L2, 2 * rel_x)):
        raise SystemExit(f"the K12 hybrid disagrees with the fp32 module: {rel_k}")
    del hybrid, fused_k, fused_c, ref, got, x8
    torch.cuda.empty_cache()

    # 30. K4b against its plain version and K3 + K4 at the flagship train shapes
    bargs = k1_inputs(torch.Generator().manual_seed(seed + 30), device, bw=bw_train)
    xw, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = bargs
    dout = (1e-2 * torch.randn(bw_train, 64, 180, generator=torch.Generator().manual_seed(
        seed + 31))).to(device, bf)
    k4b_names = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj",
                 "dln2_w", "dln2_b", "dw1", "db1", "dw2", "db2"]
    got = swin_block_bwd(xw, dout, *bargs[1:], **kw)
    again = swin_block_bwd(xw, dout, *bargs[1:], **kw)
    torch.cuda.synchronize()
    k4b_same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    want = swin_block.swin_block_bwd_reference(xw, dout, *bargs[1:], **kw)
    _, h = swin_block_fwd_h(*bargs, **kw)

    def split_bwd():
        mlp_ = swin_block_bwd_mlp(h, dout, ln2_w, ln2_b, w1, b1, w2)
        attn_ = swin_block_bwd_attn(xw, mlp_[0], ln1_w, ln1_b, wqkv, bqkv, bias, wproj, **kw)
        return (*attn_, *mlp_[1:])

    split = split_bwd()
    k4b_rel = {n: rel_l2(g_, w_) for n, g_, w_ in zip(k4b_names, got, want)}
    k4b_rel_split = {n: rel_l2(g_, s_) for n, g_, s_ in zip(k4b_names, got, split)}
    k4b_err = (got[0].float() - want[0].float()).abs().max().item()
    finite = all(torch.isfinite(g_).all() for g_ in got)
    del again, want, split
    k4b_times = (cuda_ms(lambda: swin_block_bwd(xw, dout, *bargs[1:], **kw), reps=10),
                 cuda_ms(lambda: swin_block.swin_block_bwd_reference(xw, dout, *bargs[1:], **kw),
                         reps=3, warmup=1, calls=1))
    split_ms = cuda_ms(split_bwd, reps=10)
    # the two backwards with their forwards, as each step runs them: K1
    # packing its live weights on every call, then K4b; K2, then K3 + K4
    k1_live_ms = cuda_ms(lambda: fused_swin_block(*bargs, **kw), reps=10)
    k2_ms = cuda_ms(lambda: swin_block_fwd_h(*bargs, **kw), reps=10)
    k4b_split = kernel_split(lambda: swin_block_bwd(xw, dout, *bargs[1:], **kw))
    log("k4b", f"Bw={bw_train} C=180 heads=6 hidden=720 bf16, dout ~ N(0, 1e-2): rel L2 vs "
               f"plain (bound {BWD_REL_L2}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in k4b_rel.items()))
    log("k4b", f"rel L2 vs K3 + K4 on K2's h (bound {BWD_REL_L2}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in k4b_rel_split.items())
        + f"; two runs bit-identical: {k4b_same_bits}")
    log("k4b", f"on {card}: K4b {k4b_times[0]:.4f} ms (K3 + K4 in this run {split_ms:.4f} ms), "
               f"plain {k4b_times[1]:.4f} ms; with the forward: K1 + K4b "
               f"{k1_live_ms + k4b_times[0]:.4f} ms (K1 {k1_live_ms:.4f}) against K2 + K3 + K4 "
               f"{k2_ms + split_ms:.4f} ms (K2 {k2_ms:.4f})")
    log("k4b", "K4b device ms per call by kernel (its three phases, their weight packings, "
               "the weight-gradient products and column sums; launches the profiler recorded "
               "over 10 calls): " + ", ".join(
                   f"{short_name(name)} {t:.4f} (x{kernel_split.counts[name]})"
                   for name, t in k4b_split.items()))
    log("k4b", "ptxas (NCH=3, HP=32, the flagship's): " + "; ".join(
        f"{key} {ptxas_stats(_build.build_log('swin_block_bwd'), frag)}" for key, frag in (
            ("swin_fwd_h32_wg_kernel", "swin_fwd_h32_wg_kernelILi3ELi32E"),
            ("mlp_bwd_f32_kernel", "mlp_bwd_f32_kernelILi3E"),
            ("attn_wg_f32_kernel", "attn_wg_f32_kernelILi3ELi32E")))
        + f"; dynamic shared memory, the largest phase's: "
          f"{swin_block._bwd_library().swin_bwd_block_smem_bytes(180, 6, 720)} B")
    if any(kind_ in name for name in k4b_split for kind_ in ("block_bwd_kernel",
                                                               "swin_stage_wg_kernel<")):
        raise SystemExit(f"K4b ran a first-design kernel or K13's ablation modes: "
                         f"{list(k4b_split)}")
    if not (finite and k4b_same_bits):
        raise SystemExit(f"K4b non-finite ({not finite}) or not reproducible")
    bad = {k: v for k, v in {**k4b_rel, **{f"{k} vs split": v for k, v in k4b_rel_split.items()}
                             }.items() if not v <= BWD_REL_L2}
    if bad:
        raise SystemExit(f"K4b disagrees: {bad}")
    del bargs, xw, dout, got, h, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, ln2_w, ln2_b, w1, b1, w2
    torch.cuda.empty_cache()

    # 31. the fused SwinIR GAN step with the recompute backward (K4b's main
    # path: counts from 0 before one step, read after it)
    model.train()
    model16 = copy.deepcopy(model).to(torch.bfloat16)
    probe = torch.randn(1, 512, 512, 1, generator=torch.Generator().manual_seed(seed + 32))
    probe = probe.to(device)
    checked = ["conv_first.weight", "layers.0.0.attn.qkv.weight",
               "layers.0.0.attn.relative_position_bias_table", "layers.5.5.mlp.fc2.weight",
               "layers.3.2.norm1.weight"]

    def grads31(forward, net, dtype):
        xi = x.clone().to(dtype).requires_grad_()
        net.zero_grad()
        (forward(xi).float() * probe).sum().backward()
        named = dict(net.named_parameters())
        return [xi.grad.float()] + [named[k].grad.float() for k in checked]

    want_g = grads31(model, model, torch.float32)
    ref16 = grads31(model16, model16, torch.bfloat16)
    got_g = grads31(make_fused_swinir(model, differentiable=True, backward="recompute"), model,
                    torch.float32)
    lines = []
    for name, g_, w_, r_ in zip(["input", *checked], got_g, want_g, ref16):
        g_err, g_err16 = rel_l2(g_, w_), rel_l2(r_, w_)
        lines.append(f"{name} {g_err:.3e} (nn.Module bf16 {g_err16:.3e})")
        if not (torch.isfinite(g_).all() and g_err <= max(GRAD_REL_L2, 2 * g_err16)):
            raise SystemExit(f"recompute gradient of {name} disagrees: {g_err} vs {g_err16}")
    log("k4b-train", "fused bf16 recompute vs fp32 autograd, rel L2 (bound max(%g, 2x "
        "nn.Module bf16)): " % GRAD_REL_L2 + ", ".join(lines))
    del model16, want_g, ref16, got_g
    model.zero_grad(set_to_none=True)
    step_counters = (fused_swin_block, swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn,
                     swin_block_bwd)
    crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005,
                           vgg_apply=vgg)
    step31_ms, step31_peak, step31_launches = {}, {}, {}
    for i, how in enumerate(("split", "recompute", "recompute", "split")):
        state = create_swin_train_state(torch.Generator().manual_seed(seed), dtype=bf,
                                        fused=True, device=device, backward=how)
        step = make_swin_train_step(state, accum_steps=1, criterion_g=crit)
        if i < 2:
            for fn in step_counters:
                fn.launches = 0
            step(batch, 1e-4, 1e-4)
            torch.cuda.synchronize()
            step31_launches[how] = {fn.__name__: fn.launches for fn in step_counters}
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(batch, 1e-4, 1e-4), reps=3, warmup=1, calls=2)
        step31_ms.setdefault(how, []).append(ms)
        step31_peak.setdefault(how, []).append(torch.cuda.max_memory_allocated() / 1e9)
        del state, step
        torch.cuda.empty_cache()
    # one recompute step under the profiler: its device time by kernel group
    state = create_swin_train_state(torch.Generator().manual_seed(seed), dtype=bf, fused=True,
                                    device=device, backward="recompute")
    step = make_swin_train_step(state, accum_steps=1, criterion_g=crit)
    step(batch, 1e-4, 1e-4)
    ops, busy_ms, idle = device_profile(lambda: step(batch, 1e-4, 1e-4), steps=1)
    # K1 and K4b's first and third phases share the packing kernels (their
    # own group); the weight-gradient products and column sums are K4b's
    groups31 = {"K1": ("swin_fwd_wg_kernel<3, 32, false>",),
                "K4b recompute": ("swin_fwd_h32_wg_kernel<",),
                "K4b MLP phase": ("mlp_bwd_f32_kernel<",),
                "K4b attention phase": ("attn_wg_f32_kernel<",),
                "K1/K4b weight packings": ("attn_pack_kernel", "mlp_pack_kernel"),
                "K4b wgrad+colsum": (r"wgrad_kernel\(", "colsum_kernel")}
    split31 = group_split(ops, groups31, "k4b-train")
    first_design = [name for name, _, _ in ops
                    if "block_bwd_kernel" in name or "swin_stage_wg_kernel<" in name]
    log("k4b-train", f"recompute step under torch.profiler on {card}: device busy {busy_ms:.3f} "
        f"ms, idle share {idle:.4f}; by kernel group: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split31.items())
        + "; top device ops: " + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                                           for name, t, n in ops[:8]))
    if first_design:
        raise SystemExit(f"[k4b-train] the recompute step ran a first-design kernel or K13's "
                         f"ablation modes: {first_design}")
    del state, step
    torch.cuda.empty_cache()
    k4b_launches = step31_launches["recompute"]["swin_block_bwd"]
    log("k4b-train", f"launches in one GAN step: " + "; ".join(
        f"{how}: " + ", ".join(f"{k} {v}" for k, v in c.items())
        for how, c in step31_launches.items()))
    log("k4b-train", f"fused GAN step, micro {MICRO} x accum 1, 128->512 on {card}, alternated "
        "split, recompute, recompute, split: " + "; ".join(
            f"{how} " + ", ".join(f"{MICRO * 1e3 / ms:.3f} patches/s ({ms:.2f} ms/step, peak "
                                  f"{gb:.3f} GB)" for ms, gb in zip(step31_ms[how],
                                                                   step31_peak[how]))
            for how in step31_ms))
    want_counts = {"split": {"fused_swin_block": 0, "swin_block_fwd_h": 36,
                             "swin_block_bwd_mlp": 36, "swin_block_bwd_attn": 36,
                             "swin_block_bwd": 0},
                   "recompute": {"fused_swin_block": 36, "swin_block_fwd_h": 0,
                                 "swin_block_bwd_mlp": 0,
                                 "swin_block_bwd_attn": 0, "swin_block_bwd": 36}}
    for how, want_c in want_counts.items():
        if any(step31_launches[how][k] != v for k, v in want_c.items()):
            raise SystemExit(f"{how} step launched {step31_launches[how]}, expected {want_c}")
    del crit

    # 32. K13 in its nine modes against its plain version, on K1's operands
    # (where the activations differ) and on the ablation tool's, then the
    # tool (K13's main path: counts from 0)
    skw = dict(num_heads=6, scale=30**-0.5)
    zero_coef = np.zeros(26, np.float32)  # a polygelu whose erf is 0: u / 2
    k13 = {}
    k1_ops = k1_inputs(torch.Generator().manual_seed(seed + 33), device, bw=bw_train)
    for tag, (x13, w13) in (("K1's", (k1_ops[0], k1_ops[1:])),
                            ("the tool's", ablation_tool.operands(bw_train, device))):
        # the weights packed once, as the tool packs them
        p13 = ablation_tool.packed_weights(w13)
        # K1 against the plain version of the mode that computes its function
        k1_13 = fused_swin_block(x13, *w13, **skw, packed=p13)
        k1_rel = rel_l2(k1_13, stage.swin_stage_block_reference(x13, *w13, mode="mlp_tanhgelu",
                                                                **skw))
        runs = [(mode, mode, None) for mode in stage.MODES]
        runs.append(("mlp_polygelu, zero coefficients", "mlp_polygelu", zero_coef))
        outs13 = {}
        for name, mode, coef in runs:
            got = swin_stage_block(x13, *w13, mode=mode, erf_coef=coef, **skw, packed=p13)
            torch.cuda.synchronize()
            want = stage.swin_stage_block_reference(x13, *w13, mode=mode, erf_coef=coef, **skw)
            k13[f"{name} on {tag}"] = {
                "rel": rel_l2(got, want), "err": (got.float() - want.float()).abs().max().item(),
                "finite": bool(torch.isfinite(got).all())}
            outs13[name] = got
            del want
        # mlp_tanhgelu launches K1's own instantiation: K1's bits; packing
        # on the call gives the bits of the weights packed once
        k13_same_k1 = torch.equal(outs13["mlp_tanhgelu"], k1_13)
        k13_packed_same = torch.equal(outs13["full"], swin_stage_block(x13, *w13, mode="full",
                                                                       **skw))
        del k1_13
        k13_allheads = torch.equal(outs13["allheads"], outs13["full"])
        if tag == "K1's":
            # the check's power: the activations it must tell apart lie
            # further apart than its bound
            apart = {f"{a} vs {b}": rel_l2(outs13[a], outs13[b]) for a, b in
                     itertools.combinations(["full", "mlp_tanhgelu", "mlp_siggelu", "mlp_nogelu",
                                             "mlp_polygelu, zero coefficients"], 2)}
            log("k13", "distances between modes on K1's operands (each must exceed "
                f"{K13_REL_L2}): " + ", ".join(f"{k} {v:.3e}" for k, v in apart.items()))
            if min(apart.values()) <= K13_REL_L2:
                raise SystemExit(f"K13's check cannot tell its modes apart: {apart}")
        del outs13
        log("k13", f"Bw={bw_train} C=180 heads=6 hidden=720 bf16 on {tag} operands: rel L2 vs "
                   f"plain (bound {K13_REL_L2}): " + ", ".join(
                       f"{m.removesuffix(' on ' + tag)} {r['rel']:.3e}"
                       for m, r in k13.items() if m.endswith(tag))
            + f"; K1's rel L2 to mlp_tanhgelu's plain version {k1_rel:.3e}; mlp_tanhgelu == "
              f"K1: {k13_same_k1}; allheads == full: {k13_allheads}; full on weights packed "
              f"once == packing on the call: {k13_packed_same}")
        bad = {m: r for m, r in k13.items() if not (r["finite"] and r["rel"] <= K13_REL_L2)}
        if bad or not (k13_same_k1 and k13_allheads and k13_packed_same):
            raise SystemExit(f"K13 disagrees: {bad}, K1's bits {k13_same_k1}, allheads "
                             f"{k13_allheads}, packed once {k13_packed_same}")
    del k1_ops
    # on the weights packed once, as the tool runs it
    k13_times = (cuda_ms(lambda: swin_stage_block(x13, *w13, mode="full", **skw, packed=p13),
                         reps=10),
                 cuda_ms(lambda: stage.swin_stage_block_reference(x13, *w13, mode="full", **skw),
                         reps=5, warmup=1, calls=2))
    k13_tanh_ms = cuda_ms(lambda: swin_stage_block(x13, *w13, mode="mlp_tanhgelu", **skw,
                                                   packed=p13), reps=10)
    k1_2048 = cuda_ms(lambda: fused_swin_block(x13, *w13, **skw, packed=p13), reps=10)
    log("k13", f"on {card}, the tool's operands, weights packed once: full "
               f"{k13_times[0]:.4f} ms, its plain version {k13_times[1]:.4f} ms, mlp_tanhgelu "
               f"{k13_tanh_ms:.4f} ms, K1 {k1_2048:.4f} ms")
    del x13, w13, p13
    swin_stage_block.launches = 0
    k13_per_block = ablation_tool.main(list(stage.MODES))
    k13_launches = swin_stage_block.launches
    log("k13", f"tools/swin_stage_ablation.py over the nine modes: {k13_launches} K13 launches; "
               "ms per block: " + ", ".join(f"{m} {v:.4f}" for m, v in k13_per_block.items()))
    # per mode one untimed and five timed 36-block chains, and the two
    # allheads-vs-full parity calls
    if k13_launches != len(stage.MODES) * 6 * 36 + 2:
        raise SystemExit(f"expected {len(stage.MODES) * 6 * 36 + 2} K13 launches, counted "
                         f"{k13_launches}")

    # 33.-34. the dataset prep and the tiled upscale of a whole frame, with
    # 37.-38. the spatial forwards and upscale --mesh/--spatial on its frame
    prep_phase(seed, device, card)
    upscale_phase(seed, device, card)
    # 35.-36. the data-parallel steps and trainer in a world of one
    dp_step_phase(seed, device, card)
    dp_train_phase(seed, device, card)
    # 39. the epoch loops' steps: no host sync, the NaN guard on the card
    run_loop_phase(seed, device, card)
    # 40. the convergence path: synthetic skies, the native codec, a VGG19 .pth
    learns_phase(seed, device, card)
    # 41. rematerialization against the plain steps, and the hybrid's D alone
    remat_phase(seed, device, card)

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
    # K9's times are the means of their unshifted and shifted calls, half
    # each on the main path
    for name, key, src, line in (("hab_fwd_h", "K9a", "hab_block.cu", 373),
                                 ("hab_bwd_mlp", "K9b", "swin_block_train.cu", 400),
                                 ("hab_bwd_attn", "K9c", "swin_block_train.cu", 433)):
        rows.append((name, key, src, line, hab_launches[name], max(m[key] for m in max9.values()),
                     tuple(statistics.mean(t9[tag][key][i] for tag in t9) for i in (0, 1))))
    for name, key, src, line in (("ocab_fwd_h", "K10a", "ocab.cu", 130),
                                 ("ocab_bwd_attn", "K10b", "ocab_train.cu", 265)):
        rows.append((name, key, src, line, hab_launches[name], max10[key], t10[key]))
    # K11's mask-less numbers are the means over [attn-module]'s mask-less
    # calls, weighted by their counted launches (36 at SwinIR's shape, 12 at
    # HAB's, 4 at OCAB's): one instantiation serves K11a and K11c
    nomask = {"swin": k11_launches["swin"]["window_attention_nomask"],
              "hab": k11_launches["hybrid"]["window_attention_nomask"] - k11_ocab,
              "ocab": k11_ocab}
    n_nomask = sum(nomask.values())

    def k11_mean(field):
        return sum(n * k11[tag][field] for tag, n in nomask.items()) / n_nomask

    k11_nomask = (n_nomask, max(k11[t]["err"] for t in nomask),
                  (k11_mean("ms"), k11_mean("plain_ms")))
    n_masked = k11_launches["hybrid"]["window_attention_masked"]
    rows += [
        ("window_attention_nomask", "K11a", "window_attention.cu", 139, *k11_nomask),
        ("window_attention_masked", "K11b", "window_attention.cu", 186, n_masked,
         k11["hab-shifted"]["err"], (k11["hab-shifted"]["ms"], k11["hab-shifted"]["plain_ms"])),
        ("window_attention_nomask", "K11c", "window_attention.cu", 178, *k11_nomask),
        ("fused_rdb", "K12", "fused_rdb.cu", 231, k12_launches, k12_err, k12_times),
        ("swin_block_bwd", "K4b", "swin_block_bwd.cu", 847, k4b_launches, k4b_err, k4b_times),
        # K13's time and plain time are its "full" mode's, the whole block
        ("swin_stage_block", "K13", "swin_stage_ablation.cu", 219, k13_launches,
         max(r["err"] for r in k13.values()), k13_times),
    ]
    bounds = {"K11a": (sum(n * k11[t]["bound"][0] for t, n in nomask.items()) / n_nomask,
                       "bytes"),
              "K11b": k11["hab-shifted"]["bound"], "K12": k12_bound}
    bounds["K11c"] = bounds["K11a"]
    library = {"K11a": k11_mean("library_ms"), "K11b": k11["hab-shifted"]["library_ms"]}
    library["K11c"] = library["K11a"]
    work.update({k: v for k, v in work_t.items() if k.startswith(("K9", "K10"))})
    work["K13"] = block_work(bw_train)["K1"]  # K1's work at the tool's 2048 windows
    replaced = {"K5": SWIN, "K6": "superresolution_def_tpu/kernels/ocab.py",
                "K7": "superresolution_def_tpu/kernels/fused_rdb_cm.py",
                "K8": "superresolution_def_tpu/kernels/fused_rdb_cm_bwd.py",
                "K9a": "superresolution_def_tpu/kernels/hab_train.py",
                "K9b": "superresolution_def_tpu/kernels/hab_train.py",
                "K9c": "superresolution_def_tpu/kernels/hab_train.py",
                "K10a": "superresolution_def_tpu/kernels/ocab_train.py",
                "K10b": "superresolution_def_tpu/kernels/ocab_train.py",
                "K11a": "superresolution_def_tpu/kernels/window_attention.py",
                "K11b": "superresolution_def_tpu/kernels/window_attention.py",
                "K11c": "superresolution_def_tpu/kernels/window_attention.py",
                "K12": "superresolution_def_tpu/kernels/fused_rdb.py",
                "K13": "scripts/swin_stage_ablation.py"}
    records = []
    for name, key, src, line, n, e, (ms, pms) in rows:
        bms, by = bounds[key] if key in bounds else least_ms(work[key])
        records.append({
            "name": name, "route": "cuda",
            "source": f"superresolution_def_tpu_torch/csrc/{src}",
            "replaces": f"{replaced.get(key, SWIN)}:{line}", "launches": n, "max_abs_err": e,
            "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            # SDPA computes K11's function; no single PyTorch call computes a
            # whole Swin/HAB block (K13's modes included), its backward, an
            # OCAB tail, a dense block or its backward
            "library_ms": library.get(key),
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
