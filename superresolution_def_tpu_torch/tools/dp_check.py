"""Check and time the parallel layer across the ranks of a torchrun world.

    torchrun --nproc-per-node N -m superresolution_def_tpu_torch.tools.dp_check \
        [--device cuda|cpu] [--small] [--steps 2]

On N cards (NCCL; ``--device cpu``: gloo processes) it runs, each part
against rank 0 alone:

- [dp-ranks] one SwinIR GAN step (``make_swin_train_step(mesh=)``, micro 8
  a rank, bf16 and the fused K2/K3/K4 on the cards) against rank 0's plain
  step on the concatenated batch from the same start: every rank's G, D
  (with u, v) and EMA the same bits; the losses within rtol 2e-4; in every
  tensor the weights' largest distance at most 2.1e-4 (AdamW's first step
  moves a weight by about lr either way) and at most 2% of the entries
  apart by more than 1e-6 (a wrong gradient moves many entries the other
  way), the rule of ``tests/test_torch_train_step.py::_assert_weights``;
- [dp-scale] ms a step of that DP step (the slowest rank's) against rank
  0's plain step at the same micro-batch, alternated (plain, DP, DP,
  plain), and patches/s: the world's and one card's;
- [spatial-ranks] ``make_spatial_swinir`` (the flagship SwinIR) and
  ``make_spatial_hybrid`` (config #2), fp32, ``attn_impl="pallas"`` on the
  cards, on a 512 x 640 frame H-sharded over the ranks, against rank 0's
  module forward (relative L2 at most 1e-5), with both wall times;
- [mesh-ranks] ``tiled_sr(mesh=)`` of the SwinIR against rank 0's
  ``tiled_sr`` (the tile batches split over the ranks; relative L2 at most
  1e-5), with both wall times.

``--small`` takes tiny widths and a 64 x 48 frame (a CPU rehearsal). Rank 0
prints a line a part and, last, one JSON object with every number; the
exit code is 1 if a check failed. TF32 is off.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..cli.infer import tiled_sr
from ..models import HybridHATRealESRGAN, SwinIR
from ..parallel import (
    initialize_distributed,
    make_mesh,
    make_spatial_hybrid,
    make_spatial_swinir,
)
from ..parallel.mesh import barrier
from ..train import CombinedGANLoss, VGG19Features, create_swin_train_state, make_swin_train_step

FULL = {
    "swin": dict(img_size=128, embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                 window_size=8, mlp_ratio=4.0, upscale=4),
    "hybrid": dict(img_size=128, in_chans=1, embed_dim=90, depths=(6,) * 4,
                   num_heads=(6,) * 4, window_size=8, num_rrdb=12, num_feat=48,
                   num_grow_ch=24),
    "lr": 128, "micro": 8, "frame": (512, 640), "tile": 128, "overlap": 16,
}
SMALL = {
    "swin": dict(img_size=16, embed_dim=16, depths=(2,), num_heads=(2,), window_size=8,
                 mlp_ratio=2.0, upscale=4),
    "hybrid": dict(img_size=16, in_chans=1, embed_dim=30, depths=(2,), num_heads=(6,),
                   window_size=8, num_rrdb=1, num_feat=16, num_grow_ch=8),
    "lr": 16, "micro": 2, "frame": (64, 48), "tile": 32, "overlap": 4,
}
# against one card: the weights as tests/test_torch_train_step.py::_assert_weights
# holds them, the losses as tests/test_parallel.py does
WEIGHT_BOUND = 2.1e-4  # AdamW's first step: about lr = 1e-4 either way
SHARE_BOUND = 0.02     # of a tensor's entries apart by more than 1e-6
LOSS_RTOL = 2e-4
SPATIAL_REL_L2 = 1e-5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bits_checksums(state, device) -> torch.Tensor:
    """One int64 a tensor of G, D and EMA: the sum of its bits as integers."""
    sums = []
    for part in ("g", "d", "ema"):
        for t in getattr(state, part).state_dict().values():
            t = t.detach().contiguous().float()
            sums.append(t.view(torch.int32).to(torch.int64).sum())
    return torch.stack(sums).to(device)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def dp_ranks(mesh, cfg, steps: int, out: dict) -> bool:
    """[dp-ranks] and [dp-scale]."""
    device, world, micro, lr = mesh.device, mesh.size, cfg["micro"], cfg["lr"]
    cuda = device.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    vgg = VGG19Features(35, dtype=dtype).to(device).requires_grad_(False)

    def state_and_step(dp):
        state = create_swin_train_state(torch.Generator().manual_seed(0), **cfg["swin"],
                                        dtype=dtype, fused=cuda, device=device)
        crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                               adversarial_weight=0.005, vgg_apply=vgg)
        return state, make_swin_train_step(state, accum_steps=1, criterion_g=crit,
                                           generator=torch.Generator().manual_seed(1),
                                           mesh=mesh if dp else None)

    rng = np.random.default_rng(2)

    def batch(n):  # the same on every rank
        return {"lr": rng.integers(0, 65535, (1, n, lr, lr, 1), dtype=np.uint16),
                "hr": rng.integers(0, 65535, (1, n, 4 * lr, 4 * lr, 1), dtype=np.uint16)}

    def rows(b):
        return {k: v[:, mesh.rank * micro:(mesh.rank + 1) * micro] for k, v in b.items()}

    full = batch(micro * world)
    state, step = state_and_step(True)
    m_dp = {k: float(v) for k, v in step(rows(full), 1e-4, 1e-4).items()}
    sums = _bits_checksums(state, device)
    gathered = [sums]
    if mesh.group is not None:
        gathered = [torch.empty_like(sums) for _ in range(world)]
        dist.all_gather(gathered, sums)
    same = all(torch.equal(g, gathered[0]) for g in gathered)
    ok = same
    ref = ref_step = None
    if mesh.rank == 0:
        ref, ref_step = state_and_step(False)
        m_ref = {k: float(v) for k, v in ref_step(full, 1e-4, 1e-4).items()}
        dist_max, share = 0.0, 0.0
        for part in ("g", "d", "ema"):
            want = getattr(ref, part).state_dict()
            for k, v in getattr(state, part).state_dict().items():
                diff = (v.float() - want[k].float()).abs()
                dist_max = max(dist_max, float(diff.max()))
                share = max(share, float((diff > 1e-6).float().mean()))
        rel = {k: abs(m_dp[k] - m_ref[k]) / abs(m_ref[k]) for k in ("loss_g", "loss_d")}
        ok = (same and dist_max <= WEIGHT_BOUND and share <= SHARE_BOUND
              and all(r <= LOSS_RTOL for r in rel.values())
              and all(np.isfinite(list(m_dp.values()))))
        out["dp_ranks"] = {"ranks_bit_identical": same, "loss_rel_diff": rel,
                           "weight_max_abs_diff": dist_max, "weight_share_over_1e-6": share,
                           "dp_metrics": m_dp, "one_card_metrics": m_ref}
        print(f"[dp-ranks] {world} ranks x micro {micro}: every rank's G, D (u, v), EMA "
              f"bit-identical {same}; against one card on the concatenated batch: losses "
              f"rel diff {rel} (bound {LOSS_RTOL}), weights max |diff| {dist_max:.3e} "
              f"(bound {WEIGHT_BOUND}), largest share of a tensor's entries over 1e-6 "
              f"{share:.4f} (bound {SHARE_BOUND})", flush=True)

    # [dp-scale]: alternated, the plain step on rank 0 alone at the same micro-batch
    ms = {"plain": [], "dp": []}
    for kind in ("plain", "dp", "dp", "plain"):
        for _ in range(steps):
            b = batch(micro * world)
            barrier(mesh)
            t0 = time.perf_counter()
            if kind == "dp":
                step(rows(b), 1e-4, 1e-4)
            elif mesh.rank == 0:
                ref_step(rows(b), 1e-4, 1e-4)
            _sync(device)
            t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
            if mesh.group is not None:  # the slowest rank's time
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
            ms[kind].append(1e3 * float(t))
    if mesh.rank == 0:
        dp_ms, one_ms = statistics.median(ms["dp"]), statistics.median(ms["plain"])
        out["dp_scale"] = {"dp_ms": ms["dp"], "one_card_ms": ms["plain"],
                           "dp_patches_per_s": world * micro * 1e3 / dp_ms,
                           "one_card_patches_per_s": micro * 1e3 / one_ms,
                           "efficiency": one_ms / dp_ms}
        print(f"[dp-scale] ms a step (host clock after a synchronize, the slowest rank): DP "
              f"{dp_ms:.2f} ({world} x micro {micro}: {world * micro * 1e3 / dp_ms:.2f} "
              f"patches/s), one card {one_ms:.2f} (micro {micro}: {micro * 1e3 / one_ms:.2f} "
              f"patches/s); per-card efficiency {one_ms / dp_ms:.3f}", flush=True)
    del state, step, ref, ref_step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ok


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    y = fn()
    _sync(device)
    return y, time.perf_counter() - t0


def spatial_ranks(mesh, cfg, out: dict) -> bool:
    """[spatial-ranks] and [mesh-ranks]."""
    device, cuda = mesh.device, mesh.device.type == "cuda"
    impl = "pallas" if cuda else "xla"
    h, w = cfg["frame"]
    img = np.random.default_rng(3).random((h, w)).astype(np.float32)
    x = torch.from_numpy(img[None, :, :, None])
    ok = True
    swinir = None
    for arch, cls, make in (("SwinIR", SwinIR, make_spatial_swinir),
                            ("hybrid", HybridHATRealESRGAN, make_spatial_hybrid)):
        net = cls(**cfg["swin" if arch == "SwinIR" else "hybrid"], attn_impl=impl,
                  generator=torch.Generator().manual_seed(4)).to(device).eval()
        fn = make(mesh, net, attn_impl=impl)
        fn(x)  # warm
        got, sharded_s = _timed(lambda: fn(x), device)
        if mesh.rank == 0:
            with torch.no_grad():
                net(x.to(device))
                want, dense_s = _timed(lambda: net(x.to(device)), device)
            rel = _rel_l2(got, want)
            ok = ok and rel <= SPATIAL_REL_L2
            out[f"spatial_{arch}"] = {"rel_l2": rel, "sharded_s": sharded_s,
                                      "one_card_s": dense_s}
            print(f"[spatial-ranks] {arch} fp32 ({impl}), {h}x{w} H-sharded over "
                  f"{mesh.size} ranks: rel L2 to one card's module {rel:.3e} (bound "
                  f"{SPATIAL_REL_L2:.0e}), {sharded_s:.3f} s wall against {dense_s:.3f} s",
                  flush=True)
        if arch == "SwinIR":
            swinir = net
        del fn, got
    kw = dict(tile=cfg["tile"], overlap=cfg["overlap"], device=device)
    tiled_sr(swinir, img, mesh=mesh, **kw)  # warm
    got, mesh_s = _timed(lambda: tiled_sr(swinir, img, mesh=mesh, **kw), device)
    if mesh.rank == 0:
        want, one_s = _timed(lambda: tiled_sr(swinir, img, **kw), device)
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        ok = ok and rel <= SPATIAL_REL_L2
        out["mesh_tiled"] = {"rel_l2": rel, "mesh_s": mesh_s, "one_card_s": one_s}
        print(f"[mesh-ranks] tiled_sr of the SwinIR over {mesh.size} ranks: rel L2 to one "
              f"card's {rel:.3e} (bound {SPATIAL_REL_L2:.0e}), {mesh_s:.3f} s wall against "
              f"{one_s:.3f} s", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--small", action="store_true", help="tiny widths (a CPU rehearsal)")
    ap.add_argument("--steps", type=int, default=2, help="timed steps a turn")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(args.device)
    mesh = make_mesh(args.device)
    cfg = SMALL if args.small else FULL
    out = {"ranks": mesh.size}
    if mesh.rank == 0 and mesh.device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        print(smi, flush=True)
        out["cards"] = smi.splitlines()
    try:
        ok = dp_ranks(mesh, cfg, args.steps, out)
        ok = spatial_ranks(mesh, cfg, out) and ok
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if mesh.rank == 0:
        out["ok"] = ok
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
