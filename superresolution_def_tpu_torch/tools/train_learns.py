"""Bounded training runs on synthetic skies that show the trainers learn (the JAX ``scripts/train_learns.py``).

    python -m superresolution_def_tpu_torch.tools.train_learns --arch swin --epochs 25 --out DIR
    python -m superresolution_def_tpu_torch.tools.train_learns --arch hat --epochs 12 \
        --warmup-epochs 3 --out DIR

Builds ``--pairs`` structured synthetic skies (``data/synth.py``: nebula
plus PSF-blurred stars, HR ``--hr-size``² 16-bit TIFFs written by the native
writer, LR the exact 4x4 box mean) in the reference's on-disk layout
(``SYN/7_dataset_ready_LOG/pair_NNNNNN``, then ``prep/splits.py``'s seed-42
80/10/10 split), reusing a dataset under ``--data-root`` only if it was built
with the same parameters. Then it drives the real trainers at the flagship
configurations, on the card with ``--bf16`` and the default fused kernels:
``train_swin_run`` (embed 180, depths 6x6, heads 6, window 8, micro 8: K2, K3
and K4 in the step, K1 in the EMA validation) or ``train_hat_run`` (HAT embed
90, depths 6x4, 12 RRDB of 48/24, micro 2 x accum 8: K7 and K8 in the step,
K7 in the previews). The run's CSV (``metrics.csv`` or ``train_log.csv``) and
a ``result.json`` (the last epoch's metrics, the card and its power limit,
the wall time and the kernels' launch counts) go to ``--out``. ``--tiny``
cuts the model's widths and depths, with the same data and loop (a CPU
rehearsal: add ``--device cpu --hr-size 64 --pairs 16``).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..cli.trainers import HATTrainConfig, SwinTrainConfig, train_hat_run, train_swin_run
from ..data import synth_pair, write_tiff_u16
from ..kernels import (
    fused_rdb_cm,
    fused_rdb_cm_bwd,
    fused_swin_block,
    swin_block_bwd_attn,
    swin_block_bwd_mlp,
    swin_block_fwd_h,
)
from ..prep.splits import prepare_full_dataset

# the wrappers whose launches each run counts
COUNTED = {"swin": (swin_block_fwd_h, swin_block_bwd_mlp, swin_block_bwd_attn,
                    fused_swin_block),
           "hat": (fused_rdb_cm, fused_rdb_cm_bwd)}
TINY = {"swin": dict(embed_dim=60, depths=(2, 2), num_heads=(6, 6)),
        "hat": dict(embed_dim=30, depths=(2, 2), num_heads=(6, 6), num_rrdb=4)}


def build_dataset(root: Path, n_pairs: int = 256, seed: int = 0, hr_size: int = 512) -> None:
    """``n_pairs`` skies from one generator seeded ``seed`` under ``root/SYN``,
    and their split; a dataset built with other parameters is rebuilt."""
    target = root / "SYN"
    meta_path = target / "synth_meta.json"
    meta = {"n_pairs": n_pairs, "hr_size": hr_size, "seed": seed}
    if (target / "8_dataset_split" / "splits_json" / "train.json").exists():
        try:
            existing = json.loads(meta_path.read_text())
        except (OSError, ValueError):
            existing = None
        if existing == meta:
            print(f"dataset already built at {target}")
            return
        print(f"dataset at {target} was built with {existing}, need {meta}: rebuilding")
        shutil.rmtree(target)
    rng = np.random.default_rng(seed)
    for i in range(n_pairs):
        hr, lr = synth_pair(rng, hr_size=hr_size)
        pair = target / "7_dataset_ready_LOG" / f"pair_{i:06d}"
        write_tiff_u16(pair / "hubble.tiff", hr)
        write_tiff_u16(pair / "observatory.tiff", lr)
    counts = prepare_full_dataset(target)
    meta_path.write_text(json.dumps(meta))
    print(f"built {n_pairs} pairs: {counts}")


def card_name(device: str) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None on the CPU."""
    if not device.startswith("cuda"):
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=["swin", "hat"], required=True)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--warmup-epochs", type=int, default=3, help="hat only")
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--hr-size", type=int, default=512, help="LR is a quarter: the img_size")
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--outputs-root", required=True)
    ap.add_argument("--out", required=True, help="the CSV and result.json go here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-bf16", action="store_true")
    ap.add_argument("--fresh", action="store_true", help="delete --outputs-root first")
    ap.add_argument("--tiny", action="store_true", help="reduced model widths and depths")
    args = ap.parse_args(argv)

    out = Path(args.out).resolve()
    if any(p.name.startswith("learn_r0") and p.parent.name == "artifacts"
           for p in (out, *out.parents)):
        raise SystemExit(f"--out {out}: the TPU runs' artifacts/learn_r0* stay as they are")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    root, outputs = Path(args.data_root), Path(args.outputs_root)
    build_dataset(root, n_pairs=args.pairs, hr_size=args.hr_size)
    if args.fresh and outputs.exists():
        shutil.rmtree(outputs)

    common = dict(targets=("SYN",), data_root=str(root), outputs_root=str(outputs),
                  epochs=args.epochs, use_bf16=not args.no_bf16, img_size=args.hr_size // 4,
                  device=args.device,
                  **(TINY[args.arch] if args.tiny else {}))
    for fn in COUNTED[args.arch]:
        fn.launches = 0
    t0 = time.perf_counter()
    if args.arch == "swin":
        cfg = SwinTrainConfig(**common)
        result = train_swin_run(cfg)
        csv = "metrics.csv"
    else:
        cfg = HATTrainConfig(warmup_epochs=args.warmup_epochs, csv_interval=1, img_interval=2,
                             ckpt_interval=5, **common)
        result = train_hat_run(cfg)
        csv = "train_log.csv"
    wall = time.perf_counter() - t0

    out.mkdir(parents=True, exist_ok=True)
    shutil.copy(outputs / cfg.run_name / csv, out / csv)
    record = {**{k: float(v) for k, v in result.items()}, "wall_s": wall,
              "card": card_name(args.device),
              "launches": {fn.__name__: fn.launches for fn in COUNTED[args.arch]},
              "config": {k: v for k, v in common.items() if k not in ("data_root",
                                                                      "outputs_root")}}
    (out / "result.json").write_text(json.dumps(record, indent=2, default=list) + "\n")
    print(json.dumps(record, default=list))
    return record


if __name__ == "__main__":
    main()
