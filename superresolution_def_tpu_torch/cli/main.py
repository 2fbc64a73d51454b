"""Command-line entry of the port; only ``infer`` is ported so far.

  python -m superresolution_def_tpu_torch.cli.main infer --arch swin \
      [--impl fused] [--folder RUN] [--data-root DATA]

The flags are those of the JAX ``sr infer``. Without ``--folder`` the run
folders under ``--outputs-root`` are offered in a numbered menu.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _pick_from(items: list[str], what: str) -> str:
    if not items:
        sys.exit(f"No {what} found.")
    print(f"Available {what}:")
    for i, t in enumerate(items, 1):
        print(f"  [{i}] {t}")
    return items[int(input(f"Select {what}: ").strip()) - 1]


def cmd_infer(args) -> dict:
    from .infer import run_test

    if args.folder:
        folder = args.folder
        # bare run names resolve against --outputs-root; paths pass through
        if not Path(folder).is_dir() and (Path(args.outputs_root) / folder).is_dir():
            folder = str(Path(args.outputs_root) / folder)
    else:
        runs = sorted(str(p) for p in Path(args.outputs_root).glob("*") if p.is_dir())
        folder = _pick_from(runs, "run folders")
    result = run_test(
        folder,
        args.arch,
        data_root=args.data_root,
        lr_size=args.lr_size,
        hr_size=args.hr_size,
        limit=args.limit,
        manifest=args.manifest,
        impl=args.impl,
    )
    print(
        f"Test: {result['num_images']} images  "
        f"PSNR={result['psnr']:.2f} dB  SSIM={result['ssim']:.4f}"
    )
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="sr", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("infer", help="evaluate a trained run on its test split")
    pi.add_argument("--arch", choices=["swin"], default="swin",
                    help="generator architecture (the HAT hybrid is not ported yet)")
    pi.add_argument("--folder", default=None)
    pi.add_argument("--data-root", default="data")
    pi.add_argument("--outputs-root", default="outputs")
    pi.add_argument("--limit", type=int, default=None)
    pi.add_argument("--lr-size", type=int, default=128,
                    help="LR patch size of the dataset (reference: 128)")
    pi.add_argument("--hr-size", type=int, default=512,
                    help="HR patch size of the dataset (reference: 512)")
    pi.add_argument("--manifest", default=None)
    pi.add_argument("--impl", choices=["fused"], default=None,
                    help="'fused' = every Swin block through the fused-block CUDA "
                         "kernel, bf16")

    args = p.parse_args(argv)
    return cmd_infer(args)


if __name__ == "__main__":
    main()
