"""Command-line entry of the port: ``train`` and ``infer`` for SwinIR and the HAT hybrid.

  python -m superresolution_def_tpu_torch.cli.main train --arch {swin,hat} \
      --target T1 [--bf16] [--batch-size N] [--accum-steps N] [--epochs 300]
  python -m superresolution_def_tpu_torch.cli.main infer --arch {swin,hat} \
      [--impl fused] [--folder RUN] [--data-root DATA]

The flags are those of the JAX ``sr train`` / ``sr infer``, plus ``--device``:
both run on the card (``cuda``) unless ``--device cpu`` is given, and raise
without a card. ``train --bf16`` on the card runs the kernels: for swin the
fused Swin blocks (K2-K4), for hat the RRDB trunk's dense blocks (K7/K8).
Without ``--folder`` (``infer``) or ``--target`` (``train``) the run
folders or targets are offered in a numbered menu.
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


def cmd_train(args) -> dict:
    from .trainers import HATTrainConfig, SwinTrainConfig, train_hat_run, train_swin_run

    if args.target:
        targets = args.target.split(",")
    else:
        found = sorted(p.name for p in Path(args.data_root).glob("*")
                       if (p / "8_dataset_split" / "splits_json" / "train.json").exists())
        targets = [_pick_from(found, "targets")]
    config = SwinTrainConfig if args.arch == "swin" else HATTrainConfig
    cfg = config(
        targets=tuple(targets), data_root=args.data_root, outputs_root=args.outputs_root,
        epochs=args.epochs, use_bf16=args.bf16, vgg_weights=args.vgg_weights, seed=args.seed,
        max_steps_per_epoch=args.max_steps_per_epoch, device=args.device)
    fields = ["batch_size", "accum_steps", "img_size", "embed_dim"]
    if args.arch == "hat":
        fields += ["warmup_epochs", "num_rrdb", "num_feat", "num_grow_ch", "ckpt_interval",
                   "img_interval", "csv_interval", "pretrained_hat"]
    for field in fields:
        if getattr(args, field) is not None:
            setattr(cfg, field, getattr(args, field))
    if args.depths:
        cfg.depths = tuple(int(x) for x in args.depths.split(","))
        cfg.num_heads = (args.num_heads,) * len(cfg.depths)
    return train_swin_run(cfg) if args.arch == "swin" else train_hat_run(cfg)


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
        device=args.device,
    )
    print(
        f"Test: {result['num_images']} images  "
        f"PSNR={result['psnr']:.2f} dB  SSIM={result['ssim']:.4f}"
    )
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="sr", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train a GAN generator")
    pt.add_argument("--arch", choices=["swin", "hat"], default="swin",
                    help="generator architecture: 'swin' (SwinIR) or 'hat' (HybridHATRealESRGAN)")
    pt.add_argument("--target", default=None, help="comma-separated targets")
    pt.add_argument("--data-root", default="data")
    pt.add_argument("--outputs-root", default="outputs")
    pt.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    pt.add_argument("--epochs", type=int, default=300)
    pt.add_argument("--batch-size", type=int, default=None,
                    help="micro-batch (default: swin 8, hat 2)")
    pt.add_argument("--accum-steps", type=int, default=None, help="default: swin 1, hat 8")
    pt.add_argument("--bf16", action="store_true",
                    help="bf16 compute; on the card the generator runs the kernels")
    pt.add_argument("--vgg-weights", default=None, help="npz of the JAX package's VGG19 params")
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--img-size", type=int, default=None)
    pt.add_argument("--embed-dim", type=int, default=None)
    pt.add_argument("--depths", default=None, help="comma list, e.g. 6,6,6,6,6,6")
    pt.add_argument("--num-heads", type=int, default=6)
    pt.add_argument("--max-steps-per-epoch", type=int, default=None)
    hat = pt.add_argument_group("hat only")
    hat.add_argument("--warmup-epochs", type=int, default=None,
                     help="L1-only epochs before the GAN (default 30)")
    hat.add_argument("--num-rrdb", type=int, default=None, help="default 12")
    hat.add_argument("--num-feat", type=int, default=None, help="trunk width F (default 48)")
    hat.add_argument("--num-grow-ch", type=int, default=None, help="growth width G (default 24)")
    hat.add_argument("--ckpt-interval", type=int, default=None, help="epochs (default 5)")
    hat.add_argument("--img-interval", type=int, default=None, help="epochs (default 10)")
    hat.add_argument("--csv-interval", type=int, default=None, help="epochs (default 10)")
    hat.add_argument("--pretrained-hat", default=None,
                     help="a HAT-only .pth to seed the hybrid's backbone")

    pi = sub.add_parser("infer", help="evaluate a trained run on its test split")
    pi.add_argument("--arch", choices=["swin", "hat"], default="swin",
                    help="generator architecture: 'swin' (SwinIR) or 'hat' (HybridHATRealESRGAN)")
    pi.add_argument("--folder", default=None)
    pi.add_argument("--data-root", default="data")
    pi.add_argument("--outputs-root", default="outputs")
    pi.add_argument("--limit", type=int, default=None)
    pi.add_argument("--lr-size", type=int, default=128,
                    help="LR patch size of the dataset (reference: 128)")
    pi.add_argument("--hr-size", type=int, default=512,
                    help="HR patch size of the dataset (reference: 512)")
    pi.add_argument("--manifest", default=None)
    pi.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    pi.add_argument("--impl", choices=["fused"], default=None,
                    help="'fused' = bf16 through the CUDA kernels (SwinIR: the fused "
                         "Swin block; hat: the HAB, OCAB and dense-block kernels)")

    args = p.parse_args(argv)
    return cmd_train(args) if args.cmd == "train" else cmd_infer(args)


if __name__ == "__main__":
    main()
