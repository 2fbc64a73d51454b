"""Command-line entry of the port: ``prep``, ``split``, ``train``, ``infer`` and ``upscale``.

  python -m superresolution_def_tpu_torch.cli.main prep [--target T] \
      [--steps 1,2,3,4] [--desired-count N] [--fused]
  python -m superresolution_def_tpu_torch.cli.main split [--target T]
  python -m superresolution_def_tpu_torch.cli.main train --arch {swin,hat} \
      --target T1 [--bf16] [--batch-size N] [--accum-steps N] [--epochs 300] \
      [--fused {on,off}] [--no-vgg]
  python -m superresolution_def_tpu_torch.cli.main infer --arch {swin,hat} \
      [--impl fused] [--folder RUN] [--data-root DATA]
  python -m superresolution_def_tpu_torch.cli.main upscale FRAME.fits|FRAME.tiff \
      --folder RUN [--arch {swin,hat}] [--out OUT.tiff] [--tile 128] [--overlap 16] \
      [--mesh | --spatial]
  torchrun --nproc-per-node N -m superresolution_def_tpu_torch.cli.main train|upscale ...

The flags are those of the JAX ``sr`` subcommands, plus ``--device``: prep,
train, infer and upscale run on the card (``cuda``) unless ``--device cpu``
is given, and raise without a card (``split`` is host work). ``prep
--fused`` runs steps 3+4 as the device-resident fused pipeline
(``prep/fused.py``, BASELINE config #5); step 2 and the staged steps' debug
cards need matplotlib. ``train --bf16`` on the card runs the kernels: for
swin the fused Swin blocks (K2-K4), for hat the RRDB trunk's dense blocks
(K7/K8); ``--fused on|off`` overrides that default (on runs the fused
structure through the kernels' plain versions on the CPU), ``--no-vgg``
drops the perceptual term; ``train --arch hat --fused-hab`` also runs the
backbone's HABs and OCAB tails through their training kernels (K9a-c,
K10a-b), on the card with ``--bf16``, on the CPU through the kernels' plain
versions. ``upscale`` super-resolves a whole FITS or 16-bit TIFF frame by
tiles through the fp32 ``nn.Module``; ``--mesh`` spreads the tiles over the
ranks, ``--spatial`` runs the whole frame H-sharded over the ranks with
halo exchange (``parallel/spatial*.py``) instead of tiles. Without
``--folder`` (``infer``) or ``--target`` (``train``) the run folders or
targets are offered in a numbered menu (targets: several, comma-separated,
or ``all``).

Launched by torchrun (``WORLD_SIZE`` set), ``train`` and ``upscale`` run in
the world ``parallel.initialize_distributed`` builds (NCCL on the cards,
gloo with ``--device cpu``), one process a card, rank 0 writing; without
torchrun they run in a world of one. The other commands run in one
process and refuse a larger world.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _pick_from(items: list[str], what: str, multi: bool = False) -> list[str]:
    """A numbered menu of ``items``; with ``multi`` several numbers,
    comma-separated, or ``all``."""
    if not items:
        sys.exit(f"No {what} found.")
    print(f"Available {what}:")
    for i, t in enumerate(items, 1):
        print(f"  [{i}] {t}")
    raw = input(f"Select {what}" + (" (comma-separated or 'all')" if multi else "") + ": ").strip()
    if multi and raw.lower() == "all":
        return items
    idxs = [int(x) - 1 for x in raw.split(",")]
    return [items[i] for i in idxs] if multi else [items[idxs[0]]]


def get_available_pair_targets(data_root: str) -> list[str]:
    return [d.name for d in sorted(Path(data_root).glob("*"))
            if (d / "7_dataset_ready_LOG").exists() or (d / "7_dataset_ready").exists()]


def cmd_split(args) -> dict:
    from ..prep.splits import prepare_full_dataset

    targets = args.target.split(",") if args.target else get_available_pair_targets(args.data_root)
    return {t: prepare_full_dataset(Path(args.data_root) / t) for t in targets}


def cmd_prep(args) -> None:
    """Dataset prep steps 1-4 for each target (misc/Dataset_step*)."""
    from ..device import resolve_device
    from ..prep import (
        extract_patches,
        fused_prep_target,
        main_registration,
        make_prep_logger,
        mosaic_check,
        normalize_target,
        process_step1_folder,
    )

    device = resolve_device(args.device)
    steps = set((args.steps or "1,2,3,4").split(","))
    targets = args.target.split(",") if args.target else [
        p.name for p in sorted(Path(args.data_root).glob("*")) if (p / "1_originarie").exists()
    ]
    # timestamped log file + console, like the reference's step-1 logging
    # (Dataset_step1:44-54) but covering every step run
    log, log_path = make_prep_logger(Path(args.data_root) / "logs", prefix="prep")
    log(f"prep steps={sorted(steps)} targets={targets} (log: {log_path})")
    for t in targets:
        root = Path(args.data_root) / t
        orig = root / "1_originarie"
        solved_o = root / "2_solved_astap" / "observatory"
        solved_h = root / "2_solved_astap" / "hubble"
        reg_o = root / "3_registered_native" / "observatory"
        reg_h = root / "3_registered_native" / "hubble"
        if "1" in steps:
            process_step1_folder(orig / "local_raw", solved_o, log=log)
            process_step1_folder(orig / "img_lights", solved_h, log=log)
            main_registration(solved_h, solved_o, reg_h, reg_o, log=log, device=device)
        if "2" in steps:
            mosaic_check(
                reg_h, reg_o, root / "4_quality_check" / f"{t}_mosaic_check.png",
                target_name=t, log=log, device=device,
            )
        if args.fused and {"3", "4"} <= steps:
            # config #5 hot path: steps 3+4 device-resident (prep/fused.py),
            # without the per-patch debug cards and zips of the staged steps
            fused_prep_target(
                reg_h, reg_o, root / "6_patches_final", root / "7_dataset_ready_LOG",
                target_name=t, desired_count=args.desired_count, log=log, device=device,
            )
        else:
            if args.fused:
                log("[prep] --fused needs both steps 3 and 4; running staged")
            if "3" in steps:
                extract_patches(
                    reg_h, reg_o, root / "6_patches_final",
                    target_name=t, desired_count=args.desired_count,
                    debug_dir=root / "6_patches_final_debug",
                    zip_outputs=True, log=log, device=device,
                )
            if "4" in steps:
                normalize_target(
                    root / "6_patches_final", root / "7_dataset_ready_LOG",
                    debug_dir=root / "7_dataset_ready_LOG_debug",
                    zip_debug=True, log=log, device=device,
                )


def cmd_train(args) -> dict:
    from .trainers import HATTrainConfig, SwinTrainConfig, train_hat_run, train_swin_run

    if args.target:
        targets = args.target.split(",")
    else:
        found = sorted(p.name for p in Path(args.data_root).glob("*")
                       if (p / "8_dataset_split" / "splits_json" / "train.json").exists())
        targets = _pick_from(found, "targets", multi=True)
    config = SwinTrainConfig if args.arch == "swin" else HATTrainConfig
    cfg = config(
        targets=tuple(targets), data_root=args.data_root, outputs_root=args.outputs_root,
        epochs=args.epochs, use_bf16=args.bf16, use_vgg=not args.no_vgg,
        vgg_weights=args.vgg_weights, seed=args.seed,
        max_steps_per_epoch=args.max_steps_per_epoch, device=args.device,
        fused=None if args.fused is None else args.fused == "on")
    fields = ["batch_size", "accum_steps", "img_size", "embed_dim"]
    if args.arch == "hat":
        fields += ["warmup_epochs", "num_rrdb", "num_feat", "num_grow_ch", "ckpt_interval",
                   "img_interval", "csv_interval", "pretrained_hat", "fused_hab"]
    for field in fields:
        if getattr(args, field) is not None:
            setattr(cfg, field, getattr(args, field))
    if args.depths:
        cfg.depths = tuple(int(x) for x in args.depths.split(","))
        cfg.num_heads = (args.num_heads,) * len(cfg.depths)
    run = train_swin_run if args.arch == "swin" else train_hat_run
    return run(cfg, resume=not args.no_resume)


def cmd_infer(args) -> dict:
    from .infer import run_test

    if args.folder:
        folder = args.folder
        # bare run names resolve against --outputs-root; paths pass through
        if not Path(folder).is_dir() and (Path(args.outputs_root) / folder).is_dir():
            folder = str(Path(args.outputs_root) / folder)
    else:
        runs = sorted(str(p) for p in Path(args.outputs_root).glob("*") if p.is_dir())
        folder = _pick_from(runs, "run folders")[0]
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


def cmd_upscale(args) -> dict:
    """SR a whole 16-bit TIFF or FITS frame (the JAX ``cmd_upscale``): by
    tiles, spread over the ranks with ``--mesh``, or with ``--spatial`` the
    whole frame H-sharded over the ranks (reflect-padded to ranks x ws rows
    and ws columns). Rank 0 writes."""
    import numpy as np
    import torch

    from ..data import read_tiff_u16, write_tiff_u16
    from ..device import resolve_device
    from ..parallel import make_mesh, make_spatial_hybrid, make_spatial_swinir
    from ..parallel.mesh import barrier
    from .infer import load_generator, tiled_sr

    mesh = make_mesh(args.device) if args.mesh or args.spatial else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    src = Path(args.image)
    if src.suffix.lower() in (".fits", ".fit", ".fts"):
        from ..ops.normalize import log_stretch_normalize, robust_minmax
        from ..prep import read_fits

        raw = np.nan_to_num(read_fits(src).data)
        lo, hi = robust_minmax(raw, device=device)
        img01 = log_stretch_normalize(raw, lo, hi, device=device).cpu().numpy()
    else:
        img01 = read_tiff_u16(src).astype(np.float32) / 65535.0

    model, info = load_generator(args.folder, device, args.arch)
    if args.spatial:
        # halo-exact context parallelism: the whole frame in one sharded
        # forward, no tile blending
        ws = model.window_size if args.arch == "swin" else model.hat.window_size
        quantum = mesh.size * ws
        h, w = img01.shape[:2]
        xin = np.pad(img01, ((0, (quantum - h % quantum) % quantum), (0, (ws - w % ws) % ws)),
                     mode="reflect")[None, ..., None]
        make = make_spatial_swinir if args.arch == "swin" else make_spatial_hybrid
        sr = make(mesh, model)(torch.from_numpy(np.ascontiguousarray(xin)))
        sr = sr.float().cpu().numpy()[0, : h * 4, : w * 4]
    else:
        sr = tiled_sr(model, img01, tile=args.tile, overlap=args.overlap, scale=4,
                      device=device, mesh=mesh)
    out = args.out or str(src.with_suffix("")) + "_sr.tiff"
    if mesh is None or mesh.rank == 0:
        write_tiff_u16(out, sr[..., 0])
        print(f"{src} {img01.shape} -> {out} {sr.shape[:2]}  [ckpt: {info['source']}]")
    barrier(mesh)
    return {"out": out, "shape": sr.shape[:2], "checkpoint": info}


def _in_world(args, command):
    """Runs ``command(args)``. Launched by torchrun, ``train`` and
    ``upscale`` run in its world (made here, and torn down at the end, when
    no process group exists yet); the other commands refuse a world of more
    than one process."""
    import os

    if args.cmd not in ("train", "upscale"):
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            sys.exit(f"`{args.cmd}` runs in one process; launch it without torchrun")
        return command(args)
    import torch.distributed as dist

    from ..parallel import initialize_distributed

    made = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if made:
        initialize_distributed(args.device)
    try:
        return command(args)
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(prog="sr", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("split", help="build 80/10/10 split manifests")
    ps.add_argument("--data-root", default="data")
    ps.add_argument("--target", default=None)

    pp = sub.add_parser("prep", help="dataset prep steps 1-4 (solve/register/QC/patches/normalize)")
    pp.add_argument("--data-root", default="data")
    pp.add_argument("--target", default=None)
    pp.add_argument("--steps", default=None, help="comma subset of 1,2,3,4")
    pp.add_argument("--desired-count", type=int, default=None)
    pp.add_argument("--fused", action="store_true",
                    help="run steps 3+4 as the device-resident fused pipeline (prep/fused.py, "
                         "BASELINE config #5; no per-patch debug cards or zips)")
    pp.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

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
    pt.add_argument("--fused", choices=["on", "off"], default=None,
                    help="the generator through the kernels (swin K2-K4, hat's trunk K7/K8); "
                         "default: on for the card with --bf16; on the CPU they run their "
                         "plain versions")
    pt.add_argument("--no-vgg", action="store_true", help="no perceptual (VGG19) term")
    pt.add_argument("--vgg-weights", default=None,
                    help="pretrained VGG19 for the perceptual term, supplied by the user (nothing "
                         "is downloaded): torchvision's vgg19 state dict as .pth, or the npz "
                         "that cli.port_vgg writes from it; without it seeded random weights")
    pt.add_argument("--no-resume", action="store_true",
                    help="start over instead of resuming from the run folder's checkpoints")
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
    hat.add_argument("--fused-hab", action="store_true", default=None,
                     help="the backbone's HABs and OCAB tails through their training kernels "
                          "(K9, K10) too; needs --bf16 on the card, runs their plain versions "
                          "on the CPU")

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

    pu = sub.add_parser("upscale", help="tiled x4 SR of an arbitrary-size TIFF/FITS image")
    pu.add_argument("image")
    pu.add_argument("--folder", required=True, help="trained run folder (checkpoint source)")
    pu.add_argument("--arch", choices=["swin", "hat"], default="swin")
    pu.add_argument("--out", default=None)
    pu.add_argument("--tile", type=int, default=128)
    pu.add_argument("--overlap", type=int, default=16)
    pu.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    spread = pu.add_mutually_exclusive_group()
    spread.add_argument("--mesh", action="store_true", help="spread the tiles over the ranks")
    spread.add_argument("--spatial", action="store_true",
                        help="halo-exact spatial sharding over the ranks instead of tile "
                             "blending")

    args = p.parse_args(argv)
    return _in_world(args, {"split": cmd_split, "prep": cmd_prep, "train": cmd_train,
                            "infer": cmd_infer, "upscale": cmd_upscale}[args.cmd])


if __name__ == "__main__":
    main()
