"""Op-class attribution of the fused SwinIR block on the card (K13's tool).

    python -m superresolution_def_tpu_torch.tools.swin_stage_ablation [variant ...]
        [--device cuda|cpu]

The twin of ``scripts/swin_stage_ablation.py``'s ``main()``: the flagship
block (C=180, 6 heads of 30, N=64 tokens, hidden 720) over 2048 windows
(batch 8 of 128x128), every operand drawn from ``np.random.default_rng(0)``
with std 0.02 in bf16 as the script draws it (the relative-position bias in
fp32). With ``allheads`` among the variants it first prints ``allheads vs
full max|err|``. Then, after a line naming the device (on the card: its
name and power limit from ``nvidia-smi``), per variant the time of a
chain of 36 blocks, each block's output the next one's input, timed with
CUDA events (the least of 5 chains after one untimed), as ms per block and
patches per second through 36 blocks. As in the script, the sizes are
module constants (``WINDOWS``, ``BLOCKS``).

Variants: full noattn attnonly mlponly allheads mlp_nogelu mlp_tanhgelu
mlp_siggelu mlp_polygelu (default: full noattn attnonly mlponly). The
modes are described in ``kernels/swin_stage_ablation.py``. ``--device
cpu`` runs the plain versions and times them on the host clock (the
numbers are the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..kernels.swin_stage_ablation import MODES, swin_stage_block

C, HEADS, N, HIDDEN = 180, 6, 64, 720
SCALE = (C // HEADS) ** -0.5
WINDOWS = 8 * 256  # batch 8 x (128/8)^2 windows
BLOCKS = 36        # blocks in each timed chain
REPS = 5
DEFAULT_MODES = ("full", "noattn", "attnonly", "mlponly")  # the script's default run


def operands(windows: int, device) -> tuple[torch.Tensor, tuple]:
    """The script's x and block weights: std 0.02 draws rounded to bf16 (the
    bias table fp32), in its order."""
    rng = np.random.default_rng(0)

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.02).to(
            device, torch.bfloat16)

    weights = (
        w(C), w(C), w(C, 3 * C), w(3 * C),
        torch.from_numpy(rng.standard_normal((HEADS, N, N), np.float32) * 0.02).to(device),
        w(C, C), w(C), w(C), w(C), w(C, HIDDEN), w(HIDDEN), w(HIDDEN, C), w(C),
    )
    return w(windows, N, C), weights


def chain_ms(x, weights, mode: str, device) -> float:
    """Least milliseconds of ``BLOCKS`` chained blocks over ``REPS`` timings."""
    def chain():
        out = x
        for _ in range(BLOCKS):
            out = swin_stage_block(out, *weights, mode=mode, num_heads=HEADS, scale=SCALE)
        return out

    if device.type != "cuda":
        chain()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            chain()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)
    chain()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def device_line(device) -> str:
    if device.type != "cuda":
        return "device: cpu (plain PyTorch versions; host-clock times)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[device.index or 0]


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(DEFAULT_MODES),
                    help=f"any of {' '.join(MODES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in MODES]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {' '.join(MODES)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain versions")
    x, weights = operands(WINDOWS, device)

    # parity first: allheads must equal full
    if "allheads" in args.variants:
        kw = dict(num_heads=HEADS, scale=SCALE)
        a = swin_stage_block(x, *weights, mode="full", **kw)
        b = swin_stage_block(x, *weights, mode="allheads", **kw)
        print(f"allheads vs full max|err|: {(a.float() - b.float()).abs().max().item():.2e}",
              flush=True)

    print(device_line(device), flush=True)
    patches = WINDOWS / 256  # 128x128 patches: 256 windows each
    per_block = {}
    for mode in args.variants:
        ms = chain_ms(x, weights, mode, device) / BLOCKS
        per_block[mode] = ms
        print(f"{mode:>13}: {ms:7.3f} ms/block  ({patches * 1e3 / (ms * 36):6.1f} p/s for 36 "
              f"blocks)", flush=True)
    return per_block


if __name__ == "__main__":
    main()
