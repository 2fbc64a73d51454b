"""Where K10b's window kernel spends its time: the kernel against copies of
itself with one part taken out.

    python -m superresolution_def_tpu_torch.tools.ocab_bwd_ablation [--out DIR]

Builds ``csrc/ocab_train.cu`` as it is and three copies of it, each with one
text substitution, into ``DIR`` (default: a temporary directory), and times
each one's window kernel alone (``ocab_bwd_attn_bf16``, CUDA events, median
of 15 rounds of 5 calls) at the fused-HAB step's shape: Bw = 512 windows,
C = 90, 6 heads of 15, 144 keys. The copies:

- ``no_stores``: the producer skips writing the staged dq, dk, dv and
  attention rows to device memory (``copy_out`` returns at once);
- ``no_compute``: the consumers skip every product of a window (they still
  wait for each stage, write dh's padded rows, sum its columns, stage their
  (stale) rows and release it);
- ``no_loads``: the producer issues no copies of q, k, v or dh.

Their outputs are wrong by design; only their times mean anything. Prints
one JSON line: the card, its power limit, and milliseconds per variant.
Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import _build

VARIANTS = {
    "kernel": [],
    "no_stores": [("int rows, int cols, int t) {\n",
                   "int rows, int cols, int t) {\n  return;\n")],
    "no_compute": [("      if (live) {\n        // ---- do =",
                    "      if (false) {\n        // ---- do ="),
                   ("      pair_sync();\n      if (live) {\n#pragma unroll 1",
                    "      pair_sync();\n      if (false) {\n#pragma unroll 1")],
    "no_loads": [("for (int j = 0; j < 2 && 2 * pass + j < heads; ++j) {",
                  "for (int j = 0; j < 0; ++j) {"),
                 ("for (int idx = pt; idx < N * (CP / 2); idx += 128) {",
                  "for (int idx = pt; idx < 0; idx += 128) {")],
}


def build(out: Path, name: str) -> Path:
    text = (_build.CSRC / "ocab_train.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: ocab_train.cu no longer contains {old!r}")
        text = text.replace(old, new)
    src, lib = out / f"{name}.cu", out / f"{name}.so"
    src.write_text(text)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="build directory (default: temporary)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = args.out or Path(tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(out, n), VARIANTS)))

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    bw, c, heads, nk, cp = 512, 90, 6, 144, 96
    hd = c // heads
    q = torch.randn(bw, 64, c, generator=gen).to(dev, torch.bfloat16)
    k, v = (torch.randn(bw, nk, c, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    dh = (1e-2 * torch.randn(bw, 64, c, generator=gen)).to(dev, torch.bfloat16)
    bias = (0.5 * torch.randn(heads, 64, nk, generator=gen)).to(dev)
    wproj = F.pad((torch.rand(c, c, generator=gen) - 0.5).to(dev, torch.bfloat16),
                  (0, cp - c, 0, cp - c)).contiguous()
    wpb = -(-bw // torch.cuda.get_device_properties(dev).multi_processor_count)
    grid = -(-bw // wpb)
    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
    outs += [torch.empty(bw * 64, cp, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    outs.append(torch.empty(grid, heads * 64 * nk + cp, dtype=torch.float32, device=dev))
    ptrs = [t.data_ptr() for t in (q, k, v, dh, bias, wproj, *outs)]
    times = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).ocab_bwd_attn_bf16
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
        call_args = ptrs + [bw, wpb, nk, cp, c, heads, hd, hd ** -0.5,
                            torch.cuda.current_stream(dev).cuda_stream]

        def call():
            err = fn(*call_args)
            if err:
                raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(15):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(5):
                call()
            e.record()
            e.synchronize()
            rounds.append(s.elapsed_time(e) / 5)
        times[name] = statistics.median(rounds)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "bw": bw, "c": c, "heads": heads, "nk": nk, "ms": times}))


if __name__ == "__main__":
    main()
