"""Where K6's kernel spends its time: the kernel against copies of itself
with one part taken out or changed.

    python -m superresolution_def_tpu_torch.tools.ocab_fwd_ablation [--out DIR]

Builds ``csrc/ocab.cu`` (K6 and K10a, the OCAB mode of
``csrc/swin_fwd_wg.cuh``'s body) as it is and copies of it, each with text
substitutions in ``ocab.cu``, ``swin_fwd_wg.cuh`` or ``attn_head_wg.cuh``
(the per-head attention), into ``DIR`` (default: a temporary directory),
and times each one's K6 (``fused_ocab_block`` on
weights padded and packed once, CUDA events: the variants in turns, five
passes, each the median of 15 rounds of 5 calls, each round behind one
untimed call as ``tools/kernel_ab.py`` times, so that the device is busy
while the host queues the timed calls; per variant the median of its
passes) at the hybrid's shape, Bw = 2048 windows, C = 90, 6 heads of 15,
144 keys (the first 14 zero), hidden 360, and its K10a (``ocab_fwd_h``)
at the fused-HAB step's Bw = 512. The copies:

- ``no_bias``: the scores start from zero, not from the bias read from
  device memory;
- ``no_attn_products``: the scores' and P . v's products are skipped, and
  with them what only they consume (the compiler drops the softmax and the
  bias reads);
- ``expf``: the softmax's hardware ``__expf`` is the library's ``expf``;
- ``no_mlp``: the MLP's products are skipped (its tiles still stream);
- ``no_gather``: the producer issues no copies of q, k or v (it still
  signals each stage);
- ``one_stage``: one gather stage a window, not two;
- ``one_window``: one window a block;
- ``producer_40``: the producer warpgroup keeps 40 registers a thread, the
  consumers 232 (K5's split; the kernel's is 56 and 224);
- ``sigmoid_gelu``: the MLP's tanh GELU computed as x sigmoid(2 s), by the
  hardware exponential and one division (every mode of the copy).

Their outputs are wrong by design (but those of ``expf``, ``producer_40``
and ``sigmoid_gelu``); only their times mean anything. Prints one JSON
line: the card, its power limit, and milliseconds per variant and kernel.
Needs a CUDA card and nvcc; imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..kernels import _build

HEADER = "swin_fwd_wg.cuh"
ATTN = "attn_head_wg.cuh"  # the per-head attention K6 shares with K11
FIT = "const int options[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};"
# the tanh GELU as x sigmoid(2 s), s = sqrt(2 / pi) (x + 0.044715 x^3): the same
# function, by the hardware exponential and one division
SIGMOID_GELU = """__device__ __forceinline__ float sigmoid_gelu(float x) {
  return __fdividef(x, 1.f + __expf(-1.5957691216057308f * (x + 0.044715f * x * x * x)));
}

// The body of every instantiation:"""
# (file, old, new) substitutions per variant
VARIANTS = {
    "kernel": [],
    "no_bias": [(ATTN, "    if (c < nk) {\n      float2 b0", "    if (false) {\n      float2 b0"),
                (ATTN, "const float ninf = -__int_as_float(0x7f800000);",
                 "const float ninf = 0.f;")],
    "no_attn_products": [
        (ATTN, "for (int kk = 0; kk < HP / 16; ++kk) {\n    if constexpr (NK == 144)",
         "for (int kk = 0; kk < 0; ++kk) {\n    if constexpr (NK == 144)"),
        (ATTN, "for (int kb = 0; kb < NK / 16; ++kb)\n    fwd_mma_pv",
         "for (int kb = 0; kb < 0; ++kb)\n    fwd_mma_pv")],
    "expf": [(ATTN, f"    s[4 * t{e}] = __expf(", f"    s[4 * t{e}] = expf(")
             for e in ("", " + 1", " + 2", " + 3")],
    "no_mlp": [(HEADER, "      if (live && d2 != 0.f) {", "      if (false) {")],
    "no_gather": [(HEADER, "              fetch_head<HP, OC_GATHER>(stg, oc.q",
                   "              if (false) fetch_head<HP, OC_GATHER>(stg, oc.q"),
                  (HEADER, "              fetch_head<HP, OC_GATHER>(stg + N * HP * 2,",
                   "              if (false) fetch_head<HP, OC_GATHER>(stg + N * HP * 2,"),
                  (HEADER, "              fetch_head<HP, OC_GATHER>(stg + (N + OC_KEYS)",
                   "              if (false) fetch_head<HP, OC_GATHER>(stg + (N + OC_KEYS)")],
    "one_stage": [("ocab.cu", FIT, FIT.replace("{2, 2}", "{2, 1}").replace("{1, 2}", "{1, 1}"))],
    "one_window": [("ocab.cu", FIT, FIT.replace("{2, 2}, {2, 1}", "{1, 2}, {1, 2}"))],
    "producer_40": [(HEADER, '"n"(OCAB ? 56 : 40)', '"n"(40)'),
                    (HEADER, '"n"(OCAB ? 224 : 232)', '"n"(232)')],
    "sigmoid_gelu": [(HEADER, "hcol < hidden ? activation<ACT>(u[i] + b1s[hcol]) : 0.f;",
                      "hcol < hidden ? sigmoid_gelu(u[i] + b1s[hcol]) : 0.f;"),
                     (HEADER, "// The body of every instantiation:", SIGMOID_GELU)],
}


def build(out: Path, name: str) -> Path:
    """``ocab.cu``, ``swin_fwd_wg.cuh`` and ``attn_head_wg.cuh`` with
    ``name``'s substitutions, compiled into ``out/name/``; the other
    headers from ``csrc``."""
    texts = {f: (_build.CSRC / f).read_text() for f in ("ocab.cu", HEADER, ATTN)}
    for f, old, new in VARIANTS[name]:
        if old not in texts[f]:
            raise RuntimeError(f"{name}: {f} no longer contains {old!r}")
        texts[f] = texts[f].replace(old, new)
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (d / f).write_text(text)
    lib = d / "libocab.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, f"-I{_build.CSRC}", "-o", str(lib),
                    str(d / "ocab.cu")], check=True, capture_output=True, text=True)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="build directory (default: temporary)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = args.out or Path(tempfile.mkdtemp())
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(out, n), VARIANTS)))

    ocab = importlib.import_module("superresolution_def_tpu_torch.kernels.ocab")
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    bw, c, heads, hidden, nk = 2048, 90, 6, 360, 144

    def u(*shape, fan_in):
        return (torch.rand(*shape, generator=gen) * 2 - 1) / fan_in ** 0.5

    x, q = (torch.randn(bw, 64, c, generator=gen).to(dev, bf) for _ in range(2))
    k, v = (torch.randn(bw, nk, c, generator=gen).to(dev, bf) for _ in range(2))
    k[:, :14] = 0
    v[:, :14] = 0
    bias = (0.5 * torch.randn(heads, 64, nk, generator=gen)).to(dev)
    tail = [t.to(dev) for t in (
        u(c, c, fan_in=c).to(bf), u(c, fan_in=c), 1 + 0.1 * torch.randn(c, generator=gen),
        0.1 * torch.randn(c, generator=gen), u(c, hidden, fan_in=c).to(bf),
        u(hidden, fan_in=c), u(hidden, c, fan_in=hidden).to(bf), u(c, fan_in=hidden))]
    padded = ocab.pad_ocab_operands(*tail)
    kw = dict(num_heads=heads, scale=(c // heads) ** -0.5, padded=padded,
              packed=ocab.pack_ocab_weights(padded, num_heads=heads, channels=c))
    x512 = [t[:512].contiguous() for t in (x, q, k, v)]
    calls = {"K6 Bw=2048": lambda: ocab.fused_ocab_block(x, q, k, v, bias, *tail, **kw),
             "K10a Bw=512": lambda: ocab.launch_ocab("K10a", *x512, bias, *tail, **kw,
                                                     store_h=True)}
    bind = ocab._library.__wrapped__
    bound = {}
    for name, path in libs.items():
        # the wrapper's library, bound as ocab._library binds it, from this copy
        ocab.load_library = lambda _name, path=path: ctypes.CDLL(str(path))
        bound[name] = bind()
    # the variants in turns, five passes; per variant the median of its passes
    passes = {key: {name: [] for name in libs} for key in calls}
    for _ in range(5):
        for name, lib in bound.items():
            ocab._library = lambda lib=lib: lib
            for key, call in calls.items():
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                rounds = []
                for _ in range(15):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    call()  # untimed: the device works while the timed calls are queued
                    s.record()
                    for _ in range(5):
                        call()
                    e.record()
                    e.synchronize()
                    rounds.append(s.elapsed_time(e) / 5)
                passes[key][name].append(statistics.median(rounds))
    times = {key: {name: statistics.median(t) for name, t in d.items()}
             for key, d in passes.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "bw": bw, "c": c, "heads": heads, "nk": nk, "ms": times}))


if __name__ == "__main__":
    main()
