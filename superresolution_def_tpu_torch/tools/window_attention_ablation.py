"""Where K11's bf16 kernel spends its time: the kernel at other shapes of
its block, and against copies of itself with one part taken out or changed.

    python -m superresolution_def_tpu_torch.tools.window_attention_ablation [--out DIR]
        [--variants NAME ...]

Builds ``csrc/window_attention.cu`` as it is and copies of it, each with
text substitutions in ``window_attention.cu`` or ``attn_head_wg.cuh`` (the
per-head attention K11 shares with K6/K10a), into ``DIR`` (default: a
temporary directory), and times each at the four shapes of the attention
modules (``chip_smoke.py``'s [k11]): SwinIR's 768 windows of 6 heads of 30
(64 keys), HAB's 2048 windows of 6 heads of 15 without and with the shift
mask (nW = 256), OCAB's 2048 windows against 144 keys, q, k and v the
views the modules pass. CUDA events: the variants in turns, five passes,
each the median of 15 rounds of 5 calls; per variant the median of its
passes; and per variant and shape the kernel's device time per call
(``torch.profiler`` over 20 calls) and the host's time to enqueue one call
(20 calls without a synchronisation, the host clock): where the host takes
longer than the kernel, back-to-back calls time the host. The variants:

- ``kernel``: as built (two consumer warpgroups a block, three with
  K11b's mask at 64 keys; four stages each);
- ``nc1``, ``nc2``: one or two consumer warpgroups; ``nc3``: three at 64
  keys, mask or none; ``ns2``, ``ns6``: two or six stages a consumer;
  ``gather64``, ``gather256``: 64 or 256 gathering threads, not 128;
- ``no_gather``: the producer issues no copies of q, k or v (it still
  signals each stage);
- ``no_products``: the scores' and P . v's products are skipped, and with
  them what only they consume (the compiler drops the softmax and the
  scores' start: no bias or mask is read);
- ``no_store``: the output rows are staged but never written out;
- ``no_exp``: the softmax's exponentials are skipped (its sums and
  reciprocals stay);
- ``no_bias``: the scores start from zero, neither bias nor mask read;
- ``mask_zero``: K11b's mask is read but added times zero;
- ``mask_stage``: the producer copies K11b's mask into the item's stage
  (16-byte ``cp.async``), and the consumer adds it from there.

Outputs are wrong by design but for the kernel's, the ``nc``/``ns``
shapes' and ``mask_stage``'s; only their times mean anything. Prints one JSON line: the card,
its power limit, and per shape and variant the milliseconds of the event
timing, of the device and of the host. Needs a CUDA card and nvcc; imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..kernels import _build

SRC = "window_attention.cu"
ATTN = "attn_head_wg.cuh"
# mask_stage: the producer copies mask[b % nW] into the item's stage by
# 16-byte cp.async (nk % 4 == 0), and the consumer adds it from there
MASK_COPY = """      if constexpr (HAS_MASK) {
        float* md = reinterpret_cast<float*>(stg + (N + 2 * NK) * HP * 2);
        const float* ms = p.mask + (size_t)(b % p.nw) * N * nk;
        for (int i = pt; i < N * nk / 4; i += WA_GATHER) {
          const int r = i / (nk / 4), c = 4 * (i - r * (nk / 4));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                       ::"r"(smem_addr(md + r * LDB + c)), "l"(ms + (size_t)r * nk + c)
                       : "memory");
        }
      }
"""
MASK_ADD = """    const unsigned char* q_h = smem + idx * stage;
    if constexpr (HAS_MASK) {
      const float* md = reinterpret_cast<const float*>(q_h + (N + 2 * NK) * HP * 2);
#pragma unroll
      for (int t = 0; t < NK / 8; ++t) {
        const int c = 8 * t + 2 * t4;
        if (c < nk) {
          const float2 m0 = *reinterpret_cast<const float2*>(md + (r0 + g) * LDB + c);
          const float2 m1 = *reinterpret_cast<const float2*>(md + (r0 + g + 8) * LDB + c);
          s[4 * t] += m0.x; s[4 * t + 1] += m0.y; s[4 * t + 2] += m1.x; s[4 * t + 3] += m1.y;
        }
      }
    }
"""
# (file, old, new) substitutions per built variant
BUILDS = {
    "kernel": [],
    "no_gather": [(SRC, f"      fetch_head<HP, WA_GATHER, true>({a}",
                   f"      if (false) fetch_head<HP, WA_GATHER, true>({a}")
                  for a in ("stg, src", "stg + N * HP * 2", "stg + (N + NK)")],
    "no_products": [
        (ATTN, "for (int kk = 0; kk < HP / 16; ++kk) {\n    if constexpr (NK == 144)",
         "for (int kk = 0; kk < 0; ++kk) {\n    if constexpr (NK == 144)"),
        (ATTN, "for (int kb = 0; kb < NK / 16; ++kb)\n    fwd_mma_pv",
         "for (int kb = 0; kb < 0; ++kb)\n    fwd_mma_pv")],
    "no_store": [(SRC, "for (int i = lane; i < 2 * hd; i += 32) d4[i] = s4[i];",
                  "for (int i = lane; i < 0; i += 32) d4[i] = s4[i];")],
    "no_exp": [(ATTN, f"    s[4 * t{e}] = __expf(s[4 * t{e}] - m{m});",
                f"    s[4 * t{e}] = (s[4 * t{e}] - m{m});")
               for e, m in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))],
    "no_bias": [(ATTN, "    if (c < nk) {\n      float2 b0", "    if (false) {\n      float2 b0"),
                (ATTN, "const float ninf = -__int_as_float(0x7f800000);",
                 "const float ninf = 0.f;")],
    "mask_zero": [(ATTN, f"        {r} += {m};", f"        {r} += 0.f * {m};")
                  for r, m in (("b0.x", "m0.x"), ("b0.y", "m0.y"), ("b1.x", "m1.x"),
                               ("b1.y", "m1.y"))],
    "mask_stage": [
        (SRC, "      mbar_arrive_cp_async(&full[idx]);  // once this thread's copies land",
         MASK_COPY + "      mbar_arrive_cp_async(&full[idx]);  // once this thread's copies land"),
        (SRC, "  return (size_t)(N + 2 * nk_rows) * hp * 2;",
         "  return (size_t)(N + 2 * nk_rows) * hp * 2 + 4 * N * (nk_rows + 8);"),
        (SRC, "(s, bias_s, LDB,\n                                HAS_MASK ? p.mask",
         "(s, bias_s, LDB,\n                                false ? p.mask"),
        (SRC, "    const unsigned char* q_h = smem + idx * stage;\n", MASK_ADD)],
}
# the consumer warpgroups and stages of the kernel's other shapes
NC = "NK == 64 && HAS_MASK ? 3 : 2"
for key, old, new in (("nc1", NC, "1"), ("nc2", NC, "2"), ("nc3", NC, "NK == 64 ? 3 : 2"),
                      ("ns2", "WA_STAGES = 4", "WA_STAGES = 2"),
                      ("ns6", "WA_STAGES = 4", "WA_STAGES = 6"),
                      ("gather64", "WA_GATHER = 128;", "WA_GATHER = 64;"),
                      ("gather256", "WA_GATHER = 128;", "WA_GATHER = 256;")):
    BUILDS[key] = [(SRC, old, new)]


def build(out: Path, name: str) -> Path:
    """``window_attention.cu`` and ``attn_head_wg.cuh`` with ``name``'s
    substitutions, compiled into ``out/name/``; the other headers from
    ``csrc``."""
    texts = {f: (_build.CSRC / f).read_text() for f in (SRC, ATTN)}
    for f, old, new in BUILDS[name]:
        if old not in texts[f]:
            raise RuntimeError(f"{name}: {f} no longer contains {old!r}")
        texts[f] = texts[f].replace(old, new)
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    for f, text in texts.items():
        (d / f).write_text(text)
    lib = d / "libwindow_attention.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, f"-I{_build.CSRC}", "-o", str(lib),
                    str(d / SRC)], check=True, capture_output=True, text=True)
    return lib


def operands(bw, heads, hd, nk, gen, dev):
    """q, k, v as the modules pass them (views of one qkv product; OCAB's k
    and v of its gathered overlap windows) and a (heads, 64, nk) bias."""
    def t(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    if nk == 64:
        qkv = t(bw, 64, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q = t(bw, 64, heads, hd).transpose(1, 2)
        kv = t(bw, nk, 2, heads, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    return q, k, v, (0.5 * torch.randn(heads, 64, nk, generator=gen)).to(dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="build directory (default: temporary)")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="the variants to time (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = args.out or Path(tempfile.mkdtemp())
    names = [n for n in BUILDS if n == "kernel" or args.variants is None or n in args.variants]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: build(out, n), names)))

    wattn = importlib.import_module("superresolution_def_tpu_torch.kernels.window_attention")
    ops = importlib.import_module("superresolution_def_tpu_torch.ops")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    mask = torch.from_numpy(ops.shift_window_attn_mask(128, 128, 8, 4)).to(dev)  # (256, 64, 64)
    cases = {"swin Bw=768 d=30": (768, 30, 64, None), "hab Bw=2048 d=15": (2048, 15, 64, None),
             "hab-shifted Bw=2048 d=15": (2048, 15, 64, mask),
             "ocab Bw=2048 d=15 144 keys": (2048, 15, 144, None)}
    calls = {}
    for key, (bw, hd, nk, m) in cases.items():
        q, k, v, bias = operands(bw, 6, hd, nk, gen, dev)
        calls[key] = (q, k, v, bias, m, hd**-0.5)
    bind = wattn._library.__wrapped__
    bound = {}
    for name, path in libs.items():
        # the wrapper's library, bound as window_attention._library binds it
        wattn.load_library = lambda _name, path=path: ctypes.CDLL(str(path))
        bound[name] = bind()
    passes = {key: {name: [] for name in bound} for key in calls}
    for _ in range(5):
        for name, lib in bound.items():
            wattn._library = lambda lib=lib: lib
            for key, (q, k, v, bias, m, sc) in calls.items():

                def call():
                    wattn._launch("K11", q, k, v, bias, m, sc)

                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                rounds = []
                for _ in range(15):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    for _ in range(5):
                        call()
                    e.record()
                    e.synchronize()
                    rounds.append(s.elapsed_time(e) / 5)
                passes[key][name].append(statistics.median(rounds))
    times = {key: {name: statistics.median(t) for name, t in d.items() if t}
             for key, d in passes.items()}
    device, host = {key: {} for key in calls}, {key: {} for key in calls}
    for name, lib in bound.items():
        wattn._library = lambda lib=lib: lib
        for key, (q, k, v, bias, m, sc) in calls.items():

            def call():
                wattn._launch("K11", q, k, v, bias, m, sc)

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            total = 0.0
            for e in prof.key_averages():
                if "attn_wg_kernel" in e.key:
                    t = getattr(e, "device_time_total", None)
                    total += (e.cuda_time_total if t is None else t) / 1e3 / 20
            device[key][name] = total
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            host[key][name] = (time.perf_counter() - t0) / 20 * 1e3
            torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "heads": 6, "ms": times, "device_ms": device,
                      "host_ms": host}))


if __name__ == "__main__":
    main()
