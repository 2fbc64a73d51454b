"""Compare this tree's CUDA kernels with another checkout's on one card.

    python -m superresolution_def_tpu_torch.tools.kernel_ab --other DIR [--rounds 2] [--only RE]

``DIR`` is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive``). The tool

1. builds every CUDA source of both trees (one nvcc each, all at once) and
   compares, per source, the SASS of each kernel (``cuobjdump -sass``, the
   anonymous-namespace tokens of the mangled names and the padding of each
   line, which follows the widest instruction of the file, removed): the kernels
   that are identical, changed, or found in one tree only;
   for a kernel whose SASS differs, the number of differing lines and the
   first few of them;
2. times K7 (``fused_rdb_cm``) at B=8 and at B=2 with the stash (F/G = 48/24,
   256x256; its weights packed once, as the forwards pass them), K12
   (``fused_rdb``) at B=8 (on the tree's own packing: K12's
   ``pack_rdb_weights`` where the tree has it, else K7's), K10b
   (``ocab_bwd_attn``) at the fused-HAB step's Bw=512 (C=90, 6 heads, 144
   keys, the first 14 zero), K1 (``fused_swin_block``) at batch 3's Bw=768
   and K2 (``swin_block_fwd_h``) at the flagship train shape (Bw=2048,
   C=180, 6 heads, hidden 720), K5 (``fused_hab_block``) at the hybrid's
   Bw=2048 (C=90, 6 heads, hidden 360) unshifted and shifted (K1's and K5's
   weights packed once where the tree has ``pack_swin_block_weights`` and
   ``pack_hab_weights``, as its forwards pass them), K6
   (``fused_ocab_block``) at the hybrid's Bw=2048 and K10a (``ocab_fwd_h``)
   at the fused-HAB step's Bw=512 (C=90, 6 heads, hidden 360, 144 keys, the
   first 14 zero; the weights padded once, and packed once where the tree
   has ``pack_ocab_weights``), and end to end the
   fused SwinIR's batch-3 forward (config #1, ``make_fused_swinir``), the
   fused hybrid's batch-8 forward (config #2, ``make_fused_hybrid``) with the
   K7 trunk and with ``trunk_impl="kernel"`` (K12), and the
   swin GAN step at micro 8 (config #3) with the split and with the
   recompute backward; the training backwards at the flagship train shape
   (Bw=2048): K3 (``swin_block_bwd_mlp``), K4 (``swin_block_bwd_attn``), K4b
   (``swin_block_bwd``) and K1 packing its live weights on every call, as the
   recompute step runs it (so K1 + K4b stands beside K2 + K3 + K4); at the
   fused-HAB step's Bw=512 (C=90, drop-path scales that drop one of two
   samples) K9a (``hab_fwd_h``) and K9c (``hab_bwd_attn``), unshifted and
   shifted; the device busy time of one fused-HAB hybrid GAN step at
   micro 2 x accum 8 (config #4, ``torch.profiler``); K11 at
   ``chip_smoke.py``'s [k11] shapes on the views the modules pass
   (``window_attention_nomask`` at SwinIR's Bw=768 of 6 heads of 30, HAB's
   Bw=2048 of 6 heads of 15 and OCAB's Bw=2048 against 144 keys;
   ``window_attention_masked`` at HAB's with the shift mask of 256 windows)
   and the bf16 ``attn_impl="pallas"`` modules' forwards (SwinIR batch 3,
   the hybrid batch 8), each also as its device busy time; K13
   (``swin_stage_block``) in its ``full`` and ``mlp_tanhgelu`` modes at the
   flagship train shape (on K1's weights packed once where the tree's K13
   takes ``packed``); ``--only
   REGEX`` times only the entries whose names it finds; each tree in its
   own process, alternated other,
   this, this, other (``--rounds`` such sets of turns), by CUDA events on
   the same seeded inputs; each turn also hashes K1's output (Bw=768,
   flagship widths) to show whether the two trees' K1 give the same bits;
3. prints one JSON line per turn and a summary line.

Needs a CUDA card and nvcc; it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

SOURCES = ["swin_block", "swin_block_train", "swin_block_bwd", "hab_block", "ocab", "rdb_cm",
           "rdb_cm_bwd", "ocab_train", "window_attention", "fused_rdb", "swin_stage_ablation"]

# one tree's timings, run in a process of its own with the tree first on the path
TIMER = r'''
import inspect, json, re, statistics, sys
import numpy as np, torch
import importlib
from superresolution_def_tpu_torch.kernels import fused_rdb, fused_rdb_cm, swin_block_fwd_h
from superresolution_def_tpu_torch.kernels import (fused_ocab_block, hab_bwd_attn, hab_fwd_h,
                                                   ocab_bwd_attn, ocab_fwd_h, swin_block_bwd,
                                                   swin_block_bwd_attn, swin_block_bwd_mlp)
cm = importlib.import_module("superresolution_def_tpu_torch.kernels.fused_rdb_cm")

def cuda_ms(fn, reps=20, warmup=3, calls=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)

dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
f, g = 48, 24
ks = [torch.from_numpy((rng.standard_normal((3, 3, f + i * g, g if i < 4 else f))
                        * np.sqrt(2.0 / (9 * (f + i * g)))).astype(np.float32)).to(dev)
      for i in range(5)]
bs = [torch.from_numpy((0.05 * rng.standard_normal(g if i < 4 else f)).astype(np.float32)).to(dev)
      for i in range(5)]
pack7 = getattr(cm, "pack_rdb_cm_weights", None) or cm.pack_rdb_weights
p7 = pack7(ks, bs, dev)
pack12 = getattr(cm, "pack_rdb_weights", None) or cm.pack_rdb_cm_weights
p12 = pack12(ks, bs, dev)
x8 = torch.from_numpy(0.5 * rng.standard_normal((8, f, 256 * 256)).astype(np.float32)).to(dev, torch.bfloat16)
x2 = x8[:2].contiguous()
x8n = x8.reshape(8, f, 256, 256).permute(0, 2, 3, 1).contiguous()
stash = torch.empty(2, 256 * 256, f + 4 * g, dtype=torch.bfloat16, device=dev)
gen = torch.Generator().manual_seed(1)
def u(*shape, fan_in):
    return (torch.rand(*shape, generator=gen) * 2 - 1) / fan_in ** 0.5
c, hidden, bw = 180, 720, 2048
bf = torch.bfloat16
args = [a.to(dev) for a in (
    torch.randn(bw, 64, c, generator=gen).to(bf), 1 + 0.1 * torch.randn(c, generator=gen),
    0.1 * torch.randn(c, generator=gen), u(c, 3 * c, fan_in=c).to(bf), u(3 * c, fan_in=c),
    0.5 * torch.randn(6, 64, 64, generator=gen), u(c, c, fan_in=c).to(bf), u(c, fan_in=c),
    1 + 0.1 * torch.randn(c, generator=gen), 0.1 * torch.randn(c, generator=gen),
    u(c, hidden, fan_in=c).to(bf), u(hidden, fan_in=c), u(hidden, c, fan_in=hidden).to(bf),
    u(c, fan_in=hidden))]
kw = dict(num_heads=6, scale=30 ** -0.5)
import hashlib
from superresolution_def_tpu_torch import kernels as kmod
from superresolution_def_tpu_torch.kernels import (fused_hab_block, fused_swin_block,
                                                   make_fused_hybrid, make_fused_swinir)
from superresolution_def_tpu_torch.kernels import hab_block as hab_mod
from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
from superresolution_def_tpu_torch.ops import shift_window_attn_mask
from superresolution_def_tpu_torch.train import (CombinedGANLoss, VGG19Features,
                                                 create_swin_train_state, make_swin_train_step)
args768 = [a[:768] if a.shape[0] == bw else a for a in args]
k1 = fused_swin_block(*args768, **kw)
torch.cuda.synchronize()
k1_sha = hashlib.sha256(k1.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
# the inference forwards' weights: packed once where the tree packs them
pack1 = getattr(kmod, "pack_swin_block_weights", None)
kw1 = dict(kw, packed=pack1(args[3], args[6], args[10], args[12], num_heads=6)) if pack1 else kw
hgen = torch.Generator().manual_seed(2)
ch, hh = 90, 360
def hu(*shape, fan_in):
    return (torch.rand(*shape, generator=hgen) * 2 - 1) / fan_in ** 0.5
hab_args = [a.to(dev) for a in (
    torch.randn(bw, 64, ch, generator=hgen).to(bf), (0.1 * torch.randn(bw, 64, ch, generator=hgen)).to(bf),
    1 + 0.1 * torch.randn(ch, generator=hgen), 0.1 * torch.randn(ch, generator=hgen),
    hu(ch, 3 * ch, fan_in=ch).to(bf), hu(3 * ch, fan_in=ch), 0.5 * torch.randn(6, 64, 64, generator=hgen),
    hu(ch, ch, fan_in=ch).to(bf), hu(ch, fan_in=ch), 1 + 0.1 * torch.randn(ch, generator=hgen),
    0.1 * torch.randn(ch, generator=hgen), hu(ch, hh, fan_in=ch).to(bf), hu(hh, fan_in=ch),
    hu(hh, ch, fan_in=hh).to(bf), hu(ch, fan_in=hh))]
pad5 = hab_mod.pad_hab_operands(*hab_args[2:6], *hab_args[7:], num_heads=6)
kw5 = dict(num_heads=6, scale=15 ** -0.5, conv_scale=0.01, padded=pad5)
pack5 = getattr(kmod, "pack_hab_weights", None)
if pack5:
    kw5["packed"] = pack5(pad5, num_heads=6)
mask5 = torch.from_numpy(shift_window_attn_mask(128, 128, 8, 4)).to(dev)
swin = SwinIR(img_size=128, in_chans=1, embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
              window_size=8, mlp_ratio=4.0, upscale=4,
              generator=torch.Generator().manual_seed(0)).to(dev).eval()
swin_fwd = make_fused_swinir(swin)
xs = torch.from_numpy(rng.random((3, 128, 128, 1), dtype=np.float32)).to(dev)
hyb = HybridHATRealESRGAN(img_size=128, in_chans=1, embed_dim=90, depths=(6,) * 4,
                          num_heads=(6,) * 4, window_size=8, num_rrdb=12, num_feat=48,
                          num_grow_ch=24, generator=torch.Generator().manual_seed(0)).to(dev).eval()
fwd = make_fused_hybrid(hyb)
fwd12 = make_fused_hybrid(hyb, trunk_impl="kernel")
xh = torch.from_numpy(rng.random((8, 128, 128, 1), dtype=np.float32)).to(dev)
brng = np.random.default_rng(5)
batch = {"lr": brng.integers(0, 65535, (1, 8, 128, 128, 1), dtype=np.uint16),
         "hr": brng.integers(0, 65535, (1, 8, 512, 512, 1), dtype=np.uint16)}
vgg = VGG19Features(35, dtype=torch.bfloat16).to(dev).requires_grad_(False)
crit = CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5, adversarial_weight=0.005,
                       vgg_apply=vgg)
state = create_swin_train_state(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                fused=True, device=dev)
step = make_swin_train_step(state, accum_steps=1, criterion_g=crit)
state_r = create_swin_train_state(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                  fused=True, device=dev, backward="recompute")
step_r = make_swin_train_step(state_r, accum_steps=1, criterion_g=crit)
# the training backwards at Bw=2048: K3 on K2's h, K4 on K3's dh, K4b from x
dout = (1e-2 * torch.randn(bw, 64, c, generator=gen)).to(dev, bf)
_, h2 = swin_block_fwd_h(*args, **kw)
x, ln1_w, ln1_b, wqkv, bqkv, bias, wproj, _, ln2_w, ln2_b, w1, b1, w2, _ = args
mlp_args = (h2, dout, ln2_w, ln2_b, w1, b1, w2)
attn_args = (x, swin_block_bwd_mlp(*mlp_args)[0], ln1_w, ln1_b, wqkv, bqkv, bias, wproj)
# K9a and K9c at the fused-HAB step's 512 windows, one of two samples
# dropped per branch, the padded weights made once as the step caches them
b9 = 512
def per_sample(values):
    return torch.tensor(values, dtype=torch.float32).repeat_interleave(b9 // 2).to(dev)
dp1, dp2 = per_sample([1 / 0.9, 0.0]), per_sample([0.0, 1 / 0.9])
x9, cx9 = hab_args[0][:b9].contiguous(), hab_args[1][:b9].contiguous()
kw9 = dict(num_heads=6, scale=15 ** -0.5, padded=pad5)
dh9 = (1e-2 * torch.randn(b9, 64, ch, generator=hgen)).to(dev, bf)
def k9a(mask):
    return hab_fwd_h(x9, cx9, mask, dp1, dp2, *hab_args[2:], **kw9, conv_scale=0.01)
def k9c(mask):
    return hab_bwd_attn(x9, dh9, mask, dp1, *hab_args[2:6], hab_args[6], hab_args[7], **kw9)
# K10b at the fused-HAB step's 512 windows: 144 keys, the first 14 zero as
# the overlap gather leaves an edge window's
q10, k10, v10 = (torch.randn(b9, n, ch, generator=hgen).to(dev, bf) for n in (64, 144, 144))
k10[:, :14] = 0
v10[:, :14] = 0
bias10 = (0.5 * torch.randn(6, 64, 144, generator=hgen)).to(dev)
wproj10 = hu(ch, ch, fan_in=ch).to(dev, bf)
kw10 = dict(num_heads=6, scale=15 ** -0.5,
            padded_wproj=torch.nn.functional.pad(wproj10, (0, 6, 0, 6)).contiguous())
# K6 at the hybrid's 2048 windows and K10a at the fused-HAB step's 512, on
# K5's tail weights, padded once and packed once where the tree packs them
ocab_mod = importlib.import_module("superresolution_def_tpu_torch.kernels.ocab")
q6, k6, v6 = (torch.randn(bw, n, ch, generator=hgen).to(dev, bf) for n in (64, 144, 144))
k6[:, :14] = 0
v6[:, :14] = 0
bias6 = (0.5 * torch.randn(6, 64, 144, generator=hgen)).to(dev)
tail6 = hab_args[7:]
pad6 = ocab_mod.pad_ocab_operands(*tail6)
kw6 = dict(num_heads=6, scale=15 ** -0.5, padded=pad6)
pack6 = getattr(ocab_mod, "pack_ocab_weights", None)
if pack6:
    kw6["packed"] = pack6(pad6, num_heads=6, channels=ch)
args6 = (hab_args[0], q6, k6, v6, bias6, *tail6)
args10a = (*(a[:b9].contiguous() for a in args6[:4]), bias6, *tail6)
# the fused-HAB hybrid GAN step (config #4): its device busy time per step
from torch.profiler import ProfilerActivity, profile
from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step
hat_state = create_hat_train_state(torch.Generator().manual_seed(0), dtype=bf, fused=True,
                                   fused_hab=True, device=dev)
hat_step = make_hat_train_step(hat_state, accum_steps=8, criterion_g=CombinedGANLoss(
    pixel_weight=1.0, perceptual_weight=1.0, adversarial_weight=0.005, vgg_apply=vgg))
hrng = np.random.default_rng(6)
hat_batch = {"lr": hrng.integers(0, 65535, (8, 2, 128, 128, 1), dtype=np.uint16),
             "hr": hrng.integers(0, 65535, (8, 2, 512, 512, 1), dtype=np.uint16)}
def busy_ms(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    return (total + cur_e - cur_s) / 1e3
# K11 at chip_smoke.py's [k11] shapes, on the views the modules pass, and
# the attn_impl="pallas" modules' forwards (SwinIR batch 3, hybrid batch 8)
wattn = importlib.import_module("superresolution_def_tpu_torch.kernels.window_attention")
def attn_views(bw, hd, nk):
    if nk == 64:
        qkv = torch.randn(bw, 64, 3, 6, hd, generator=gen).to(dev, bf).permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2], (0.5 * torch.randn(6, 64, nk, generator=gen)).to(dev)
    kv = torch.randn(bw, nk, 2, 6, hd, generator=gen).to(dev, bf).permute(2, 0, 3, 1, 4)
    return (torch.randn(bw, 64, 6, hd, generator=gen).to(dev, bf).transpose(1, 2), kv[0], kv[1],
            (0.5 * torch.randn(6, 64, nk, generator=gen)).to(dev))
k11 = {"swin": attn_views(768, 30, 64), "hab": attn_views(2048, 15, 64),
       "ocab": attn_views(2048, 15, 144)}
swin_p = SwinIR(img_size=128, in_chans=1, embed_dim=180, depths=(6,) * 6, num_heads=(6,) * 6,
                window_size=8, mlp_ratio=4.0, upscale=4, attn_impl="pallas").to(dev, bf).eval()
hyb_p = HybridHATRealESRGAN(img_size=128, in_chans=1, embed_dim=90, depths=(6,) * 4,
                            num_heads=(6,) * 4, window_size=8, num_rrdb=12, num_feat=48,
                            num_grow_ch=24, attn_impl="pallas").to(dev, bf).eval()
def no_grad(fn):
    with torch.no_grad():
        return fn()
# K13 on the weights packed once where the tree's wrapper takes them
kw13 = kw1 if "packed" in inspect.signature(kmod.swin_stage_block).parameters else kw
def k13(mode):
    return cuda_ms(lambda: kmod.swin_stage_block(*args, mode=mode, **kw13), reps=10)
timings = {
    "K7 B=8": lambda: cuda_ms(lambda: fused_rdb_cm(x8, ks, bs, h=256, w=256, packed=p7), reps=10),
    "K7 B=2 stash": lambda: cuda_ms(lambda: fused_rdb_cm(x2, ks, bs, h=256, w=256, packed=p7,
                                                         stash=stash), reps=10),
    "K12 B=8": lambda: cuda_ms(lambda: fused_rdb(x8n, ks, bs, packed=p12), reps=10),
    "K1 Bw=768": lambda: cuda_ms(lambda: fused_swin_block(*args768, **kw1), reps=10),
    "K2 Bw=2048": lambda: cuda_ms(lambda: swin_block_fwd_h(*args, **kw), reps=10),
    "K5 Bw=2048 unshifted": lambda: cuda_ms(lambda: fused_hab_block(
        hab_args[0], hab_args[1], None, *hab_args[2:], **kw5), reps=10),
    "K5 Bw=2048 shifted": lambda: cuda_ms(lambda: fused_hab_block(
        hab_args[0], hab_args[1], mask5, *hab_args[2:], **kw5), reps=10),
    "swinir forward B=3": lambda: cuda_ms(lambda: swin_fwd(xs), reps=10, warmup=2, calls=2),
    "hybrid forward B=8": lambda: cuda_ms(lambda: fwd(xh), reps=5, warmup=2, calls=2),
    "hybrid forward B=8 K12 trunk": lambda: cuda_ms(lambda: fwd12(xh), reps=5, warmup=2, calls=2),
    "K10b Bw=512": lambda: cuda_ms(lambda: ocab_bwd_attn(q10, k10, v10, dh9, bias10, wproj10,
                                                         **kw10), reps=10),
    "K6 Bw=2048": lambda: cuda_ms(lambda: fused_ocab_block(*args6, **kw6), reps=10),
    "K10a Bw=512": lambda: cuda_ms(lambda: ocab_fwd_h(*args10a, **kw6), reps=10),
    "swin split step micro 8": lambda: cuda_ms(lambda: step(batch, 1e-4, 1e-4), reps=3,
                                               warmup=2, calls=2),
    "swin recompute step micro 8": lambda: cuda_ms(lambda: step_r(batch, 1e-4, 1e-4), reps=3,
                                                   warmup=2, calls=2),
    "K1 Bw=2048 packing": lambda: cuda_ms(lambda: fused_swin_block(*args, **kw), reps=10),
    "K3 Bw=2048": lambda: cuda_ms(lambda: swin_block_bwd_mlp(*mlp_args), reps=10),
    "K4 Bw=2048": lambda: cuda_ms(lambda: swin_block_bwd_attn(*attn_args, **kw), reps=10),
    "K4b Bw=2048": lambda: cuda_ms(lambda: swin_block_bwd(x, dout, *args[1:], **kw), reps=10),
    "K9a Bw=512 unshifted": lambda: cuda_ms(lambda: k9a(None), reps=10),
    "K9a Bw=512 shifted": lambda: cuda_ms(lambda: k9a(mask5), reps=10),
    "K9c Bw=512 unshifted": lambda: cuda_ms(lambda: k9c(None), reps=10),
    "K9c Bw=512 shifted": lambda: cuda_ms(lambda: k9c(mask5), reps=10),
    "fused-HAB step busy micro 2 x 8": lambda: busy_ms(lambda: hat_step(hat_batch, 1e-4, 1e-4)),
    "K11a swin Bw=768": lambda: cuda_ms(lambda: wattn.window_attention_nomask(
        *k11["swin"], scale=30 ** -0.5), reps=10),
    "K11a hab Bw=2048": lambda: cuda_ms(lambda: wattn.window_attention_nomask(
        *k11["hab"], scale=15 ** -0.5), reps=10),
    "K11a ocab Bw=2048": lambda: cuda_ms(lambda: wattn.window_attention_nomask(
        *k11["ocab"], scale=15 ** -0.5), reps=10),
    "K11b hab-shifted Bw=2048": lambda: cuda_ms(lambda: wattn.window_attention_masked(
        *k11["hab"], mask5, scale=15 ** -0.5), reps=10),
    "swinir pallas forward B=3": lambda: cuda_ms(lambda: no_grad(lambda: swin_p(xs.to(bf))),
                                                 reps=10, warmup=2, calls=2),
    "hybrid pallas forward B=8": lambda: cuda_ms(lambda: no_grad(lambda: hyb_p(xh.to(bf))),
                                                 reps=5, warmup=2, calls=2),
    "swinir pallas forward B=3 busy": lambda: busy_ms(lambda: no_grad(lambda: swin_p(xs.to(bf)))),
    "hybrid pallas forward B=8 busy": lambda: busy_ms(lambda: no_grad(lambda: hyb_p(xh.to(bf)))),
    "K13 full Bw=2048": lambda: k13("full"),
    "K13 mlp_tanhgelu Bw=2048": lambda: k13("mlp_tanhgelu"),
}
only = re.compile(sys.argv[1] if len(sys.argv) > 1 else "")
out = {"K1 sha256": k1_sha}
out.update({k: f() for k, f in timings.items() if only.search(k)})
print(json.dumps(out))
'''


def build(tree: Path) -> dict[str, Path]:
    """Every source of ``tree`` built by its own build module, at once."""
    code = ("import json; from superresolution_def_tpu_torch.kernels import _build; "
            f"print(json.dumps([str(p) for p in _build.build_all({SOURCES!r})]))")
    done = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                          check=True)
    return dict(zip(SOURCES, map(Path, json.loads(done.stdout.strip().splitlines()[-1]))))


ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(?=\d)")


def sass(lib: Path) -> dict[str, str]:
    """Kernel name (anonymous-namespace token removed) -> its SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    kernels, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                kernels[name] = "\n".join(body)
            name, body = ANON.sub("", m.group(1)), []
        elif name and line.strip():
            # cuobjdump pads every line to the widest instruction of the file
            body.append(" ".join(line.split()))
    if name:
        kernels[name] = "\n".join(body)
    return kernels


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", default="", help="time only the entries this regex finds")
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[2]
    other = args.other.resolve()
    libs = {"other": build(other), "this": build(here)}
    for src in SOURCES:
        old, new = sass(libs["other"][src]), sass(libs["this"][src])
        same = sorted(k for k in old if k in new and old[k] == new[k])
        changed = sorted(k for k in old if k in new and old[k] != new[k])
        print(json.dumps({"source": src, "identical": len(same), "changed": changed,
                          "only_other": sorted(set(old) - set(new)),
                          "only_this": sorted(set(new) - set(old))}), flush=True)
        for k in changed:
            was, now = old[k].splitlines(), new[k].splitlines()
            diff = [(x, y) for x, y in zip(was, now) if x != y]
            print(json.dumps({"kernel": k, "lines": [len(was), len(now)],
                              "differing": len(diff) + abs(len(was) - len(now)),
                              "first": diff[:4]}), flush=True)
    turns = {"other": [], "this": []}
    for _ in range(args.rounds):
        for tag in ("other", "this", "this", "other"):
            tree = other if tag == "other" else here
            done = subprocess.run([sys.executable, "-c", TIMER, args.only], cwd=tree,
                                  capture_output=True, text=True, check=True)
            t = json.loads(done.stdout.strip().splitlines()[-1])
            turns[tag].append(t)
            print(json.dumps({"tree": tag, **t}), flush=True)
    print(json.dumps({"summary": {tag: {k: [t[k] for t in ts] for k in ts[0]}
                                  for tag, ts in turns.items()}}), flush=True)
    shas = {t["K1 sha256"] for ts in turns.values() for t in ts}
    print(json.dumps({"K1 bits the same in both trees": len(shas) == 1}), flush=True)


if __name__ == "__main__":
    main()
