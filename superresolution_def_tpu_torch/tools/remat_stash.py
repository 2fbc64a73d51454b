"""What ``remat_loss`` keeps of the loss tail's stash, reckoned from shapes.

    python -m superresolution_def_tpu_torch.tools.remat_stash [--micro 8] [--hr 512]

For each module of the loss tail (both U-Net discriminators and VGG19[:36],
bf16 as the card trains them) one forward of a ``(micro, hr, hr, 1)`` batch
runs on the meta device, which computes shapes and no values, under a
``saved_tensors_hooks`` pair that adds up the bytes autograd saves for the
backward: plain, and with the module's rematerialized regions, where what is
saved is each region's inputs (the stage boundaries). Prints one JSON line a
module. The numbers are shapes times element sizes, not device readings:
the allocator's peak on the card is read by ``chip_smoke.py`` [remat].
"""

from __future__ import annotations

import argparse
import json

import torch

from ..models import UNetDiscriminatorSNHAT, UNetDiscriminatorSNSwin
from ..train.vgg import VGG19Features


def saved_bytes(forward) -> int:
    """Bytes of the distinct tensors that autograd saves during ``forward()``."""
    seen: dict[int, int] = {}

    def pack(t):
        seen[id(t)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        forward()
    return sum(seen.values())


def stash(micro: int = 8, hr: int = 512) -> dict[str, dict[str, int]]:
    """Per module, the plain and the rematerialized bytes of one forward."""
    dt = torch.bfloat16
    x = torch.empty(micro, hr, hr, 1, device="meta", requires_grad=True)
    modules = {"UNetDiscriminatorSNSwin": UNetDiscriminatorSNSwin(dtype=dt),
               "UNetDiscriminatorSNHAT": UNetDiscriminatorSNHAT(dtype=dt),
               "VGG19Features": VGG19Features(35, dtype=dt).requires_grad_(False)}
    out = {}
    for name, module in modules.items():
        module = module.to("meta")
        if name == "VGG19Features":
            def run(remat, m=module):
                return m(x, remat=remat)
        else:
            def run(remat, m=module):
                return m(x, True, remat)
        out[name] = {"plain": saved_bytes(lambda: run(False)),
                     "remat": saved_bytes(lambda: run(True))}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--micro", type=int, default=8)
    p.add_argument("--hr", type=int, default=512)
    args = p.parse_args(argv)
    result = stash(args.micro, args.hr)
    for name, b in result.items():
        print(json.dumps({"module": name, "micro": args.micro, "hr": args.hr,
                          "plain_bytes": b["plain"], "remat_bytes": b["remat"]}), flush=True)
    return result


if __name__ == "__main__":
    main()
