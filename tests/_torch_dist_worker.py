"""One rank of a gloo world for the port's data-parallel and spatial tests.

    python tests/_torch_dist_worker.py MODE RANK WORLD DIR

``DIR/inputs.pt`` (``torch.save``) holds what the mode needs; the rank
writes ``DIR/rank<RANK>.pt``. A world of more than one joins the process
group through ``file://DIR/store`` (no port, so parallel test workers
cannot collide); a world of one makes no group. The parent
(tests/test_torch_parallel.py, tests/test_torch_spatial.py) starts the
ranks with :func:`run_world` and computes the references, the JAX
package's among them. This script imports only torch,
numpy and the port; every result carries the modules of jax or the JAX
package that the process loaded (none, the guards test checks).

Modes:

- ``swin_step``: one SwinIR GAN step (``make_swin_train_step(mesh=)``) on
  this rank's rows of the batch, from the given state dicts; with
  ``nan_rank`` that rank's D loss is NaN (after its collectives ran);
- ``hat_step``: one hybrid GAN step (``make_hat_train_step(mesh=)``),
  augmentation and drop-path on, warm-up or GAN, ``remat_loss`` and the
  generator's ``remat`` as the inputs say (off by default);
- ``spatial``: ``make_spatial_swinir`` / ``make_spatial_hybrid`` on the frame;
- ``tiled``: ``tiled_sr(mesh=)`` of a tiny SwinIR on each frame;
- ``replicate``: a module with spectral norm and its AdamW state, made
  from each rank's own seed, replicated from rank 0;
- ``train``: ``cli.main train --device cpu`` with the given arguments,
  recording which files this rank wrote.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent


def run_world(mode: str, world: int, workdir: Path, inputs: dict, timeout: float = 300) -> list:
    """Runs ``world`` ranks of ``mode`` as subprocesses (two torch threads
    each) and returns each rank's results. A rank that fails, or a world
    that has not finished in ``timeout`` seconds, fails the caller with the
    ranks' output."""
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k not in (
        "PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo")
    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, mode, str(r), str(world), str(workdir)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=workdir))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode}: a world of {world} did not finish in {timeout} s:\n"
                             + "\n".join(log.read_text()[-2000:] for log in logs)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{mode} rank {r} of {world}:\n{logs[r].read_text()[-4000:]}"
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _states(state, inputs):
    state.g.load_state_dict(inputs["g"])
    state.ema.load_state_dict(inputs["ema"])
    state.d.load_state_dict(inputs["d"])


def _results(state, metrics):
    """The state and the step's metrics, its 0-d tensors as floats."""
    return {"g": state.g.state_dict(), "d": state.d.state_dict(),
            "ema": state.ema.state_dict(), "metrics": {k: float(v) for k, v in metrics.items()}}


def _rows(batch, mesh):
    """This rank's rows of every micro-batch of (accum, B, H, W, 1) arrays."""
    m = batch["lr"].shape[1] // mesh.size
    return {k: v[:, mesh.rank * m:(mesh.rank + 1) * m] for k, v in batch.items()}


def swin_step(inputs, mesh):
    from superresolution_def_tpu_torch.train import (
        CombinedGANLoss,
        DiscriminatorLoss,
        VGG19Features,
        create_swin_train_state,
        make_swin_train_step,
    )

    class NaNOnRank(DiscriminatorLoss):
        def __call__(self, real_pred, fake_pred):
            adv, parts = super().__call__(real_pred, fake_pred)
            if mesh.rank == inputs.get("nan_rank"):
                adv = adv + float("nan")
            return adv, parts

    state = create_swin_train_state(torch.Generator().manual_seed(0), **inputs["config"],
                                    device="cpu")
    _states(state, inputs)
    vgg = VGG19Features(35)
    vgg.load_state_dict(inputs["vgg"])
    step = make_swin_train_step(
        state, accum_steps=inputs["batch"]["lr"].shape[0], augment=False,
        criterion_g=CombinedGANLoss(pixel_weight=1.0, perceptual_weight=0.5,
                                    adversarial_weight=0.005,
                                    vgg_apply=vgg.requires_grad_(False)),
        criterion_d=NaNOnRank(), mesh=mesh)
    return _results(state, step(_rows(inputs["batch"], mesh), 1e-4, 1e-4))


def hat_step(inputs, mesh):
    from superresolution_def_tpu_torch.train import create_hat_train_state, make_hat_train_step

    state = create_hat_train_state(torch.Generator().manual_seed(0), **inputs["config"],
                                   device="cpu", remat=inputs.get("remat", False))
    _states(state, inputs)
    step = make_hat_train_step(state, accum_steps=inputs["batch"]["lr"].shape[0],
                               generator=torch.Generator().manual_seed(1),
                               drop_generator=torch.Generator().manual_seed(2), mesh=mesh,
                               remat_loss=inputs.get("remat_loss", False))
    metrics = step(_rows(inputs["batch"], mesh), 1e-4, 1e-4, warmup=inputs["warmup"])
    return _results(state, metrics)


def spatial(inputs, mesh):
    from superresolution_def_tpu_torch.models import HybridHATRealESRGAN, SwinIR
    from superresolution_def_tpu_torch.parallel import make_spatial_hybrid, make_spatial_swinir

    cls, make = ((SwinIR, make_spatial_swinir) if inputs["arch"] == "swin"
                 else (HybridHATRealESRGAN, make_spatial_hybrid))
    model = cls(**inputs["config"]).eval()
    model.load_state_dict(inputs["state_dict"])
    return {"out": make(mesh, model)(inputs["x"])}


def tiled(inputs, mesh):
    from superresolution_def_tpu_torch.cli.infer import tiled_sr
    from superresolution_def_tpu_torch.models import SwinIR

    model = SwinIR(**inputs["config"]).eval()
    model.load_state_dict(inputs["state_dict"])
    return {"outs": [tiled_sr(model, img, tile=inputs["tile"], overlap=inputs["overlap"],
                              device="cpu", mesh=mesh) for img in inputs["imgs"]]}


def replicate(inputs, mesh):
    """A spectral-norm conv and a linear layer with their AdamW state, made
    from this rank's own seed, then replicated from rank 0."""
    from superresolution_def_tpu_torch.models import SNConv2d
    from superresolution_def_tpu_torch.parallel import replicate as replicate_

    torch.manual_seed(mesh.rank)
    net = torch.nn.ModuleDict({"sn": SNConv2d(1, 4, 3), "lin": torch.nn.Linear(4, 2)})
    opt = torch.optim.AdamW(net.parameters())
    net["lin"](net["sn"](torch.rand(1, 8, 8, 1), True)).sum().backward()
    opt.step()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    versions = [p._version for p in net.parameters()]
    replicate_([net, opt], mesh)
    return {"before": before, "state": net.state_dict(), "opt": opt.state_dict()["state"],
            "moved": [p._version > v for p, v in zip(net.parameters(), versions)]}


def train(inputs, mesh):
    import superresolution_def_tpu_torch.cli.trainers as trainers
    from superresolution_def_tpu_torch.cli.main import main

    wrote = []

    def records(fn, arg=0):
        def wrapper(*a, **kw):
            wrote.append(str(a[arg]))
            return fn(*a, **kw)
        return wrapper

    save = torch.save
    torch.save = records(save, 1)
    for name in ("save_tris_preview", "CSVLogger", "TensorBoardLogger"):
        setattr(trainers, name, records(getattr(trainers, name)))
    try:
        last = main(["train", "--device", "cpu", *inputs["argv"]])
    finally:
        torch.save = save
    return {"last": last, "wrote": wrote}


def main() -> None:
    mode, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(2)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    from superresolution_def_tpu_torch.parallel import initialize_distributed, make_mesh

    if world > 1:
        initialize_distributed("cpu", init_method=f"file://{workdir / 'store'}",
                               world_size=world, rank=rank)
    try:
        out = {"swin_step": swin_step, "hat_step": hat_step, "spatial": spatial,
               "tiled": tiled, "replicate": replicate, "train": train}[mode](
                   inputs, make_mesh("cpu"))
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()
    out["jax_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "orbax", "superresolution_def_tpu"))
    torch.save(out, workdir / f"rank{rank}.pt")


if __name__ == "__main__":
    main()
