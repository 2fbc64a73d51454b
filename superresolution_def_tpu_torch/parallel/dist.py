"""Process-group init: the ``init_process_group`` of the reference's launch (the JAX ``parallel/dist.py``).

One process drives one card, as the reference's torchrun launch does
(start_swin.py:137-144, train_swin.py:81-83): ``torchrun --nproc-per-node N
-m superresolution_def_tpu_torch.cli.main train ...`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
:func:`initialize_distributed` joins that world (``env://``). Without those
variables and without an explicit ``init_method`` the run is a world of one
and no process group is made.

The backend follows the device asked for: NCCL for ``cuda`` (the card is
``cuda:LOCAL_RANK``), gloo for ``cpu``. There is no fall-back from one to
the other: a failed init raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(
    device: torch.device | str = "cuda",
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
) -> torch.device:
    """Join this run's process group and return this rank's device.

    ``init_method`` (e.g. ``file:///tmp/store``, as the tests use) needs
    ``world_size`` and ``rank``; without it torchrun's environment is read.
    A process group that exists already is kept (it must use the device's
    backend). ``local_rank`` (default ``LOCAL_RANK``, else ``rank``) picks
    the card."""
    device = resolve_device(device)
    backend = BACKENDS[device.type]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, but {device} "
                               f"needs {backend}")
        return _rank_device(device, local_rank)
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return device  # a world of one
    if init_method is not None and (world_size is None or rank is None):
        raise ValueError("init_method needs world_size and rank")
    device = _rank_device(device, local_rank if local_rank is not None else rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if init_method is None else dict(init_method=init_method,
                                                world_size=world_size, rank=rank)
    if device.type == "cuda":
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)
    return device


def _rank_device(device: torch.device, local_rank: int | None) -> torch.device:
    if device.type != "cuda":
        return device
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local_rank)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    """Rank-0 discipline for filesystem writes (train_swin.py:116-119)."""
    return process_index() == 0
