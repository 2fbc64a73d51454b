"""Data parallelism over a process group — the reference's NCCL DDP (the JAX ``parallel/mesh.py``).

The JAX package runs one SPMD program over a device mesh: state replicated,
batches sharded over the micro-batch axis, the gradient all-reduce inserted
by XLA. The port runs one process per card (torchrun) and does by hand what
XLA inserts:

- :func:`make_mesh`: the world as one data axis (group, size, rank, device);
  a world of one has no group and every collective below is the identity;
- :func:`replicate`: rank 0's parameters, buffers (spectral-norm ``u``/``v``
  included) and optimizer states broadcast to every rank;
- :func:`shard_batch` / :func:`prefetch_to_mesh`: each rank's own rows,
  uploaded (from pinned memory on a side CUDA stream while the step before
  runs);
- :class:`FlatGrads`: G's and D's gradients as views of one flat buffer,
  averaged over the ranks once per optimizer step in one all-reduce (no
  ``DistributedDataParallel``: its per-backward hooks fit neither the
  two-phase GAN step nor the accumulation over micro-batches);
- :func:`batch_means` / :func:`all_reduce_sum`: statistics over the global
  batch (RaGAN's means), differentiable, written once for every world size;
- :func:`sync_metrics`: host-side metric sums over the ranks
  (train_swin.py:292-297), a passthrough at one rank.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterable, Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .dist import BACKENDS


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data axis over the ranks of a process group; ``group`` None is a
    world of one (no collective runs)."""

    group: Any
    size: int
    rank: int
    device: torch.device


def make_mesh(device: torch.device | str | None = None) -> Mesh:
    """The world this process runs in: the default process group when one
    exists (its backend must serve ``device``), else a world of one on
    ``device`` (default: the card)."""
    if not dist.is_initialized():
        return Mesh(None, 1, 0, resolve_device(device or "cuda"))
    backend = dist.get_backend()
    if backend == BACKENDS["cuda"]:
        found = torch.device("cuda", torch.cuda.current_device())
    else:
        found = torch.device("cpu")
    if device is not None and torch.device(device).type != found.type:
        raise RuntimeError(f"the process group runs {backend}, which does not serve {device}")
    return Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), found)


class Sharding(NamedTuple):
    """Where an array lives on the mesh (the JAX ``NamedSharding``'s place):
    on every rank (``axis`` None) or split into equal runs of rows along
    ``axis``, rank r holding the r-th. A descriptor only: each rank's data
    stream already yields its own rows (the rank-strided ``DataIterator``)."""

    mesh: Mesh
    axis: int | None


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def batch_sharding(mesh: Mesh, batch_axis: int = 1, ndim: int = 5) -> Sharding:
    """Split dim ``batch_axis`` (default: the micro axis of (accum, B, H, W, C))."""
    if not -ndim <= batch_axis < ndim:
        raise ValueError(f"batch_axis {batch_axis} outside {ndim} dims")
    return Sharding(mesh, batch_axis % ndim)


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #
class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the upstream gradients over the
    ranks too, so with :class:`FlatGrads`' average a global statistic gets
    its exact global gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself in a world of one."""
    if mesh is None or mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def batch_means(xs: list[torch.Tensor], mesh: Mesh | None = None) -> list[torch.Tensor]:
    """The mean of each of ``xs`` over every rank's elements: the local sums
    all-reduced together (one collective) over the global counts, one
    formula at every world size."""
    size = 1 if mesh is None else mesh.size
    sums = all_reduce_sum(torch.stack([x.sum() for x in xs]), mesh)
    return [sums[i] / (x.numel() * size) for i, x in enumerate(xs)]


def global_mean(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """The mean over the ranks of a per-rank value (a loss over equal local
    batches), detached."""
    size = 1 if mesh is None else mesh.size
    return all_reduce_sum(x.detach(), mesh) / size


def _collective_flat(tensors: list[torch.Tensor], mesh: Mesh, op) -> None:
    """``op(flat)`` on one flat buffer per (dtype, device) group, on the
    mesh's device; the results copied back into ``tensors`` in place (one
    ``_foreach_copy_`` a group, not a launch a tensor)."""
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group]).to(mesh.device)
            op(flat)
            parts = flat.to(group[0].device).split([t.numel() for t in group])
            torch._foreach_copy_(group, [v.view_as(t) for v, t in zip(parts, group)])


class FlatGrads:
    """The gradients of ``modules``' parameters as views of one flat buffer
    per (dtype, device): a step zeroes them in one launch, and
    :meth:`average` averages them over the ranks in one in-place all-reduce
    a buffer, with no gather or scatter copy (the all-reduce XLA inserts in
    the JAX step). Backward accumulates into existing gradients in place,
    so the views hold. ``segments[i]`` holds the i-th module's gradients as
    one contiguous run of each buffer, for selects written in place.
    Without a mesh, or in a world of one without a group, :meth:`average`
    is the identity."""

    def __init__(self, modules: Iterable[torch.nn.Module], mesh: Mesh | None):
        self.mesh = mesh
        modules = list(modules)
        groups: dict[tuple, list[tuple[int, torch.nn.Parameter]]] = {}
        for i, m in enumerate(modules):
            for p in m.parameters():
                groups.setdefault((p.dtype, p.device), []).append((i, p))
        self.buffers, self._views = [], []
        # each module's gradients: one contiguous run of each buffer
        self.segments: list[list[torch.Tensor]] = [[] for _ in modules]
        for (dtype, device), owned in groups.items():
            params = [p for _, p in owned]
            flat = torch.zeros(sum(p.numel() for p in params), dtype=dtype, device=device)
            parts = flat.split([p.numel() for p in params])
            self.buffers.append(flat)
            self._views += [(p, v.view_as(p)) for p, v in zip(params, parts)]
            start = 0
            for i, _ in enumerate(modules):
                n = sum(p.numel() for j, p in owned if j == i)
                if n:
                    self.segments[i].append(flat[start:start + n])
                start += n

    def zero_(self) -> None:
        """Zero every gradient, pointing each parameter's ``.grad`` at its
        view again when another owner took it (a second step on the same
        state)."""
        for p, v in self._views:
            if p.grad is not v:
                p.grad = v
        for flat in self.buffers:
            flat.zero_()

    def average(self) -> None:
        """Average the accumulated gradients over the ranks; call once per
        optimizer step, after the last micro-batch's backward."""
        if self.mesh is None or self.mesh.group is None:
            return
        if any(p.grad is not v for p, v in self._views):
            raise RuntimeError("a gradient left its flat buffer: the ranks would diverge")
        for flat in self.buffers:
            dist.all_reduce(flat, group=self.mesh.group)
            flat /= self.mesh.size


def _state_tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict().values())
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state.get(p, {})
                out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
        return out
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _state_tensors(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _state_tensors(o)]
    return []


def replicate(obj, mesh: Mesh):
    """Broadcast rank 0's state to every rank, in place, and return ``obj``:
    an ``nn.Module`` (parameters and buffers), an optimizer (its states), a
    train state (its modules and optimizers) or a list of these. Every rank
    must hold the same structure; a rank that does not raises."""
    if mesh.group is None:
        return obj
    tensors = _state_tensors(obj)
    count = torch.tensor([len(tensors), -len(tensors)], device=mesh.device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=mesh.group)
    if count[0] != -count[1]:
        raise RuntimeError(f"replicate: the ranks hold {-int(count[1])} to {int(count[0])} "
                           "state tensors")
    _collective_flat(tensors, mesh, lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return obj


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)


def sync_metrics(metrics: Mapping[str, Any], mesh: Mesh | None = None) -> dict[str, float]:
    """Sum metric scalars over the ranks (a passthrough at one rank), as
    the reference all-reduces its metric tensors (train_swin.py:292-297)."""
    if mesh is None and dist.is_initialized():
        mesh = make_mesh()
    if mesh is None or mesh.group is None:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                       device=mesh.device)
    dist.all_reduce(vec, group=mesh.group)
    return dict(zip(keys, vec.tolist()))


# --------------------------------------------------------------------------- #
# batches onto the mesh
# --------------------------------------------------------------------------- #
def _upload(a, device: torch.device) -> torch.Tensor:
    """One array to ``device``: uint16 travels as int16 tensors of the same
    bits (torch has no uint16 arithmetic; ``train.steps.to01`` widens them),
    from pinned memory when the device is a card."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict[str, torch.Tensor]:
    """Upload this rank's rows of each array to the mesh's device. Each
    rank's data stream already yields its own rows (the rank-strided
    ``DataIterator``), so the arrays go up whole."""
    return {k: _upload(v, mesh.device) for k, v in batch.items()}


_DEPTH = 2  # batches staged ahead


class _MeshPrefetcher:
    """Iterator staging batches onto the mesh from a background thread.

    Yields ``(host_batch, staged_batch)`` pairs: the upload of batch i+1
    overlaps the step on batch i, the port of the reference's
    ``pin_memory=True`` DataLoader and async ``.to(device)`` copies
    (train_swin.py:142-145, train_hat.py:129-130). On a card each batch is
    copied from pinned memory on a side stream; the consumer's stream waits
    on that batch's event, and the staged tensors are recorded on the
    consumer's stream so the allocator keeps them until its work is done.

    The host batch is passed through untouched; ``transform`` (e.g. the
    accumulation reshape) applies before staging. ``close()`` (or leaving
    the ``with`` block) stops and joins the worker, so an early ``break``
    leaves no batch staged. A worker exception (loader IO errors) is
    re-raised in the consuming thread on the next ``__next__``.
    """

    def __init__(self, batches, mesh: Mesh, transform=None):
        self._q: queue.Queue = queue.Queue(maxsize=_DEPTH)
        self._stop = threading.Event()
        self._END = object()
        self._closed = False
        self._device = mesh.device
        cuda = mesh.device.type == "cuda"
        side = torch.cuda.Stream(mesh.device) if cuda else None

        def stage(b):
            host = transform(b) if transform is not None else b
            if side is None:
                return shard_batch(host, mesh), None
            with torch.cuda.device(mesh.device), torch.cuda.stream(side):
                staged = shard_batch(host, mesh)
                event = torch.cuda.Event()
                event.record(side)
            return staged, event

        def worker():
            try:
                for b in batches:
                    item = (b, *stage(b))
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.25)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
                self._q.put(self._END)
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer, not swallowed
                self._q.put(e)

        self._thread = threading.Thread(target=worker, daemon=True, name="mesh-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        host, staged, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in staged.values():
                t.record_stream(stream)
        return host, staged

    def close(self) -> None:
        """Stop the worker, drop staged batches, and join the thread."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so a put-blocked worker can observe the stop flag and exit
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # backstop only; close() is the contract
        self.close()


def prefetch_to_mesh(batches, mesh: Mesh, transform=None) -> _MeshPrefetcher:
    """Stage ``batches`` onto the mesh two ahead (see :class:`_MeshPrefetcher`).

    Returns a closeable iterator; use it as a context manager so early exits
    (``max_steps_per_epoch``, exceptions) release the staging thread and its
    staged batches deterministically."""
    return _MeshPrefetcher(batches, mesh, transform=transform)
