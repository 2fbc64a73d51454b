"""Multi-card runs of the port (the JAX ``parallel`` package): process-group
init, data parallelism over the ranks, and halo-exact spatial sharding of
the SwinIR and HAT forwards."""

from .mesh import (
    make_mesh,
    replicate,
    shard_batch,
    batch_sharding,
    replicated_sharding,
    sync_metrics,
    prefetch_to_mesh,
)
from .dist import initialize_distributed, process_index, process_count, is_master
from .spatial import make_spatial_swinir
from .spatial_hat import make_spatial_hat, make_spatial_hybrid

__all__ = [
    "make_mesh",
    "replicate",
    "shard_batch",
    "batch_sharding",
    "replicated_sharding",
    "sync_metrics",
    "prefetch_to_mesh",
    "initialize_distributed",
    "process_index",
    "process_count",
    "is_master",
    "make_spatial_swinir",
    "make_spatial_hat",
    "make_spatial_hybrid",
]
