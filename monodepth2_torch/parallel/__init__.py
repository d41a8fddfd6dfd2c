"""Data parallelism across processes, port of monodepth2_tpu/parallel: the
mesh over a process group's ranks (one card each), the GSPMD-semantics and
shard_map-semantics data-parallel steps, the process group's set-up and the
per-process input sharding."""

from .comm import COUNTS, all_reduce, all_reduce_, reset_counts
from .distributed import (
    PerHostSampler,
    initialize_distributed,
    local_batch_slice,
    process_info,
    shard_host_batch,
)
from .dp import (
    DataParallel,
    make_parallel_scanned_train_step,
    make_parallel_train_step,
    make_shardmap_train_step,
    shard_batch,
)
from .mesh import Mesh, make_mesh

__all__ = [
    "COUNTS",
    "all_reduce",
    "all_reduce_",
    "reset_counts",
    "Mesh",
    "make_mesh",
    "shard_batch",
    "DataParallel",
    "make_parallel_train_step",
    "make_parallel_scanned_train_step",
    "make_shardmap_train_step",
    "initialize_distributed",
    "process_info",
    "local_batch_slice",
    "shard_host_batch",
    "PerHostSampler",
]
