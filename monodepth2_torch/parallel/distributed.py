"""Multi-process scaffolding, port of monodepth2_tpu/parallel/distributed.py:
the process group's set-up and per-process input sharding.

One process drives one card (PyTorch has no single process over several
cards, so the JAX package's one-process-per-host layout becomes one process
per card). `initialize_distributed` reads torch's own launcher environment
(`torchrun` sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK)
and keeps the JAX contract: no configuration is a single-process no-op, a
partial one fails loudly instead of training N independent jobs. Each
process loads only its rows of every global batch (`PerHostSampler`), in
rank order, which is the layout `parallel.dp.shard_batch` gives out.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    device: str | torch.device = "cuda",
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Initialize torch.distributed's default process group when configured;
    no-op otherwise.

    Configuration comes from the arguments or from the launcher's environment:
    coordinator_address "host:port" (else MASTER_ADDR and MASTER_PORT),
    num_processes (WORLD_SIZE), process_id (RANK), local_rank (LOCAL_RANK,
    else process_id modulo the cards visible). Returns True when a group was
    initialized, False for a single-process run with no configuration.

    A process_id without the rest raises ValueError, as does any other
    partial configuration. `auto=True` without configuration raises
    RuntimeError: torch has no topology to detect, and falling back to one
    process would train N independent copies.

    The backend is NCCL on the card and gloo on the CPU unless `backend` is
    given (gloo also takes CUDA tensors, which lets two ranks share one
    card, where NCCL refuses). On the card each process binds
    cuda:local_rank.
    """
    if coordinator_address is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if local_rank is None and "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            # a lone process_id is explicit (partial) configuration: one
            # process each would silently train N identically seeded jobs
            raise ValueError(
                "RANK/process_id is set but coordinator_address and num_processes are not — set "
                "MASTER_ADDR, MASTER_PORT and WORLD_SIZE too (or unset RANK for a single-process run)"
            )
        if not auto:
            return False
        raise RuntimeError(
            "initialize_distributed(auto=True) found no configuration: set MASTER_ADDR, MASTER_PORT, "
            "WORLD_SIZE and RANK (torchrun does), or pass them"
        )
    missing = [name for name, v in (("coordinator_address (MASTER_ADDR, MASTER_PORT)", coordinator_address),
                                    ("num_processes (WORLD_SIZE)", num_processes),
                                    ("process_id (RANK)", process_id)) if v is None]
    if missing:
        raise ValueError(f"partial distributed configuration: {', '.join(missing)} not set")
    device = _bind_device(device, process_id if local_rank is None else local_rank, local_rank is not None)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=int(num_processes), rank=int(process_id),
    )
    return True


def _bind_device(device, index: int, explicit: bool) -> torch.device:
    """This process's device: cuda:index (modulo the cards visible unless
    `index` is a LOCAL_RANK) bound as the current card, or the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", index if explicit else index % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def initialize_single_process(device: str | torch.device = "cuda", backend: Optional[str] = None) -> None:
    """A group of one (rank 0 of 1) over an in-process store: what
    parallel.make_mesh sets up when no group exists, so that a one-process
    mesh runs the collectives of every data-parallel path."""
    device = _bind_device(device, 0, False)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"), store=dist.HashStore(), world_size=1, rank=0,
    )


def process_info() -> tuple:
    """(process_id, num_processes) — (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_batch_slice(global_batch_size: int) -> slice:
    """The slice of every global batch this process must load: contiguous
    equal slices in rank order."""
    pid, pcount = process_info()
    if global_batch_size % pcount:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pcount} processes")
    per = global_batch_size // pcount
    return slice(pid * per, (pid + 1) * per)


def _to_device(batch, device: torch.device):
    """An array-or-{"frames","K"} batch as tensors on `device`."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor) else batch).to(device)


def shard_host_batch(local_batch, mesh, axis: str = "data", stacked: bool = False):
    """This process's rows of the global batch on its device: each process
    feeds only its own card, no process holds the global batch.

    local_batch: this process's rows (see `local_batch_slice`), an array, a
    tensor or a {"frames","K"} dict of them. stacked=True for (K, N_local,
    ...) steps_per_call groups: every process holds all K micro-batches of
    its rows. Single-process, local == global, and this equals
    `shard_batch`."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return _to_device(local_batch, mesh.device)


class PerHostSampler:
    """Wraps a dataset so a DataLoader on this process yields only the local
    rows of each global batch, while the global shuffle order stays identical
    on every process (same seed → same permutation). Copied from
    monodepth2_tpu/parallel/distributed.py: the same (seed, epoch) global
    permutation and the same per-item default_rng([seed, epoch, gidx]), so
    it yields the indices and augmentation draws of the JAX package's.

    Use: loader = DataLoader(PerHostSampler(ds, global_batch), per_host_batch)
    with shuffle=False — the sampler owns the global shuffle so that rows
    [pid·B/P, (pid+1)·B/P) of every global batch land on process pid in
    order.
    """

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        seed: int = 0,
        process_id: Optional[int] = None,
        num_processes: Optional[int] = None,
    ):
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.seed = seed
        pid, pcount = process_info()
        self.process_id = process_id if process_id is not None else pid
        self.num_processes = num_processes if num_processes is not None else pcount
        if global_batch_size % self.num_processes:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by {self.num_processes} processes"
            )
        self.per_host = global_batch_size // self.num_processes
        self.epoch = 0
        # per-epoch cache of the global permutation: recomputing it per item
        # is O(n) work per sample / O(n²) per epoch
        self._order_epoch: Optional[int] = None
        self._order: Optional[np.ndarray] = None
        for attr in ("K", "invK", "target_id", "source_ids"):
            if hasattr(dataset, attr):
                setattr(self, attr, getattr(dataset, attr))
        # probe the rng capability once (data.loader.accepts_rng): a per-item
        # `except TypeError` would mask genuine TypeErrors inside a two-arg
        # __getitem__
        from ..data.loader import accepts_rng

        self._takes_rng = accepts_rng(dataset)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n_global_batches = len(self.dataset) // self.global_batch_size
        return n_global_batches * self.per_host

    def _global_order(self) -> np.ndarray:
        if self._order_epoch != self.epoch:
            order = np.arange(len(self.dataset))
            rng = np.random.default_rng([self.seed, self.epoch])
            rng.shuffle(order)
            # the order is built before the epoch tag is written: loader
            # threads never see a tag with another epoch's order
            self._order = order
            self._order_epoch = self.epoch
        return self._order

    # the sampler derives its own per-item rng (below); DataLoader skips
    # constructing one per item when it sees this flag
    owns_rng = True

    def __getitem__(self, i: int):
        """Local item i -> the matching row of the global shuffled order,
        with an augmentation rng derived from the global index, so that an
        item draws the same augmentations under any process layout."""
        gidx = self._global_index(i)
        if not self._takes_rng:
            return self.dataset[gidx]
        rng = np.random.default_rng([self.seed, self.epoch, gidx])
        return self.dataset.__getitem__(gidx, rng)

    def _global_index(self, i: int) -> int:
        if i < 0 or i >= len(self):
            raise IndexError(i)
        gb, r = divmod(i, self.per_host)
        return int(self._global_order()[gb * self.global_batch_size + self.process_id * self.per_host + r])

    @property
    def supports_item_K(self) -> bool:
        """Forwarded precondition for per_item_K, through
        data.dchain.resolves_item_K, the one probe of how K is resolved."""
        from ..data.dchain import resolves_item_K

        return resolves_item_K(self.dataset)

    def K_of(self, i: int) -> np.ndarray:
        """Per-item intrinsics for local loader index i, by the same global
        order as __getitem__, so {"frames", "K"} batches stay row-aligned."""
        gidx = self._global_index(i)
        if hasattr(self.dataset, "K_of"):
            return np.asarray(self.dataset.K_of(gidx), np.float32)
        return np.asarray(self.dataset.K, np.float32)
