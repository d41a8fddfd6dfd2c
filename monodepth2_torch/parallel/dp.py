"""Data-parallel train steps over a mesh, port of
monodepth2_tpu/parallel/dp.py.

Each rank holds the whole train state and runs the step on its own rows of
the global batch; the steps differ in what they reduce over the ranks, as
the JAX package's two paths do:

* GSPMD semantics (`make_parallel_train_step`, the default): the JAX step
  jitted with the state replicated and the batch sharded computes the
  single-device step on the global batch. So here every training-mode
  BatchNorm takes the global batch's moments (nn.core.global_batch_stats:
  count, sum and sum of squared deviations summed over the ranks through a
  differentiable all-reduce, whose backward couples the ranks' backward
  passes), the running statistics are updated from the global moments and
  the global count, each rank backprops its own mean loss, the gradients
  are averaged over the ranks in one all-reduce after the backward, and the
  loss and mean disparity are reported as global means.
* shard_map semantics (`make_shardmap_train_step`): the per-device step with
  `lax.pmean` of the gradients, the new running statistics and the loss
  (monodepth2_tpu/training/state.py:124-127). BatchNorm uses each rank's own
  moments; the gradients, running statistics and loss are averaged after
  the backward. The mean disparity stays each rank's own, as JAX's
  unreduced metric does.

Both then clip and take the Adam step identically on every rank. No
DistributedDataParallel: its per-rank BatchNorm, its broadcast of rank 0's
buffers and its gradient hooks match neither semantics.

The scanned step (`make_parallel_scanned_train_step`) replays one captured
CUDA graph per micro-step as the single-card one does; over NCCL the
collectives are captured inside the graph (the eager warm-up steps create
NCCL's communicator before the capture). Gloo's collectives cannot be
captured: over gloo, CUDA tensors included, the micro-steps run eagerly.

A step takes this rank's rows (`shard_batch` of the global batch, or
`distributed.shard_host_batch` of a process's own rows); cfg.batch_size is
the global batch and must divide by the mesh's size.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import Tensor

from ..nn.core import BatchNorm, global_batch_stats
from ..training.config import TrainConfig, TrainContext
from ..training.state import make_scanned_train_step, make_train_step
from . import comm
from .distributed import _to_device
from .mesh import Mesh


def _check(cfg: TrainConfig, mesh: Mesh, axis: str) -> None:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    if cfg.batch_size % mesh.size != 0:
        raise ValueError(f"global batch {cfg.batch_size} not divisible by mesh size {mesh.size}")


def _rows(x, rank: int, size: int, axis: int):
    n = x.shape[axis]
    if n % size:
        raise ValueError(f"global batch {n} not divisible by mesh size {size}")
    per = n // size
    index = [slice(None)] * (axis + 1)
    index[axis] = slice(rank * per, (rank + 1) * per)
    return x[tuple(index)]


def shard_batch(batch, mesh: Mesh, axis: str = "data", stacked: bool = False):
    """This rank's rows of a global host batch (an array, a tensor or a
    {"frames","K"} dict of them), on its device. stacked=True for
    (K, N, ...) steps_per_call stacks: every rank takes all K micro-batches
    of its rows of N."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    take = lambda x: _rows(x, mesh.rank, mesh.size, 1 if stacked else 0)
    if isinstance(batch, dict):
        return _to_device({k: take(v) for k, v in batch.items()}, mesh.device)
    return _to_device(take(batch), mesh.device)


class DataParallel:
    """What a data-parallel step reduces over the mesh's ranks, by
    semantics: "gspmd" or "shardmap" (see the module docstring). The train
    step (training/state.py `_update`) calls `batch_stats(model)` around the
    forward and backward, `after_backward` before the clip, and
    `reduce_metrics` on the reported loss and mean disparity."""

    def __init__(self, mesh: Mesh, semantics: str):
        if semantics not in ("gspmd", "shardmap"):
            raise ValueError(f"unknown data-parallel semantics {semantics!r}")
        self.mesh, self.semantics = mesh, semantics
        self.capturable = mesh.capturable

    def batch_stats(self, model: torch.nn.Module):
        """Inside: `model`'s BatchNorm over the global batch (GSPMD), or as
        it is."""
        if self.semantics == "gspmd":
            return global_batch_stats(model, comm.all_reduce)
        return contextlib.nullcontext()

    def _mean_(self, tensors) -> None:
        """Average the tensors over the ranks in place, in one all-reduce of
        their concatenation."""
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        comm.all_reduce_(flat).div_(self.mesh.size)
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)])

    @torch.no_grad()
    def after_backward(self, model: torch.nn.Module) -> None:
        """The gradients averaged over the ranks; under shard_map semantics
        the running statistics too (each rank updated its own)."""
        self._mean_(p.grad for p in model.parameters() if p.grad is not None)
        if self.semantics == "shardmap":
            self._mean_(
                t for m in model.modules() if isinstance(m, BatchNorm) for t in (m.running_mean, m.running_var)
            )

    @torch.no_grad()
    def reduce_metrics(self, loss: Tensor, mean_disparity: Tensor):
        """The loss as the global mean, and the mean disparity too under
        GSPMD semantics (shard_map's stays this rank's)."""
        if self.semantics == "gspmd":
            both = torch.stack([loss, mean_disparity])
            comm.all_reduce_(both).div_(self.mesh.size)
            return both[0], both[1]
        loss = comm.all_reduce_(loss.clone()).div_(self.mesh.size)
        return loss, mean_disparity


def make_parallel_train_step(ctx: TrainContext, cfg: TrainConfig, mesh: Mesh, axis: str = "data") -> Callable:
    """GSPMD-semantics data-parallel step: step_fn(state, batch) -> (state,
    metrics, aux), batch being this rank's rows; cfg.batch_size is the
    global batch and must divide by the mesh's size."""
    _check(cfg, mesh, axis)
    return make_train_step(ctx, cfg, dp=DataParallel(mesh, "gspmd"))


def make_parallel_scanned_train_step(
    ctx: TrainContext, cfg: TrainConfig, mesh: Mesh, axis: str = "data"
) -> Callable:
    """The steps_per_call variant of make_parallel_train_step: this rank's
    rows stacked (K, N_local, ...), one captured CUDA graph replayed a
    micro-step over NCCL, eager micro-steps over gloo."""
    _check(cfg, mesh, axis)
    return make_scanned_train_step(ctx, cfg, dp=DataParallel(mesh, "gspmd"))


def make_shardmap_train_step(ctx: TrainContext, cfg: TrainConfig, mesh: Mesh, axis: str = "data") -> Callable:
    """shard_map-semantics data-parallel step: per-rank BatchNorm, then the
    mean over the ranks of the gradients, the running statistics and the
    loss."""
    _check(cfg, mesh, axis)
    return make_train_step(ctx, cfg, dp=DataParallel(mesh, "shardmap"))

