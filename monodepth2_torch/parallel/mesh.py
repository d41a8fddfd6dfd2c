"""The data-parallel mesh, port of monodepth2_tpu/parallel/mesh.py.

A JAX mesh is an array of devices that one process may drive all of; in
PyTorch one process drives one card, so the port's 1-D "data" mesh is the
process group's ranks, one card each, and JAX's 1×8 mesh becomes 8
processes. The mesh names the group, this process's rank and its device;
the steps of parallel.dp issue their collectives over it. With no group
initialized, make_mesh sets up a group of one, so a single-process mesh
runs every collective of the data-parallel paths, as JAX's one-device mesh
runs its sharded programs.

JAX's `batch_sharding` and `replicated_sharding` have no counterpart: a
rank holds the replicated state and its own rows as plain tensors, and
there is no sharding object to return.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device
from .distributed import initialize_single_process


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of the default process group, one device a
    rank."""

    size: int
    rank: int
    device: torch.device
    backend: str
    axis_names: tuple = ("data",)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives: NCCL's
        can, gloo's cannot."""
        return self.backend == "nccl" and self.device.type == "cuda"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    device: str | torch.device = "cuda",
) -> Mesh:
    """1-D mesh over the default process group's ranks, one card each;
    this process's rank runs on `device` (on the card, the one
    initialize_distributed bound).

    n_devices, when given, must equal the group's world size. Without a
    group, a group of one is set up on `device` (NCCL on the card, gloo on
    the CPU), so make_mesh() alone gives the single-process mesh.
    """
    if len(axis_names) != 1:
        raise NotImplementedError("only 1-D meshes are built here for now")
    device = resolve_device(device)
    if not dist.is_initialized():
        initialize_single_process(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes (one card each); the process group "
            f"has {world}"
        )
    return Mesh(size=world, rank=dist.get_rank(), device=device, backend=dist.get_backend(),
                axis_names=tuple(axis_names))
