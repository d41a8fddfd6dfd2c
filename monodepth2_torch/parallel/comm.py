"""The collectives of a data-parallel step: sums over the ranks of the
default process group, counted where they are issued.

`all_reduce` is differentiable: the backward of a sum over the ranks is the
sum over the ranks of the gradients, so a BatchNorm that takes its moments
through it couples the ranks' backward passes as GSPMD's global-batch
moments do. `all_reduce_` sums in place, outside autograd (the gradients,
the running statistics, the metrics).

COUNTS["calls"] counts every collective issued through this module (a
backward's included), COUNTS["captured"] those issued while the current CUDA
stream was capturing a graph: each of those runs again in every replay,
which runs no Python and so issues nothing that a counter could see.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor

COUNTS = {"calls": 0, "captured": 0}


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def all_reduce_(t: Tensor) -> Tensor:
    """Sum `t` over the ranks in place; returns it."""
    COUNTS["calls"] += 1
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        COUNTS["captured"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: Tensor) -> Tensor:
        return all_reduce_(t.detach().clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: Tensor) -> Tensor:
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format))


def all_reduce(t: Tensor) -> Tensor:
    """The sum of `t` over the ranks, differentiable."""
    return _AllReduce.apply(t)
