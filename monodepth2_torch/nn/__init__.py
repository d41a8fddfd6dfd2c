"""Layers, port of monodepth2_tpu/nn (NCHW inside; see core.py)."""

from .core import (
    BatchNorm,
    Conv,
    max_pool,
    mean_pool,
    reflect_pad,
    reset_parameters,
    upsample_bilinear,
)

__all__ = [
    "Conv",
    "BatchNorm",
    "max_pool",
    "mean_pool",
    "upsample_bilinear",
    "reflect_pad",
    "reset_parameters",
]
