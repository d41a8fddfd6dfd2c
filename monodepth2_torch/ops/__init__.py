"""Differentiable geometry + loss core and the grid-sample op, port of
monodepth2_tpu/ops. The hand-written CUDA kernels live in ops/cuda/."""

from .geometry import (
    backproject,
    compose_transform,
    disparity_to_depth,
    hat,
    invert_intrinsics,
    pixel_grid,
    project,
    safe_sqrt,
    so3_exp_map,
)
from .grid_sample import grid_sample
from .losses import (
    apply_automask,
    automasking_loss,
    photometric_loss,
    prediction_loss,
    smooth_loss,
    warp_images,
)
from .ssim import ssim

__all__ = [
    "hat",
    "so3_exp_map",
    "compose_transform",
    "pixel_grid",
    "backproject",
    "project",
    "disparity_to_depth",
    "invert_intrinsics",
    "safe_sqrt",
    "ssim",
    "grid_sample",
    "photometric_loss",
    "automasking_loss",
    "prediction_loss",
    "apply_automask",
    "smooth_loss",
    "warp_images",
]
