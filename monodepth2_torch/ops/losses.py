"""Photometric / smoothness losses and the differentiable warp, port of
monodepth2_tpu/ops/losses.py (reference: src/training.jl:1-19,
src/utils.jl:159-173).

Shapes as there: images NHWC; frame stacks (N, L, H, W, C); disparity
(N, H, W, 1).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from .geometry import backproject, disparity_to_depth, project
from .grid_sample import grid_sample
from .ssim import ssim


def photometric_loss(predicted: Tensor, target: Tensor, alpha: float = 0.85) -> Tensor:
    """α·SSIM + (1−α)·L1, channel-averaged: NHWC -> (N,H,W,1)."""
    l1 = torch.mean(torch.abs(target - predicted), dim=-1, keepdim=True)
    ssim_term = torch.mean(ssim(predicted, target), dim=-1, keepdim=True)
    return alpha * ssim_term + (1.0 - alpha) * l1


def prediction_loss(predictions: Sequence[Tensor], target: Tensor) -> Tensor:
    """Per-pixel minimum of photometric losses over warped predictions."""
    losses = torch.stack([photometric_loss(p, target) for p in predictions], dim=0)
    return torch.min(losses, dim=0).values


def automasking_loss(frames: Tensor, target: Tensor, source_ids: Sequence[int]) -> Tensor:
    """Identity-reprojection loss: min photometric of the *unwarped* sources.
    frames (N,L,H,W,C), target (N,H,W,C)."""
    losses = torch.stack([photometric_loss(frames[:, i], target) for i in source_ids], dim=0)
    return torch.min(losses, dim=0).values


def apply_automask(auto_loss: Tensor, warp_loss: Tensor) -> Tensor:
    """Pixelwise min with the identity loss."""
    return torch.minimum(auto_loss, warp_loss)


def smooth_loss(disparity: Tensor, image: Tensor) -> Tensor:
    """Edge-aware first-order smoothness: mean(|∇d|·exp(−|∇I|)) per axis.
    disparity (N,H,W), image (N,H,W,C)."""
    dd_x = torch.abs(disparity[:, :, :-1] - disparity[:, :, 1:])
    dd_y = torch.abs(disparity[:, :-1, :] - disparity[:, 1:, :])
    di_x = torch.mean(torch.abs(image[:, :, :-1, :] - image[:, :, 1:, :]), dim=-1)
    di_y = torch.mean(torch.abs(image[:, :-1, :, :] - image[:, 1:, :, :]), dim=-1)
    return torch.mean(dd_x * torch.exp(-di_x)) + torch.mean(dd_y * torch.exp(-di_y))


def warp_images(
    disparity: Tensor,
    frames: Tensor,
    poses: Sequence[Tuple[Tensor, Tensor]],
    K: Tensor,
    invK: Tensor,
    grid: Tensor,
    source_ids: Sequence[int],
    min_depth: float,
    max_depth: float,
    method: Optional[str] = None,
) -> list:
    """Warp each source frame into the target view through predicted depth.

    disparity (N,H,W,1), frames (N,L,H,W,C), poses[i] = (R (N,3,3),
    t (N,3,1)) target→source_i, grid (H*W,3). Returns [(N,H,W,C)] per source.
    """
    n, h, w, _ = disparity.shape
    depth = disparity_to_depth(disparity, min_depth, max_depth)
    points = backproject(depth.reshape(n, h * w), invK, grid)
    warped = []
    for (R, t), sid in zip(poses, source_ids):
        uv = project(points, K, R, t, w, h)
        sampled = grid_sample(frames[:, sid], uv, method=method)
        warped.append(sampled.reshape(n, h, w, frames.shape[-1]))
    return warped
