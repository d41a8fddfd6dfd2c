"""SSIM-as-distance, port of monodepth2_tpu/ops/ssim.py (reference:
src/utils.jl:13-39): reflect-pad 1, 3×3 stride-1 mean pooling for the local
moments, c1 = 0.01², c2 = 0.03²; clamp((1 − ssim)/2, 0, 1)."""

from __future__ import annotations

from torch import Tensor

from ..nn.core import mean_pool, reflect_pad


def ssim(x: Tensor, y: Tensor, c1: float = 0.01**2, c2: float = 0.03**2) -> Tensor:
    """Per-pixel SSIM distance of NHWC images; same shape out as in
    (0 = identical)."""
    xp = reflect_pad(x.permute(0, 3, 1, 2), 1)
    yp = reflect_pad(y.permute(0, 3, 1, 2), 1)
    mu_x = mean_pool(xp)
    mu_y = mean_pool(yp)

    sigma_x = mean_pool(xp * xp) - mu_x * mu_x
    sigma_y = mean_pool(yp * yp) - mu_y * mu_y
    sigma_xy = mean_pool(xp * yp) - mu_x * mu_y

    ssim_n = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    out = ((1.0 - ssim_n / ssim_d) * 0.5).clamp(0.0, 1.0)
    return out.permute(0, 2, 3, 1)
