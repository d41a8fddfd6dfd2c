"""so(3)/SE(3) and pinhole-camera geometry in PyTorch.

Port of monodepth2_tpu/ops/geometry.py (reference semantics: src/utils.jl).
Shapes are batch-leading as there: rvec (N,3), R (N,3,3), points (N,HW,3),
uv (N,HW,2); the pixel grid is 0-indexed and row-major.
"""

from __future__ import annotations

import torch
from torch import Tensor


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        pos = x > 0
        return torch.where(pos, 0.5 / torch.where(pos, y, torch.ones_like(y)), 0.0) * g


def safe_sqrt(x: Tensor) -> Tensor:
    """sqrt with a zero subgradient at 0 (monodepth2_tpu geometry.py:27-42);
    torch.sqrt's gradient there is inf, which turns into NaN."""
    return _SafeSqrt.apply(x)


def hat(rvec: Tensor) -> Tensor:
    """Skew-symmetric matrices of rotation vectors: (N,3) -> (N,3,3);
    hat(v) @ p == v × p."""
    rx, ry, rz = rvec.unbind(-1)
    zero = torch.zeros_like(rx)
    return torch.stack(
        [
            torch.stack([zero, -rz, ry], dim=-1),
            torch.stack([rz, zero, -rx], dim=-1),
            torch.stack([-ry, rx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_map(rvec: Tensor, eps: float = 1e-4) -> Tensor:
    """Rodrigues exponential map: (N,3) axis-angle -> (N,3,3) rotation, with
    θ clamped at `eps` for the division (geometry.py:63-78)."""
    n = rvec.shape[0]
    skew = hat(rvec)
    skew2 = skew @ skew
    theta = safe_sqrt(torch.sum(rvec * rvec, dim=-1, keepdim=True))  # (N,1)
    theta_inv = 1.0 / torch.clamp(theta, min=eps)
    f1 = (theta_inv * torch.sin(theta)).reshape(n, 1, 1)
    f2 = (theta_inv * theta_inv * (1.0 - torch.cos(theta))).reshape(n, 1, 1)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return f1 * skew + f2 * skew2 + eye


def compose_transform(rvec: Tensor, tvec: Tensor, invert: bool):
    """rvec (N,3), tvec (N,3,1) -> (R, t); invert=True gives (Rᵀ, Rᵀ(−t))."""
    R = so3_exp_map(rvec)
    if invert:
        R = R.transpose(-1, -2)
        t = R @ (-tvec)
    else:
        t = tvec
    return R, t


def pixel_grid(
    width: int, height: int, dtype=torch.float32, device: str | torch.device = "cpu"
) -> Tensor:
    """Homogeneous pixel coordinates, (H*W, 3), row-major (idx = h*W + w)."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")  # (H,W)
    return torch.stack([xg, yg, torch.ones_like(xg)], dim=-1).reshape(height * width, 3)


def invert_intrinsics(K: Tensor) -> Tensor:
    """Exact 3x3 inverse via the adjugate: (...,3,3) -> (...,3,3)."""
    a, b, c = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    d, e, f = K[..., 1, 0], K[..., 1, 1], K[..., 1, 2]
    g, h, i = K[..., 2, 0], K[..., 2, 1], K[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    cof = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return cof / det[..., None, None]


def backproject(depth: Tensor, invK: Tensor, grid: Tensor) -> Tensor:
    """depth (N,HW) or (N,HW,1), invK (3,3) shared or (N,3,3) per item,
    grid (HW,3) -> points (N,HW,3)."""
    if depth.dim() == 2:
        depth = depth[..., None]
    rays = grid @ invK.transpose(-1, -2).to(grid.dtype)
    if rays.dim() == 2:
        rays = rays[None]
    return depth * rays


def project(
    points: Tensor,
    K: Tensor,
    R: Tensor,
    t: Tensor,
    width: int,
    height: int,
    eps: float = 1e-7,
) -> Tensor:
    """points (N,HW,3), K (3,3) shared or (N,3,3), R (N,3,3), t (N,3,1)
    -> uv (N,HW,2) normalized to (-1,1): cam = K (R p + t),
    uv = cam.xy / (cam.z + eps), u/(W-1)*2-1."""
    dtype = points.dtype
    cam = (points @ R.transpose(-1, -2) + t.transpose(-1, -2)) @ K.transpose(-1, -2).to(dtype)
    denom = 1.0 / (cam[..., 2:3] + eps)
    uv = cam[..., :2] * denom
    norm = torch.tensor([width - 1.0, height - 1.0], dtype=dtype, device=points.device)
    return (uv / norm) * 2.0 - 1.0


def disparity_to_depth(disparity: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Sigmoid disparity in (0,1) -> depth in [min_depth, max_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (disparity * (max_disp - min_disp) + min_disp)
