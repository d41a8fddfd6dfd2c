"""so(3)/SE(3) and pinhole-camera geometry in PyTorch.

Port of monodepth2_tpu/ops/geometry.py (reference semantics: src/utils.jl).
Shapes are batch-leading as there: rvec (N,3), R (N,3,3), points (N,HW,3),
uv (N,HW,2); the pixel grid is 0-indexed and row-major.

`project` runs on the card through two hand-written CUDA kernels
(ops/cuda/project.cu) behind an autograd Function, each behind a wrapper
that counts its launches, with its plain PyTorch version beside it:

  project_fwd   uv from points, K, R, t        (plain: project_plain)
  project_bwd   d_points, dR, dt from g        (plain: project_bwd_plain)

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import Tensor

from ._kernel import Kernel
from .cuda import _lib


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


def project_plain(
    points: Tensor,
    K: Tensor,
    R: Tensor,
    t: Tensor,
    width: int,
    height: int,
    eps: float = 1e-7,
) -> Tensor:
    """The plain version of `project`, differentiable by autograd in every
    argument, K included: ATen and cuBLAS on the card."""
    dtype = points.dtype
    cam = (points @ R.transpose(-1, -2) + t.transpose(-1, -2)) @ K.transpose(-1, -2).to(dtype)
    denom = 1.0 / (cam[..., 2:3] + eps)
    uv = cam[..., :2] * denom
    # each coordinate over its own Python scalar: a tensor built from a list
    # is a copy from pageable host memory, which a CUDA graph cannot capture
    uv = torch.stack((uv[..., 0] / (width - 1.0), uv[..., 1] / (height - 1.0)), dim=-1)
    return uv * 2.0 - 1.0


def project_bwd_plain(
    points: Tensor,
    K: Tensor,
    R: Tensor,
    t: Tensor,
    g: Tensor,
    width: int,
    height: int,
    eps: float = 1e-7,
):
    """The VJP of `project_plain` with respect to points, R and t, written
    out as the kernel computes it: g (N,HW,2) -> (d_points (N,HW,3),
    dR (N,3,3), dt (N,3,1)). Recomputes q = R p + t and c = K q."""
    K = K.to(points.dtype)
    cam = (points @ R.transpose(-1, -2) + t.transpose(-1, -2)) @ K.transpose(-1, -2)
    denom = 1.0 / (cam[..., 2:3] + eps)
    g = g * 2.0
    g_uv = torch.stack((g[..., 0] / (width - 1.0), g[..., 1] / (height - 1.0)), dim=-1)
    g_denom = torch.sum(g_uv * cam[..., :2], dim=-1, keepdim=True)
    g_cam = torch.cat((g_uv * denom, -g_denom * (denom * denom)), dim=-1)
    g_q = g_cam @ K
    return g_q @ R, g_q.transpose(-1, -2) @ points, torch.sum(g_q, dim=-2)[..., None]


def _check_project(name: str, points: Tensor, K: Tensor, R: Tensor, t: Tensor, *others: Tensor):
    """Refuse what the kernels do not take; -> (N, HW, K's stride)."""
    for x in (points, K, R, t, *others):
        if x.device != points.device:
            raise ValueError(f"{name}: all tensors must be on {points.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"{name}: points must be (N,HW,3), got {tuple(points.shape)}")
    n, hw = points.shape[:2]
    if R.shape != (n, 3, 3) or t.shape != (n, 3, 1):
        raise ValueError(f"{name}: R and t must be ({n},3,3) and ({n},3,1), got {tuple(R.shape)}, {tuple(t.shape)}")
    if K.shape not in ((3, 3), (n, 3, 3)):
        raise ValueError(f"{name}: K must be (3,3) or ({n},3,3), got {tuple(K.shape)}")
    if n * hw * 3 >= 2**31:
        raise ValueError(f"{name}: sizes exceed the kernel's int32 arguments")
    return n, hw, 0 if K.dim() == 2 else 9


class ProjectFwd(Kernel):
    """project_fwd's wrapper: points (N,HW,3), K (3,3) or (N,3,3), R
    (N,3,3), t (N,3,1) -> uv (N,HW,2)."""

    name = "project_fwd"
    source = _lib.PROJECT_SOURCE

    def __call__(self, points, K, R, t, width: int, height: int, eps: float = 1e-7) -> Tensor:
        if not points.is_cuda:
            return project_plain(points, K, R, t, width, height, eps)
        n, hw, k_stride = _check_project(self.name, points, K, R, t)
        uv = torch.empty((n, hw, 2), dtype=torch.float32, device=points.device)
        if uv.numel():
            self._launch(self.name, points, K, R, t, uv, n, hw, k_stride, width, height, eps)
        return uv


class ProjectBwd(Kernel):
    """project_bwd's wrapper: project's inputs and the cotangent g (N,HW,2)
    -> (d_points, dR, dt). One launch enqueues the pass over the points and
    the sum of its per-block partials (two kernels)."""

    name = "project_bwd"
    source = _lib.PROJECT_SOURCE

    def __call__(self, points, K, R, t, g, width: int, height: int, eps: float = 1e-7):
        if not points.is_cuda:
            return project_bwd_plain(points, K, R, t, g, width, height, eps)
        n, hw, k_stride = _check_project(self.name, points, K, R, t, g)
        if g.shape != (n, hw, 2):
            raise ValueError(f"{self.name}: g must be {(n, hw, 2)}, got {tuple(g.shape)}")
        blocks = self.lib().project_bwd_blocks(hw)
        new = functools.partial(torch.empty, dtype=torch.float32, device=points.device)
        d_points, partial, dR, dt = new((n, hw, 3)), new((n, blocks, 12)), new((n, 3, 3)), new((n, 3, 1))
        if n:
            self._launch(self.name, points, K, R, t, g, d_points, partial, dR, dt, n, hw, k_stride,
                         width, height, eps)
        return d_points, dR, dt


project_fwd = ProjectFwd()
project_bwd = ProjectBwd()
KERNELS = (project_fwd, project_bwd)


class _Project(torch.autograd.Function):
    """`project` through the kernels (their plain versions on the CPU):
    saves only its inputs and computes no gradient for K."""

    @staticmethod
    def forward(ctx, points, K, R, t, width, height, eps):
        if ctx.needs_input_grad[1]:
            raise ValueError("project: the kernels compute no gradient with respect to K")
        points, K, R, t = (x.contiguous() for x in (points, K.to(points.dtype), R, t))
        ctx.save_for_backward(points, K, R, t)
        ctx.size = (width, height, eps)
        return project_fwd(points, K, R, t, width, height, eps)

    @staticmethod
    def backward(ctx, g):
        points, K, R, t = ctx.saved_tensors
        d_points, dR, dt = project_bwd(points, K, R, t, g.contiguous(), *ctx.size)
        need = ctx.needs_input_grad
        return (d_points if need[0] else None, None, dR if need[2] else None,
                dt if need[3] else None, None, None, None)


def project(
    points: Tensor,
    K: Tensor,
    R: Tensor,
    t: Tensor,
    width: int,
    height: int,
    eps: float = 1e-7,
    method: Optional[str] = None,
) -> Tensor:
    """points (N,HW,3), K (3,3) shared or (N,3,3), R (N,3,3), t (N,3,1)
    -> uv (N,HW,2) normalized to (-1,1): cam = K (R p + t),
    uv = cam.xy / (cam.z + eps), u/(W-1)*2-1.

    On CUDA tensors the hand-written kernels (ops/cuda/project.cu) carry it,
    forward and backward, in float32 only and with no gradient for K; on CPU
    tensors it is `project_plain`. method: as grid_sample's; "gather" is
    `project_plain` on any device (float64 on the card, a gradient for K)."""
    if points.is_cuda and method != "gather":
        return _Project.apply(points, K, R, t, width, height, eps)
    return project_plain(points, K, R, t, width, height, eps)


def disparity_to_depth(disparity: Tensor, min_depth: float, max_depth: float) -> Tensor:
    """Sigmoid disparity in (0,1) -> depth in [min_depth, max_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return 1.0 / (disparity * (max_disp - min_disp) + min_disp)
