"""Plain float32 reference of one training step: the multi-scale
self-supervised loss and Adam.

The loss follows Monodepth2 (arXiv:1806.01260, §3) in the form the program
trains: each scale's sigmoid disparity upsampled (bilinear, align_corners)
to full resolution and mapped to depth in [min_depth, max_depth]; pixels
backprojected through K⁻¹, moved by the target→source pose (the Rodrigues
rotation of rvec; for a source before the target the inverse transform)
and projected through K to coordinates normalised to (-1, 1); each source
sampled bilinearly there with the coordinates clamped to the border; the
per-pixel minimum over the sources of 0.85·SSIM-distance (3×3 mean pools
over a reflect pad of 1, c1 = 0.01², c2 = 0.03²) + 0.15·L1; plus the
edge-aware smoothness of the mean-normalised disparity times
`disparity_smoothness` and 1/2^(5-level), averaged over the scales; plus
`disp_reg(step)` times the mean squared logit of the disparity. Every
term is a mean over the rows of the batch of that row's own term, so the
loss is the mean of per-row losses (`row_losses`), which BatchNorm couples
only through the forward. Adam with β = (0.9, 0.999) and ε = 1e-8 added
outside the square root.

The grid sample is a gather of the four taps; its gradient with respect to
the coordinates is autograd's. Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


def rodrigues(rvec: Tensor, eps: float = 1e-4) -> Tensor:
    sq = (rvec * rvec).sum(-1, keepdim=True)
    pos = sq > 0
    theta = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))) * pos
    rx, ry, rz = rvec.unbind(-1)
    z = torch.zeros_like(rx)
    k = torch.stack([torch.stack([z, -rz, ry], -1), torch.stack([rz, z, -rx], -1), torch.stack([-ry, rx, z], -1)], -2)
    inv = 1.0 / theta.clamp(min=eps)
    a = (inv * torch.sin(theta))[..., None]
    b = (inv * inv * (1.0 - torch.cos(theta)))[..., None]
    return a * k + b * (k @ k) + torch.eye(3, dtype=rvec.dtype, device=rvec.device)


def sample_border(image: Tensor, uv: Tensor) -> Tensor:
    """Bilinear sample of image (N, H, W, C) at uv (N, P, 2) in (-1, 1)
    (align_corners), coordinates clamped to the border -> (N, P, C)."""
    n, h, w, c = image.shape
    u = ((uv[..., 0] + 1) * 0.5 * (w - 1)).clamp(0, w - 1)
    v = ((uv[..., 1] + 1) * 0.5 * (h - 1)).clamp(0, h - 1)
    x0, y0 = u.floor(), v.floor()
    wx, wy = (u - x0)[..., None], (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    flat = image.reshape(n, h * w, c)

    def tap(y, x):
        return torch.gather(flat, 1, (y * w + x)[..., None].expand(-1, -1, c))

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bottom = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return top * (1 - wy) + bottom * wy


def ssim_distance(x: Tensor, y: Tensor) -> Tensor:
    """(1 - SSIM) / 2 clamped to [0, 1], per pixel, of NCHW images."""
    x, y = F.pad(x, (1, 1, 1, 1), mode="reflect"), F.pad(y, (1, 1, 1, 1), mode="reflect")
    mx, my = F.avg_pool2d(x, 3, 1), F.avg_pool2d(y, 3, 1)
    sx = F.avg_pool2d(x * x, 3, 1) - mx * mx
    sy = F.avg_pool2d(y * y, 3, 1) - my * my
    sxy = F.avg_pool2d(x * y, 3, 1) - mx * my
    c1, c2 = 0.01**2, 0.03**2
    s = (2 * mx * my + c1) * (2 * sxy + c2) / ((mx * mx + my * my + c1) * (sx + sy + c2))
    return ((1 - s) * 0.5).clamp(0, 1)


def disp_reg_weight(cfg: dict, step: int) -> float:
    if not (cfg["disp_reg"] > 0 and cfg["disp_reg_steps"] > 0):
        return 0.0
    return cfg["disp_reg"] * min(max(1.0 - step / cfg["disp_reg_steps"], 0.0), 1.0)


def learning_rate(cfg: dict, step: int) -> float:
    lr = cfg["lr"]
    if cfg.get("lr_warmup_steps", 0) > 0:
        lr *= min(step / cfg["lr_warmup_steps"], 1.0)
    if cfg.get("lr_decay_steps", 0) > 0 and step >= cfg["lr_decay_steps"]:
        lr *= cfg["lr_decay_factor"]
    return lr


def loss(model, frames: Tensor, K: Tensor, cfg: dict, step: int, seen: dict | None = None) -> Tensor:
    """The training loss of frames (N, 3, H, W, C), target frame 1, with
    intrinsics K (3, 3), at update number `step` (0-based); `seen` gets the
    finest disparity (N, H, W, 1) and its mean."""
    return row_losses(model, frames, K, cfg, step, seen).mean()


def row_losses(model, frames: Tensor, K: Tensor, cfg: dict, step: int, seen: dict | None = None) -> Tensor:
    """Each row's term of `loss`, (N,)."""
    n, _, h, w, c = frames.shape
    disps, poses = model(frames)
    full = [d if d.shape[1:3] == (h, w) else
            F.interpolate(d.permute(0, 3, 1, 2), size=(h, w), mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
            for d in disps]
    target = frames[:, 1]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=K.dtype, device=K.device),
                            torch.arange(w, dtype=K.dtype, device=K.device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(h * w, 3)
    rays = pix @ torch.linalg.inv(K.double()).to(K.dtype).T
    lo, hi = 1.0 / cfg["max_depth"], 1.0 / cfg["min_depth"]
    levels = cfg["scale_levels"]
    di_x = torch.exp(-(target[:, :, :-1] - target[:, :, 1:]).abs().mean(-1))
    di_y = torch.exp(-(target[:, :-1] - target[:, 1:]).abs().mean(-1))
    total = 0.0
    for level, d in zip(levels, full):
        depth = 1.0 / (d * (hi - lo) + lo)
        points = depth.reshape(n, h * w, 1) * rays
        photo = []
        for (rvec, tvec), src in zip(poses, (0, 2)):
            R = rodrigues(rvec)
            if src < 1:
                R = R.transpose(-1, -2)
                t = R @ (-tvec)
            else:
                t = tvec
            cam = (points @ R.transpose(-1, -2) + t.transpose(-1, -2)) @ K.T
            uv = cam[..., :2] / (cam[..., 2:3] + 1e-7)
            uv = torch.stack([uv[..., 0] / (w - 1.0), uv[..., 1] / (h - 1.0)], -1) * 2 - 1
            warped = sample_border(frames[:, src], uv).reshape(n, h, w, c)
            ssim = ssim_distance(warped.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            photo.append(0.85 * ssim.mean(-1) + 0.15 * (target - warped).abs().mean(-1))
        warp = torch.minimum(photo[0], photo[1]).mean(dim=(1, 2))
        nd = (d / (d.mean(dim=(1, 2), keepdim=True) + 1e-7))[..., 0]
        smooth = (((nd[:, :, :-1] - nd[:, :, 1:]).abs() * di_x).mean(dim=(1, 2))
                  + ((nd[:, :-1] - nd[:, 1:]).abs() * di_y).mean(dim=(1, 2)))
        total = total + warp + smooth * cfg["disparity_smoothness"] / 2.0 ** (5 - level)
    total = total / len(levels)
    if seen is not None:
        seen["disparity"] = full[-1].detach()
        seen["mean_disparity"] = float(seen["disparity"].mean())
    reg = disp_reg_weight(cfg, step)
    if reg:
        stack = torch.stack(full).clamp(1e-6, 1 - 1e-6)
        logit = torch.log(stack) - torch.log1p(-stack)
        total = total + reg * (logit * logit).mean(dim=(0, 2, 3, 4))
    return total


class Adam:
    """Adam over a list of parameters, float32, ε outside the square root;
    its moments and update count may start from a given state."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, m=None, v=None, t: int = 0):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params] if m is None else [x.clone() for x in m]
        self.v = [torch.zeros_like(p) for p in self.params] if v is None else [x.clone() for x in v]
        self.t = t

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def group_gradients(params: list, rows: Tensor, groups: int) -> list:
    """The gradient of each of `groups` equal runs of consecutive rows'
    mean loss, one list of leaves each (the loss's gradient is their
    mean)."""
    out = []
    for k, part in enumerate(rows.chunk(groups)):
        grads = torch.autograd.grad(part.mean(), params, retain_graph=k < groups - 1, allow_unused=True)
        out.append([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])
    return out


def follow(model, batches, K: Tensor, cfg: dict, first: int, last: int, adam: Adam, record=None) -> tuple:
    """Train `model` in place over updates first+1 … last (1-based) on
    batches[first … last-1], with `adam` over its parameters. Returns the
    losses and the finest disparity's means; `record(i, model, adam, seen)`
    is called after update i with what `loss` saw."""
    model.train()
    losses, means = [], []
    for i in range(first, last):
        for p in adam.params:
            p.grad = None
        seen = {}
        value = loss(model, batches[i], K, cfg, i, seen)
        value.backward()
        adam.step(learning_rate(cfg, i))
        losses.append(float(value.detach()))
        means.append(seen["mean_disparity"])
        if record is not None:
            record(i + 1, model, adam, seen)
    return losses, means


def tf32_off() -> None:
    """Keep float32 matrix products and convolutions in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
