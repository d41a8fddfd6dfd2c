"""Multi-scale self-supervised training loss, port of
monodepth2_tpu/training/loss.py (reference: src/training.jl:21-78).

Per scale: bilinear-upsample disparity to full resolution → depth →
backproject → SE(3) transform + project → border grid-sample warp of each
source frame → SSIM+L1 min-reprojection loss (optionally automasked) +
mean-normalized edge-aware smoothness × weight × scale; averaged over scales.
All scales and sources warp in ONE grid-sample call over Src·S·N images.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from ..nn.core import upsample_bilinear
from ..ops.geometry import (
    backproject,
    compose_transform,
    disparity_to_depth,
    invert_intrinsics,
    project,
)
from ..ops.grid_sample import grid_sample
from ..ops.losses import photometric_loss
from .config import TrainConfig, TrainContext


def train_loss(
    model,
    frames: Tensor,
    ctx: TrainContext,
    cfg: TrainConfig,
    auto_loss: Optional[Tensor] = None,
    train: bool = True,
    disp_reg_weight: Optional[Tensor] = None,
    Ks: Optional[Tensor] = None,
):
    """frames (N,L,H,W,C) -> (loss, aux dict).

    The model runs in training mode when `train` is set, and its forward then
    updates the BN running statistics in place (the JAX package returns them
    as aux["stats"]). aux carries the finest-scale disparity, the warped
    sources, the per-pixel warp loss and the poses. Ks (N,3,3), optional:
    per-item camera intrinsics in place of ctx.K.
    """
    model.train(train)
    target = frames[:, cfg.target_id]

    if cfg.compute_dtype == "bfloat16":
        # network in bf16, geometry and loss in fp32 (loss.py:69-85); the
        # master params stay fp32
        with torch.autocast(device_type=frames.device.type, dtype=torch.bfloat16):
            disparities, poses = model(frames, cfg.source_ids, cfg.target_id)
        disparities = [d.float() for d in disparities]
        poses = [(r.float(), t.float()) for r, t in poses]
    else:
        disparities, poses = model(frames, cfg.source_ids, cfg.target_id)

    # target→source rigid transforms; sources before the target use the
    # inverted transform (reference src/training.jl:29-32)
    transforms = [
        compose_transform(rvec, tvec, invert=sid < cfg.target_id)
        for (rvec, tvec), sid in zip(poses, cfg.source_ids)
    ]

    width, height = cfg.target_size
    dtype = frames.dtype
    aux = {"poses": poses}

    n, _, h, w, c = frames.shape
    S = len(cfg.scales)
    Src = len(cfg.source_ids)
    hw = h * w

    # every scale upsampled to full resolution, stacked: (S, N, H, W, 1)
    disps_full = torch.stack(
        [
            d if d.shape[1] == height and d.shape[2] == width
            else upsample_bilinear(d.permute(0, 3, 1, 2), size=(height, width)).permute(0, 2, 3, 1)
            for d in disparities
        ],
        dim=0,
    )

    depth = disparity_to_depth(disps_full, cfg.min_depth, cfg.max_depth)
    if Ks is not None:
        Ks = Ks.to(dtype)
        K_t = Ks.repeat(S, 1, 1)  # (S*N,3,3)
        invK_t = invert_intrinsics(Ks).repeat(S, 1, 1)
    else:
        K_t, invK_t = ctx.K, ctx.invK
    points = backproject(depth.reshape(S * n, hw), invK_t, ctx.grid)  # (S*N,HW,3)

    uvs = []
    for R, t in transforms:
        uvs.append(project(points, K_t, R.repeat(S, 1, 1), t.repeat(S, 1, 1), w, h))
    uv_all = torch.cat(uvs, dim=0)  # (Src*S*N, HW, 2)

    src_imgs = torch.cat(
        [frames[:, sid].repeat(S, 1, 1, 1) for sid in cfg.source_ids], dim=0
    )  # (Src*S*N, H, W, C)

    sampled = grid_sample(src_imgs, uv_all, method=cfg.warp_method)
    warped_all = sampled.reshape(Src, S, n, h, w, c)

    # batched photometric loss: (Src,S) folded into the batch for one SSIM pass
    target_rep = target.expand(Src * S, n, h, w, c).reshape(Src * S * n, h, w, c)
    photo = photometric_loss(warped_all.reshape(Src * S * n, h, w, c), target_rep).reshape(
        Src, S, n, h, w, 1
    )
    warp_loss = torch.min(photo, dim=0).values  # min over sources: (S,N,H,W,1)
    if cfg.automasking and auto_loss is not None:
        warp_loss = torch.minimum(auto_loss[None], warp_loss)

    # edge-aware smoothness, batched over scales
    mean_disp = torch.mean(disps_full, dim=(2, 3), keepdim=True)
    nd = (disps_full / (mean_disp + 1e-7))[..., 0]  # (S,N,H,W)
    dd_x = torch.abs(nd[..., :-1] - nd[..., 1:])
    dd_y = torch.abs(nd[..., :-1, :] - nd[..., 1:, :])
    di_x = torch.exp(-torch.mean(torch.abs(target[:, :, :-1] - target[:, :, 1:]), dim=-1))
    di_y = torch.exp(-torch.mean(torch.abs(target[:, :-1] - target[:, 1:]), dim=-1))
    smooth_per_scale = torch.mean(dd_x * di_x[None], dim=(1, 2, 3)) + torch.mean(
        dd_y * di_y[None], dim=(1, 2, 3)
    )  # (S,)

    scale_w = torch.tensor(cfg.scales, dtype=dtype, device=frames.device)
    per_scale = (
        torch.mean(warp_loss, dim=(1, 2, 3, 4))
        + smooth_per_scale * cfg.disparity_smoothness * scale_w
    )
    total = torch.mean(per_scale)

    if disp_reg_weight is not None:
        # anti-collapse stabilizer: L2 on the recovered pre-sigmoid logit
        d = disps_full.clamp(1e-6, 1.0 - 1e-6)
        logit = torch.log(d) - torch.log1p(-d)
        total = total + disp_reg_weight * torch.mean(logit * logit)

    aux["disparity"] = disps_full[-1]
    aux["warped"] = [warped_all[s, -1] for s in range(Src)]
    aux["warp_loss"] = warp_loss[-1]
    return total, aux
