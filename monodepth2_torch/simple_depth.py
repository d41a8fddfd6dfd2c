"""simple_depth: fit a raw per-pixel disparity map + two SE(3) poses to a
single image triplet by gradient descent — no neural network. Port of
monodepth2_tpu/simple_depth.py (reference: src/simple_depth.jl).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .ops.geometry import compose_transform, pixel_grid
from .ops.losses import prediction_loss, smooth_loss, warp_images


def fit_simple_depth(
    frames,
    K: np.ndarray,
    n_iters: int = 500,
    lr: float = 3e-4,
    target_id: int = 1,
    source_ids: Sequence[int] = (0, 2),
    min_depth: float = 0.1,
    max_depth: float = 100.0,
    init_disparity: float = 0.5,
    init_rvec: Sequence[float] = (0.0, 0.0, 0.01),
    log_every: int = 5,
    callback: Optional[Callable] = None,
    device: str | torch.device = "cuda",
):
    """frames (1,L,H,W,C) float (numpy or tensor); K (3,3). Returns a dict
    with the fitted disparity (1,H,W,1), poses [(rvec, tvec)], the loss
    history [(iter, loss)] and the last warped sources. `callback(it,
    params, loss, warped)`, where given, is called at each logged iteration
    with params {"disp", "rvec", "tvec"} (the tensors being fitted).

    The reference's initialization: disparity 0.5, rvec (0,0,0.01), Adam
    3e-4, 500 iterations (src/simple_depth.jl:8-22).
    """
    device = resolve_device(device)
    frames = torch.as_tensor(frames, device=device)
    n, l, h, w, c = frames.shape
    dtype = frames.dtype
    K_t = torch.as_tensor(np.asarray(K), dtype=dtype)
    invK = torch.as_tensor(np.linalg.inv(K_t.double().numpy()), dtype=dtype, device=device)
    K_t = K_t.to(device)
    grid = pixel_grid(w, h, dtype, device)
    target = frames[:, target_id]
    inverse = [sid < target_id for sid in source_ids]

    disp = torch.full((n, h, w, 1), init_disparity, dtype=dtype, device=device, requires_grad=True)
    rvec = torch.tensor(init_rvec, dtype=dtype, device=device).expand(len(source_ids), n, 3).clone().requires_grad_()
    tvec = torch.zeros((len(source_ids), n, 3, 1), dtype=dtype, device=device, requires_grad=True)
    optimizer = torch.optim.Adam([disp, rvec, tvec], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    history = []
    warped = None
    for it in range(1, n_iters + 1):
        optimizer.zero_grad(set_to_none=True)
        transforms = [compose_transform(rvec[i], tvec[i], invert=inv) for i, inv in enumerate(inverse)]
        warped = warp_images(
            disp, frames, transforms, K_t, invK, grid, source_ids, min_depth, max_depth
        )
        loss = torch.mean(prediction_loss(warped, target)) + smooth_loss(disp[..., 0], target)
        loss.backward()
        optimizer.step()
        if it % log_every == 0 or it == 1:
            history.append((it, loss.item()))
            if callback is not None:
                callback(it, {"disp": disp.detach(), "rvec": rvec.detach(), "tvec": tvec.detach()},
                         history[-1][1], warped)

    return {
        "disparity": disp.detach(),
        "poses": [(rvec[i].detach(), tvec[i].detach()) for i in range(len(source_ids))],
        "history": history,
        "warped": [x.detach() for x in warped],
    }
