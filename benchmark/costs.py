"""The yardstick's arithmetic: the H100's published peaks, the bytes the
grid sample must move at a cell's warp shape, and the FLOPs of a training
step counted on the benchmark's own reference.

Peaks: one H100 SXM at its 700 W limit, dense, from NVIDIA's data sheet.
Bytes: each input read once and each output written once, in float32
(the arithmetic of `chip_smoke.py` and `tools/kernel_ab.bounds_us`).
FLOPs: `torch.utils.flop_counter.FlopCounterMode` (matrix products and
convolutions) over the reference's loss and its backward on the meta
device, so the count is the operation's at the cell's shapes, whatever
implements it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference import train as ref_train
from .reference.model import Model

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def warp_shape(config: dict) -> tuple:
    """(images, H, W, C) of the step's one grid-sample call: every source
    at every scale level, for every row of the batch."""
    width, height = config["target_size"]
    return (2 * len(config["scale_levels"]) * config["batch_size"], height, width, config["in_channels"])


def grid_sample_bytes(n: int, h: int, w: int, c: int) -> dict:
    """float32 bytes of the forward (image, uv in; samples out) and of the
    coordinate VJP (image, uv, incoming gradient in; d_uv out), with one
    sample point per pixel."""
    img, uv, val = n * h * w * c, n * h * w * 2, n * h * w * c
    return {"fwd": 4 * (img + uv + val), "bwd_uv": 4 * (img + uv + val + uv)}


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def step_flops(config: dict) -> int:
    """Matrix-product and convolution FLOPs of one training step (forward
    and backward of the loss) at the configuration's shapes."""
    width, height = config["target_size"]
    device = torch.device("meta")
    model = Model(config["in_channels"], tuple(config["scale_levels"])).to(device)
    frames = torch.empty((config["batch_size"], 3, height, width, config["in_channels"]), device=device)
    K = torch.eye(3, device=device)
    with FlopCounterMode(display=False) as counter:
        ref_train.loss(model, frames, K, config, 0).backward()
    return counter.get_total_flops()
