"""Headline benchmark of the port: training throughput on one card.

    python -m monodepth2_torch.bench [--device cpu]

Port of the measured part of bench.py (:117-197). Runs the full
self-supervised train step — ResNet-18 + depth/pose decoders + 4-scale warp
loss, batch 4, 416×128 grayscale, bf16 network with fp32 geometry and loss,
the warp through the hand-written grid-sample kernels — with weights drawn by
`create_train_state` from the config's seed, and prints ONE JSON line:

  metric, value (img/s), unit, ms_per_step (the best window), the windows,
  steps_per_call (1: one step per Python call), step_gflops, mfu_pct, and
  the card's torch name and nvidia-smi name and power limit.

Timing: warm-up steps (cuDNN autotuning included), then two windows of
`--steps` back-to-back steps, each from a drained card to a drained card
(`utils.profiler.wall_ms`); the better window is reported. `mfu_pct` is the step's FLOPs over the H100 SXM dense bf16 peak
(989 TFLOP/s, `device.H100_BF16_FLOPS`). The FLOPs come from
`torch.utils.flop_counter.FlopCounterMode` over one step, which counts only
matrix products and convolutions (forward and backward); XLA's cost
analysis, which the JAX bench used, counts every operation, so the two
percentages are not comparable.

A failure raises and exits nonzero. Without a card it raises unless
`--device cpu` is given; a CPU run (for tests) reports host-clock times and
no mfu_pct.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .device import H100_BF16_FLOPS, describe, resolve_device
from .models import Model
from .training import TrainConfig, TrainContext, create_train_state, make_train_step
from .utils.profiler import wall_ms

FOCAL = 482.0  # intrinsics of bench.py: fx = fy = 482, principal point at the centre


def setup(width: int, height: int, batch_size: int, device: torch.device, compute_dtype: str = "bfloat16"):
    """The bench's config, context, train state, step and frames:
    (cfg, ctx, state, step, frames). Frames are uniform noise from numpy seed 0."""
    cfg = TrainConfig(
        target_size=(width, height), batch_size=batch_size, in_channels=1, compute_dtype=compute_dtype
    )
    state = create_train_state(Model.create(depth=18, in_channels=1, device=device), cfg)
    K = np.asarray([[FOCAL, 0, width / 2], [0, FOCAL, height / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, width, height, device=device)
    rng = np.random.default_rng(0)
    frames = rng.uniform(size=(batch_size, 3, height, width, 1)).astype(np.float32)
    return cfg, ctx, state, make_train_step(ctx, cfg), torch.from_numpy(frames).to(device)


def count_flops(fn) -> int:
    """Matmul and convolution FLOPs of one fn() call (FlopCounterMode)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=50, help="steps per timed window")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    cfg, _, state, step, frames = setup(args.width, args.height, args.batch_size, device)

    last = {}

    def one_step():
        # the step updates the state in place and returns it
        _, last["metrics"], _ = step(state, frames)

    for _ in range(args.warmup):
        one_step()
    step_flops = count_flops(one_step)
    windows = wall_ms(one_step, device, args.steps, warmup=0, windows=2)
    loss = last["metrics"]["loss"].item()
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} after {state.step} steps")

    ms = min(windows)
    out = {
        "metric": f"kitti_{cfg.width}x{cfg.height}_train_images_per_sec_per_chip",
        "value": cfg.batch_size / (ms / 1e3),
        "unit": "img/s",
        "ms_per_step": ms,
        "ms_per_step_windows": windows,
        "steps_per_call": 1,
        "step_gflops": step_flops / 1e9,
        "mfu_pct": 100 * step_flops / (ms / 1e3) / H100_BF16_FLOPS if device.type == "cuda" else None,
        "loss": loss,
        "config": f"ResNet-18 {cfg.width}x{cfg.height} gray batch {cfg.batch_size}, bf16 network, fp32 loss",
        **describe(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
