"""Headline benchmark of the port: training throughput on one card.

    python -m monodepth2_torch.bench [--device cpu]

Port of the measured part of bench.py (:117-217, with its steps_per_call
path). Runs the full self-supervised train step — ResNet-18 + depth/pose
decoders + 4-scale warp loss, batch 4, 416×128 grayscale, bf16 network with
fp32 geometry and loss, the warp through the hand-written grid-sample
kernels — in the configuration of configs/kitti_ssl.json (disp_reg and the
lr decay on, steps_per_call 10), with weights drawn by `create_train_state`
from the config's seed, in two modes:

  eager  one step a Python call (`make_train_step`), every kernel launched
         by the host
  graph  `steps_per_call` steps a call (`make_scanned_train_step`): on the
         card one captured CUDA graph replayed that many times

Each mode has its own state from the same seed. After warm-up (cuDNN
autotuning, the graph's warm-up steps and capture included), the windows
run in turns — eager, graph, graph, eager — in one process, since the
host's speed, which bounds the eager step, changes from call to call. Each
window is `--steps` back-to-back steps from a drained card to a drained card
(`utils.profiler.wall_ms`); a mode reports its better window. Prints ONE
JSON line:

  metric, value (img/s), unit, mode, ms_per_step, ms_per_step_windows,
  mfu_pct and loss of the eager mode, whose headline name
  (kitti_{W}x{H}_train_images_per_sec_per_chip) is the one the bench has
  reported since it first ran; the same under "eager" and under "graph",
  each with its own metric name (the graph mode's is
  kitti_{W}x{H}_graph_train_images_per_sec_per_chip) and img/s;
  window_order, steps_per_call, step_gflops, the card's torch name,
  nvidia-smi name and power limit, and the host's CPU and load.

`mfu_pct` is the step's FLOPs over the H100 SXM dense bf16 peak (989
TFLOP/s, `device.H100_BF16_FLOPS`), the FLOPs from
`torch.utils.flop_counter.FlopCounterMode` over one eager step, which counts
only matrix products and convolutions; XLA's cost analysis, which the JAX
bench used, counts every operation, so the two percentages are not
comparable.

A failure raises and exits nonzero. Without a card it raises unless
`--device cpu` is given; a CPU run (for tests) reports host-clock times, no
mfu_pct, and runs the graph mode as eager steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from .device import H100_BF16_FLOPS, describe, resolve_device
from .models import Model
from .training import TrainConfig, TrainContext, create_train_state, make_scanned_train_step, make_train_step
from .utils.profiler import wall_ms

FOCAL = 482.0  # intrinsics of bench.py: fx = fy = 482, principal point at the centre
CONFIG = pathlib.Path(__file__).resolve().parents[1] / "configs" / "kitti_ssl.json"
MODES = ("eager", "graph")


def load_config(**overrides) -> TrainConfig:
    """configs/kitti_ssl.json, with some fields replaced."""
    return dataclasses.replace(TrainConfig.from_json(CONFIG.read_text()), **overrides)


def setup(cfg: TrainConfig, device: torch.device):
    """The bench's context, train state, step and frames for `cfg`:
    (ctx, state, step, frames). Frames are uniform noise from numpy seed 0,
    intrinsics those of bench.py."""
    width, height = cfg.target_size
    state = create_train_state(Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels, device=device), cfg)
    K = np.asarray([[FOCAL, 0, width / 2], [0, FOCAL, height / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, width, height, device=device)
    rng = np.random.default_rng(0)
    frames = rng.uniform(size=(cfg.batch_size, 3, height, width, cfg.in_channels)).astype(np.float32)
    return ctx, state, make_train_step(ctx, cfg), torch.from_numpy(frames).to(device)


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
    ap.add_argument("--steps-per-call", type=int, default=None, help="graph mode's steps a call (default: the config's)")
    ap.add_argument("--warmup", type=int, default=5, help="eager warm-up steps; the graph mode warms up as many, at least two calls")
    ap.add_argument("--steps", type=int, default=50, help="steps per timed window")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    cfg = load_config(target_size=(args.width, args.height), batch_size=args.batch_size, in_channels=1)
    if args.steps_per_call is not None:
        cfg = dataclasses.replace(cfg, steps_per_call=args.steps_per_call)
    spc = max(1, cfg.steps_per_call)
    ctx, eager_state, eager_step, frames = setup(cfg, device)
    graph_state = create_train_state(Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels, device=device), cfg)
    scanned = make_scanned_train_step(ctx, cfg)
    stack = frames.unsqueeze(0).expand(spc, *frames.shape)
    calls = max(1, args.steps // spc)  # a graph window's calls
    last = {}

    def eager_call():
        _, last["eager"], _ = eager_step(eager_state, frames)

    def graph_call():
        _, last["graph"], _ = scanned(graph_state, stack)

    for _ in range(args.warmup):
        eager_call()
    for _ in range(max(2, -(-args.warmup // spc))):
        graph_call()
    step_flops = count_flops(eager_call)

    order = ["eager", "graph", "graph", "eager"]
    windows = {mode: [] for mode in MODES}
    for mode in order:
        if mode == "eager":
            windows[mode] += wall_ms(eager_call, device, args.steps, warmup=0, windows=1)
        else:
            windows[mode] += [ms / spc for ms in wall_ms(graph_call, device, calls, warmup=0, windows=1)]
    losses = {"eager": last["eager"]["loss"].item(), "graph": last["graph"]["loss"][-1].item()}
    for mode, loss in losses.items():
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite {mode} loss {loss}")

    def summary(mode):
        ms = min(windows[mode])
        return {
            "metric": f"kitti_{cfg.width}x{cfg.height}_{'' if mode == 'eager' else 'graph_'}train_images_per_sec_per_chip",
            "ms_per_step": ms,
            "ms_per_step_windows": windows[mode],
            "img_per_s": cfg.batch_size / (ms / 1e3),
            "mfu_pct": 100 * step_flops / (ms / 1e3) / H100_BF16_FLOPS if device.type == "cuda" else None,
            "loss": losses[mode],
        }

    modes = {mode: summary(mode) for mode in MODES}
    eager = modes["eager"]
    out = {
        "metric": eager["metric"],
        "value": eager["img_per_s"],
        "unit": "img/s",
        "mode": "eager",
        "ms_per_step": eager["ms_per_step"],
        "ms_per_step_windows": eager["ms_per_step_windows"],
        "steps_per_call": spc,
        **modes,
        "window_order": order,
        "step_gflops": step_flops / 1e9,
        "mfu_pct": eager["mfu_pct"],
        "loss": eager["loss"],
        "config": f"ResNet-18 {cfg.width}x{cfg.height} gray batch {cfg.batch_size}, {cfg.compute_dtype} network, "
                  f"fp32 loss, {CONFIG.name} (disp_reg {cfg.disp_reg}, "
                  f"lr_decay_steps {cfg.lr_decay_steps})",
        **describe(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
