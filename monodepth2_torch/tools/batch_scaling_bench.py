"""Training throughput against the batch size on one card, port of
tools/batch_scaling_bench.py.

    python -m monodepth2_torch.tools.batch_scaling_bench [--batches 4,16,64] [--device cpu]

For each batch: configs/kitti_ssl.json (ResNet-18, 416×128 gray, bf16
network, fp32 geometry and loss, steps_per_call 10) with weights from its
seed, the scanned step (`make_scanned_train_step`: on the card one captured
CUDA graph replayed a micro-step) over one stack of uniform-noise frames
from numpy seed 0, two warm-up calls (the graph's warm-up steps and its
capture), then two windows of max(2, 20 // steps_per_call) calls from a
drained card to a drained card (`utils.profiler.wall_ms`); the better window
counts. Prints one JSON line a batch (batch, ms_per_step, img_per_s, the
windows) and returns them with the card's name, power limit and the host.
Without a card it raises unless `--device cpu` (host-clock times there).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Optional, Sequence

import torch

from ..bench import load_config, setup
from ..device import describe, resolve_device
from ..training import make_scanned_train_step
from ..utils.profiler import wall_ms


def measure(batch: int, device: torch.device, size=(416, 128), steps_per_call: Optional[int] = None) -> dict:
    extra = {} if steps_per_call is None else {"steps_per_call": steps_per_call}
    cfg = load_config(target_size=size, batch_size=batch, in_channels=1, **extra)
    spc = max(1, cfg.steps_per_call)
    ctx, state, _, frames = setup(cfg, device)
    scanned = make_scanned_train_step(ctx, cfg)
    stack = frames.unsqueeze(0).expand(spc, *frames.shape)
    last = {}

    def call():
        _, last["metrics"], _ = scanned(state, stack)

    windows = [ms / spc for ms in wall_ms(call, device, max(2, 20 // spc), warmup=2, windows=2)]
    loss = last["metrics"]["loss"][-1].item()
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} at batch {batch}")
    ms = min(windows)
    return {"batch": batch, "size": list(size), "steps_per_call": spc, "ms_per_step": ms,
            "img_per_s": batch / (ms / 1e3), "ms_per_step_windows": windows, "loss": loss}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default="4,16,64")
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--steps-per-call", type=int, default=None, help="default: the config's")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    rows = []
    for b in (int(x) for x in args.batches.split(",")):
        row = measure(b, device, (args.width, args.height), args.steps_per_call)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return {"rows": rows, "config": "configs/kitti_ssl.json", **describe(device)}


if __name__ == "__main__":
    main()
