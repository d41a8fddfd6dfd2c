"""Serving-path throughput: the exported artifact against live inference,
port of tools/serving_bench.py.

    python -m monodepth2_torch.tools.serving_bench [--batches 1,4,16,64] [--iters 20] [--device cpu]

Batched disparity+depth inference of ResNet-18 at 416×128 gray with weights
drawn from seed 0, in fp32 and in bf16, through the live module
(`serving.make_inference_fn`) and through the artifact that
`serving.export_inference` writes and `serving.load_inference` loads back.
For each, at each batch size, two timings, each the better of two windows
of `--iters` back-to-back calls from a drained card to a drained card
(`utils.profiler.wall_ms`, CUDA events on the card, host time included):

  device  the input already on the card, the outputs left there: the
          card's time per batch plus whatever of the host's launches it
          cannot hide
  host    numpy in, numpy out: the copy to the card, the call and the copy
          of both outputs back, one call at a time — the ceiling of a
          request-response server (what one BucketBatcher dispatch pays)

Prints one JSON line per (variant, batch) with ms_per_batch and img_per_s,
then one line with the card's name and power limit and the artifacts'
sizes; returns them as a dict. Without a card it raises unless
`--device cpu` is given (host-clock times, for tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import describe, resolve_device
from ..models import Model
from ..serving import export_inference, load_inference, make_inference_fn
from ..training.config import TrainConfig
from ..utils.profiler import wall_ms


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default="1,4,16,64")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    batches = [int(b) for b in args.batches.split(",")]
    cfg = TrainConfig(target_size=(args.width, args.height), in_channels=1)
    model = Model.create(depth=18, in_channels=1, scale_levels=cfg.scale_levels, device=device)
    rng = np.random.default_rng(0)
    inputs = {b: rng.uniform(size=(b, cfg.height, cfg.width, 1)).astype(np.float32) for b in batches}

    rows, sizes = [], {}

    def timed(tag: str, call) -> None:
        for b in batches:
            x_host = inputs[b]
            x_dev = torch.from_numpy(x_host).to(device)

            def on_device():
                return call(x_dev)

            def round_trip():
                return {k: v.cpu().numpy() for k, v in call(x_host).items()}

            for mode, fn in (("device", on_device), ("host", round_trip)):
                ms = min(wall_ms(fn, device, args.iters))
                row = dict(variant=tag, io=mode, batch=b, ms_per_batch=ms, img_per_s=b / ms * 1e3)
                rows.append(row)
                print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
            tag = "fp32" if dtype == "float32" else "bf16"
            live = make_inference_fn(model, dcfg)

            def call_live(x, live=live):
                with torch.inference_mode():
                    return live(torch.as_tensor(x).to(device))

            timed(f"live_{tag}", call_live)
            path = os.path.join(tmp, f"serve_bench.{tag}.pt2")
            export_inference(model, dcfg, path)
            sizes[tag] = os.path.getsize(path)
            timed(f"artifact_{tag}", load_inference(path, device=device))
    summary = dict(artifact_bytes=sizes, width=cfg.width, height=cfg.height, iters=args.iters, **describe(device))
    print(json.dumps(summary), flush=True)
    return dict(rows=rows, **summary)


if __name__ == "__main__":
    main()
