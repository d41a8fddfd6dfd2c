"""Model-layer breakdown and batched inference throughput, port of
tools/model_block_bench.py.

    python -m monodepth2_torch.tools.model_block_bench [--batch 12] [--infer-batch 64] [--device cpu]

ResNet-18 at 416×128 gray, weights drawn from seed 0, the network in bf16
(params and BN stats cast) in eval mode under inference mode. Times

  encoder_fwd                       the encoder over `--batch` images (a
                                    train step's 3 frames × batch 4)
  depth_decoder_fwd                 the depth decoder on those features
  pose_decoder_fwd                  the pose decoder on one feature pair
  depth_decoder_fwd_zeropad         the depth decoder rebuilt with zero
                                    padding where it reflect-pads: NOT
                                    numerically equivalent (the 1-pixel
                                    border differs), an ablation of the
                                    pad's cost only

each the card's time for one call (`utils.profiler.time_ms`, warm: the
median of 3 windows of `--iters` back-to-back calls, host launches hidden),
and the batched inference throughput of `eval.make_infer_fn` at
`--infer-batch` (bf16, the input already on the card), as a caller waits
for it (`utils.profiler.wall_ms`, host time included). Prints two JSON
lines (the blocks in ms, then the throughput with the card's name and power
limit) and returns them as a dict. Without a card it raises unless
`--device cpu` is given (host-clock times, for tests).
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import describe, resolve_device
from ..eval import make_infer_fn
from ..models import Model
from ..nn.core import Conv
from ..utils.profiler import time_ms, wall_ms


def zero_padded(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` whose reflect-padded convolutions zero-pad by the
    same amount inside the convolution instead."""
    out = copy.deepcopy(module)
    for m in out.modules():
        if isinstance(m, Conv) and m.padding == "reflect":
            m.padding = (m.kernel[0] - 1) // 2
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=12, help="images through the encoder (train: 3 frames x 4)")
    ap.add_argument("--infer-batch", type=int, default=64)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = Model.create(depth=18, in_channels=1, device=device)
    net = copy.deepcopy(model).eval().to(torch.bfloat16)
    n, h, w = args.batch, args.height, args.width
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(n, 1, h, w)).astype(np.float32)).to(device, torch.bfloat16)

    with torch.inference_mode():
        feats = net.encoder(x)
        zero_decoder = zero_padded(net.depth_decoder)
        blocks = {
            "encoder_fwd": lambda: net.encoder(x),
            "depth_decoder_fwd": lambda: net.depth_decoder(feats),
            "pose_decoder_fwd": lambda: net.pose_decoder((feats[-1], feats[-1])),
            "depth_decoder_fwd_zeropad": lambda: zero_decoder(feats),
        }
        rows = {name: time_ms(fn, device, args.iters) for name, fn in blocks.items()}
    out_blocks = dict(batch=n, width=w, height=h, compute_dtype="bfloat16", ms=rows)
    print(json.dumps(out_blocks), flush=True)

    bi = args.infer_batch
    infer = make_infer_fn(model, "bfloat16")
    xi = torch.from_numpy(rng.uniform(size=(bi, h, w, 1)).astype(np.float32)).to(device)
    ms = min(wall_ms(lambda: infer(xi), device, args.iters))
    throughput = dict(
        metric="inference_disparity_images_per_sec", batch=bi, compute_dtype="bfloat16",
        ms_per_batch=ms, img_per_s=bi / ms * 1e3, **describe(device),
    )
    print(json.dumps(throughput), flush=True)
    return dict(blocks=out_blocks, inference=throughput)


if __name__ == "__main__":
    main()
