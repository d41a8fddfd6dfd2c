"""The qualitative demo, port of tools/make_demo.py: a camera flythrough of a
SyntheticDriving scene, each frame inferred by a trained checkpoint, written
as a side-by-side input-over-disparity PNG strip and an mp4, or an animated
GIF where imageio (or its ffmpeg backend) is missing.

    python -m monodepth2_torch.tools.make_demo --checkpoint <ckpt> --out runs/demo

Reads the port's checkpoints and the JAX package's (eval.load_model). Runs
on the card unless `--device cpu` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--out", default="runs/demo")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--scene", type=int, default=3)
    ap.add_argument("--fps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image

    from ..data.synthetic import SyntheticDriving, _yaw_matrix
    from ..eval import load_model, make_infer_fn
    from ..training import TrainConfig
    from ..utils.viz import colorize_disparity

    cfg = TrainConfig(target_size=(args.width, args.height), in_channels=1, min_depth=1.0, max_depth=80.0)
    infer = make_infer_fn(load_model(cfg, args.checkpoint, device=args.device), cfg.compute_dtype)

    ds = SyntheticDriving(n=max(args.scene + 1, 8), target_size=(args.width, args.height), channels=1)
    boxes, banks = ds._scene(args.scene)
    # flythrough: constant forward motion and a gentle yaw sweep
    frames = []
    for t in range(args.frames):
        yaw = 0.15 * np.sin(2 * np.pi * t / args.frames)
        img, _ = ds._render(boxes, banks, _yaw_matrix(yaw), np.asarray([0.0, 0.0, 0.35 * t]))
        frames.append(img)
    x = np.stack(frames).astype(np.float32)  # (T, H, W, 1)
    disp = infer(x).cpu().numpy()  # (T, H, W)

    os.makedirs(args.out, exist_ok=True)
    panels = []
    for t in range(args.frames):
        gray = np.repeat((np.clip(x[t], 0, 1) * 255).astype(np.uint8), 3, axis=-1)
        panels.append(np.concatenate([gray, colorize_disparity(disp[t])], axis=0))  # input over depth

    # contact sheet of up to 6 frames spread over the flythrough
    strip = os.path.join(args.out, "demo-strip.png")
    Image.fromarray(np.concatenate(panels[:: max(args.frames // 6, 1)][:6], axis=1)).save(strip)
    written = {"strip": strip}
    try:
        import imageio.v2 as imageio

        video = os.path.join(args.out, "demo.mp4")
        imageio.mimwrite(video, panels, fps=args.fps, quality=7)
        written["video"] = video
    except (ImportError, OSError, RuntimeError, ValueError) as e:
        # no imageio, or no ffmpeg backend for it: an animated GIF, which is
        # also what the reference ships (res/simple-depth.gif)
        print(f"mp4 skipped: {e}")
        gif = os.path.join(args.out, "demo.gif")
        ims = [Image.fromarray(p) for p in panels]
        ims[0].save(gif, save_all=True, append_images=ims[1:], duration=int(1000 / args.fps), loop=0)
        written["video"] = gif
    for path in written.values():
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
