"""Host input-pipeline throughput against the card's training step, port of
tools/loader_bench.py.

    python -m monodepth2_torch.tools.loader_bench [--n-triplets 48] [--workers 1,2,4] [--device cpu]

Builds a throwaway KITTI-style PNG tree from a seed — grayscale frames at
the size of KITTI odometry sequences 00-02 (1241×376), smooth gradients plus
noise, which compress like road scenes — and times triplets/s through the
port's DataLoader over KittiDataset at the training size (416×128), with
the native decoder (data/native.py) and with PIL, at 1, 2 and 4 loader
workers. Each decoder first reads the tree once untimed (the page cache);
each timed row is one epoch. A decoder that is unavailable gets a row with
the build's error in place of a rate.

Beside the rows it runs `monodepth2_torch.bench`, shortened, and reports
the replayed (graph) step's img/s: each training image is one triplet, so
`feed_margin` (a row's triplets/s over the step's img/s) above 1 means that
decoder at that worker count keeps the card fed. Prints the bench's JSON
line, then its own: rows, step, the host's CPU, cores and load
(`device.describe`) and the card's name and power limit. Without a card it
raises unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from ..device import describe, resolve_device

KITTI_ODOMETRY_SIZE = (1241, 376)  # width, height of sequences 00-02


def build_tree(root: str, n_triplets: int, width: int, height: int, seed: int = 0) -> str:
    """A KITTI-style tree <root>/sequences/00/{calib.txt,image_0/%06d.png}
    of 3·n_triplets grayscale frames of width×height."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    seq_dir = os.path.join(root, "sequences", "00")
    img_dir = os.path.join(seq_dir, "image_0")
    os.makedirs(img_dir)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write(f"P0: 718.856 0.0 {width / 2} 0.0 0.0 718.856 {height / 2} 0.0 0.0 0.0 1.0 0.0\n")
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    base = 120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    for i in range(3 * n_triplets):
        arr = np.clip(base + 25 * rng.standard_normal((height, width)), 0, 255).astype(np.uint8)
        Image.fromarray(arr, "L").save(os.path.join(img_dir, f"{i:06d}.png"))
    return root


def triplets_per_s(dataset, batch_size: int, num_workers: int) -> float:
    """One epoch of the port's DataLoader over `dataset`: triplets/s."""
    from ..data import DataLoader

    loader = DataLoader(dataset, batch_size, shuffle=True, seed=0, num_workers=num_workers)
    n = 0
    t0 = time.perf_counter()
    for batch in loader:
        n += batch.shape[0]
    return n / (time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-triplets", type=int, default=48)
    ap.add_argument("--src-width", type=int, default=KITTI_ODOMETRY_SIZE[0])
    ap.add_argument("--src-height", type=int, default=KITTI_ODOMETRY_SIZE[1])
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--step-steps", type=int, default=20, help="steps of each bench window")
    args = ap.parse_args(argv)

    from ..data import KittiDataset, native

    device = resolve_device(args.device)
    workers = [int(w) for w in args.workers.split(",")]
    rows = []
    root = tempfile.mkdtemp(prefix="loaderbench-")
    try:
        build_tree(root, args.n_triplets, args.src_width, args.src_height)
        for decoder in ("native", "pil"):
            if decoder == "native" and not native.available():
                rows.append({"decoder": "native", "error": native.build_error()})
                continue
            ds = KittiDataset(root, "00", target_size=(args.width, args.height), use_native=decoder == "native")
            if ds.decoder != decoder:
                raise RuntimeError(f"asked for the {decoder} decoder, the dataset uses {ds.decoder}")
            triplets_per_s(ds, args.batch_size, max(workers))  # the page cache
            for w in workers:
                rows.append({"decoder": decoder, "workers": w,
                             "triplets_per_s": triplets_per_s(ds, args.batch_size, w)})
    finally:
        shutil.rmtree(root, ignore_errors=True)

    from .. import bench

    result = bench.main([
        "--device", str(device.type), "--width", str(args.width), "--height", str(args.height),
        "--batch-size", str(args.batch_size), "--warmup", "2", "--steps", str(args.step_steps),
    ])
    step = {"graph_img_per_s": result["graph"]["img_per_s"], "graph_ms_per_step": result["graph"]["ms_per_step"],
            "eager_img_per_s": result["eager"]["img_per_s"], "config": result["config"]}
    for row in rows:
        if "triplets_per_s" in row:
            row["feed_margin"] = row["triplets_per_s"] / step["graph_img_per_s"]
    out = {
        "rows": rows, "step": step,
        "frames": f"{args.src_width}x{args.src_height} gray PNG -> {args.width}x{args.height}",
        "n_triplets": args.n_triplets, "batch_size": args.batch_size, **describe(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
