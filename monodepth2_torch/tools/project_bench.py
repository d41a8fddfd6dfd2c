"""The projection kernels on the card, alone, at the training cells' shapes.

    python -m monodepth2_torch.tools.project_bench [--cells b4,b32] [--per-item-k] [--device cpu]

Times `project` (ops/geometry.py) forward and backward for one source at the
shape `training/loss.py` gives it: N = S·batch items of H·W points, K shared
(per item with --per-item-k), points backprojected from a random disparity
through the KITTI-like intrinsics (fx = fy = 482·W/416, centred), R and t
near the identity. Three methods:

  cuda   the hand-written kernels: project_fwd, project_bwd (each wrapper
         called directly; on a CPU tensor each computes its plain version)
  plain  their plain twins: project_plain, project_bwd_plain
  aten   the path the port ran before the kernels: autograd of project_plain,
         forward with grad recording and torch.autograd.grad for points, R
         and t (cuBLAS's small-N products and ATen's elementwise kernels)

Each time is taken twice with CUDA events (`utils.profiler.time_ms`): cold,
the L2 flushed clean before every call (`*_us`), and warm, calls back to back
(`*_us_warm`: inside the step backproject has just written the points). Bytes
are those each pass must move in fp32, each input read once and each output
written once: forward points and uv, backward points, g and d_points (the
3×3s and the per-block partials add under 0.01%). The bound is bytes over
the H100's 3.35 TB/s.

Prints one JSON line per cell and method, then a summary line with the
shapes, the bytes and bounds, and the card's name and power limit; a run on
the CPU (`--device cpu`, for tests) reports host-clock times and no bound
share.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import H100_BYTES_PER_S, describe, resolve_device
from ..ops import geometry as G
from ..utils.profiler import time_ms

# cell: (items N = S·batch, H, W), as training/loss.py calls project
CELLS = {"b4": (16, 128, 416), "b32": (128, 192, 640)}
METHODS = ("cuda", "plain", "aten")


def make_inputs(n: int, h: int, w: int, device, per_item_K: bool = False, seed: int = 0, edges: bool = True):
    """(points (n,h·w,3), K (3,3) or (n,3,3), R (n,3,3), t (n,3,1), g
    (n,h·w,2)) in float32 on `device`. Depth is 0.1-100 from a uniform
    disparity, as the loss makes it. With `edges`, each item's point 0 lies
    behind the camera (c_z < 0) and point 1 has c_z = 1e-2."""
    rng = np.random.default_rng(seed)
    f = 482.0 * w / 416.0
    K = np.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    if per_item_K:
        K = np.tile(K, (n, 1, 1))
        K[:, :2] *= rng.uniform(0.8, 1.2, size=(n, 2, 1))
    depth = 1.0 / (rng.uniform(size=(n, h * w, 1)) * (10.0 - 0.01) + 0.01)
    grid = G.pixel_grid(w, h, torch.float64).numpy()
    points = depth * (grid @ np.linalg.inv(K).swapaxes(-1, -2))
    R = G.so3_exp_map(torch.from_numpy(rng.normal(scale=0.02, size=(n, 3)))).numpy()
    t = rng.normal(scale=0.1, size=(n, 3, 1))
    if edges:
        points[:, 0] *= -10.0 / points[:, 0, 2:]  # 10 m behind
        # (R p + t)_z = 1e-2, solved for p_z
        points[:, 1, 2] = (1e-2 - t[:, 2, 0] - R[:, 2, 0] * points[:, 1, 0] - R[:, 2, 1] * points[:, 1, 1]) / R[:, 2, 2]
    g = rng.normal(size=(n, h * w, 2))
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device) for x in (points, K, R, t, g))


def project_bytes(n: int, p: int) -> dict:
    """fp32 bytes each pass must move at n items of p points: forward points
    in, uv out; backward points and g in, d_points out."""
    return {"fwd": 4 * n * p * (3 + 2), "bwd": 4 * n * p * (3 + 2 + 3)}


def method_fns(method: str, points, K, R, t, g, w: int, h: int):
    """(forward, forward + backward) callables of one method on fixed inputs."""
    if method == "cuda":
        fwd = lambda: G.project_fwd(points, K, R, t, w, h)
        return fwd, lambda: (fwd(), G.project_bwd(points, K, R, t, g, w, h))
    if method == "plain":
        fwd = lambda: G.project_plain(points, K, R, t, w, h)
        return fwd, lambda: (fwd(), G.project_bwd_plain(points, K, R, t, g, w, h))
    if method == "aten":
        xs = [x.detach().clone().requires_grad_() for x in (points, R, t)]
        fwd = lambda: G.project_plain(xs[0], K, xs[1], xs[2], w, h)
        return fwd, lambda: torch.autograd.grad(fwd(), xs, g)
    raise ValueError(f"unknown method {method!r}; choose from {METHODS}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(CELLS), help="comma-separated keys of CELLS")
    ap.add_argument("--per-item-k", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default=None, help="NxHxW in place of --cells (tests)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if args.size:
        cells = {"size": tuple(int(x) for x in args.size.split("x"))}
    else:
        cells = {name: CELLS[name] for name in args.cells.split(",")}

    def timed(fn):
        return {
            "cold": 1e3 * time_ms(fn, device, args.iters, flush_l2=True),
            "warm": 1e3 * time_ms(fn, device, args.iters, flush_l2=False),
        }

    rows, shapes = [], {}
    for cell, (n, h, w) in cells.items():
        points, K, R, t, g = make_inputs(n, h, w, device, args.per_item_k)
        nbytes = project_bytes(n, h * w)
        bound_us = {k: v / H100_BYTES_PER_S * 1e6 for k, v in nbytes.items()}
        shapes[cell] = {"N": n, "H": h, "W": w, "P": h * w, "bytes": nbytes, "h100_hbm_bound_us": bound_us}
        for method in METHODS:
            fwd, fwd_bwd = method_fns(method, points, K, R, t, g, w, h)
            tf, tb = timed(fwd), timed(fwd_bwd)
            row = {
                "cell": cell,
                "method": method,
                "fwd_us": tf["cold"],
                "bwd_us": tb["cold"] - tf["cold"],
                "fwd_bwd_us": tb["cold"],
                "fwd_us_warm": tf["warm"],
                "fwd_bwd_us_warm": tb["warm"],
            }
            if method == "cuda":
                bwd = timed(lambda: G.project_bwd(points, K, R, t, g, w, h))
                row["bwd_us"], row["bwd_us_warm"] = bwd["cold"], bwd["warm"]
                for key in ("fwd", "bwd"):
                    row[f"{key}_pct_hbm_roofline"] = 100 * bound_us[key] / row[f"{key}_us"] if on_card else None
            rows.append(row)
            print(json.dumps(row), flush=True)

    summary = {"shapes": shapes, "per_item_K": args.per_item_k, **describe(device), "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
