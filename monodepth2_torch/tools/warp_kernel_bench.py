"""Warp-kernel microbenchmark on the card, port of tools/warp_kernel_bench.py.

    python -m monodepth2_torch.tools.warp_kernel_bench [--channels 3] [--device cpu]

Times the grid sample's forward, and its forward + full VJP (d_img and
d_uv), at the batched training shape — N = Src·S·batch = 32 images of
128×416, P = 53,248 points, C = 1 — on the near-identity warp of the JAX
tool (identity plus a per-image horizontal shift), for three methods:

  cuda     the port's hand-written kernels: K1 grid_sample_fwd, K2
           grid_sample_bwd_uv, K3 grid_sample_bwd_img (each wrapper called
           directly; on a CPU tensor each computes its plain version)
  plain    the plain PyTorch versions of the three
  library  F.grid_sample and aten.grid_sampler_2d_backward with output mask
           [True, True]: the same weights and clamped taps, but PyTorch
           counts a sample exactly on the border as outside, so its d_uv is 0
           there where the port's (the Pallas rule) is the one-sided slope

Each time is taken twice with CUDA events (`utils.profiler.time_ms`): with
the L2 flushed clean before every call (cold, `*_ms`) and with calls back to
back (warm, `*_ms_warm`: inputs still in L2, as inside a step where
`project` just wrote uv). The `cuda` row
also times each kernel alone. Bytes are those each function must move (each
input read once, each output written once, fp32); the bound is bytes over the
H100's 3.35 TB/s, and `*_pct_hbm_roofline` is that bound over the cold time.
The TPU tool's MXU rows have no counterpart: no kernel here uses the tensor
cores.

Prints one JSON line per method, then a summary line with the shape, the
bytes and bounds per kernel, and the card's name and power limit; a run on
the CPU (`--device cpu`, for tests) reports host-clock times and no roofline.
"""

from __future__ import annotations

import argparse
import importlib
import json
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import H100_BYTES_PER_S, describe, resolve_device
from ..utils.profiler import time_ms

# the module, not the function of the same name that ops/__init__ exports
GS = importlib.import_module("monodepth2_torch.ops.grid_sample")

METHODS = ("cuda", "plain", "library")


def kernel_bytes(n: int, h: int, w: int, c: int, p: Optional[int] = None) -> dict:
    """fp32 bytes each function must move at image (n,h,w,c) and p points a
    image (default h·w): each input read once, each output written once."""
    p = h * w if p is None else p
    img, uv, val = n * h * w * c, n * p * 2, n * p * c  # val: out, or g
    return {
        "grid_sample_fwd": 4 * (img + uv + val),
        "grid_sample_bwd_uv": 4 * (img + uv + val + uv),
        "grid_sample_bwd_img": 4 * (uv + val + img),
        # forward + VJP as one function: img, uv, g in; out, d_img, d_uv out
        "fwd": 4 * (img + uv + val),
        "fwd_bwd": 4 * (img + uv + val + val + img + uv),
    }


def make_inputs(n: int, h: int, w: int, c: int, device: torch.device, seed: int = 0):
    """img (n,h,w,c) uniform, uv (n,h·w,2) the JAX tool's warp
    (warp_kernel_bench.py:55-63), g = ones (n,h·w,c)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    base_u = np.tile(np.linspace(-1, 1, w), (h, 1))
    base_v = np.tile(np.linspace(-1, 1, h)[:, None], (1, w))
    off = 0.08 * rng.standard_normal((n, 1, 1))
    uv = np.stack([np.tile(base_u, (n, 1, 1)) + off, np.tile(base_v, (n, 1, 1))], axis=-1)
    uv = uv.reshape(n, h * w, 2).astype(np.float32)
    g = np.ones((n, h * w, c), np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (img, uv, g))


def make_uv(n: int, h: int, w: int, generator: torch.Generator, scattered: bool, p: Optional[int] = None):
    """uv (n, p, 2) on the CPU, p = h·w by default: `scattered` draws every
    point uniformly over [-1.2, 1.2]²; otherwise a warp near the identity, as
    training sees, with shifts of up to ±3 px a point (point i near pixel i
    in raster order, so p <= h·w). Either way the first points of each image
    are set exactly on each edge and corner, and beyond them. The inputs of
    chip_smoke.py's kernel checks and times, and of tools.kernel_ab."""
    p = h * w if p is None else p
    if scattered:
        uv = torch.rand((n, p, 2), generator=generator) * 2.4 - 1.2
    else:
        if p > h * w:
            raise ValueError(f"a near-identity warp has at most h·w = {h * w} points, got {p}")
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        pix = torch.stack([xs, ys], -1).reshape(1, h * w, 2)[:, :p].float()
        pix = pix + (torch.rand((n, p, 2), generator=generator) * 6 - 3)
        uv = pix / torch.tensor([w - 1.0, h - 1.0]) * 2 - 1
    edges = torch.tensor(
        [[-1, 0.3], [1, -0.2], [0.1, -1], [-0.4, 1], [-1, -1], [1, 1], [-1, 1], [1, -1],
         [-1.3, 0.2], [1.2, 0.5], [0.3, -1.5], [0.6, 1.1], [-2, 3], [1, 1.4]]
    )
    uv[:, : len(edges)] = edges
    return uv.contiguous()


def offset_view(t: torch.Tensor, floats: int) -> torch.Tensor:
    """t's values in a contiguous view `floats` floats into a larger buffer on
    t's device (one point of uv is 2 floats, of g C floats), so not aligned
    as a fresh tensor is."""
    n, p, k = t.shape
    view = torch.empty(n * p * k + floats, dtype=t.dtype, device=t.device)[floats:].view(n, p, k)
    view.copy_(t)
    return view


# The image VJP's checks (K3): both paths of its design — the band of rows
# summed in shared memory, and direct adds with a shared copy of the border
# — and their edges
BWD_IMG_CASES = (
    "near-identity", "exact identity", "band heights", "scattered", "corners",
    "P not a multiple of W", "odd P", "views one point in", "views one float in",
)


def bwd_img_case(name: str, c: int, generator: torch.Generator, device, h: int = 128, w: int = 416):
    """(img, uv, g) on `device` for one of BWD_IMG_CASES at C = c, at the
    main-path image size h×w (32 images, or fewer where the case needs no
    more):

      near-identity          make_uv's jittered identity, edge points first
      exact identity         every point on a pixel (wx = wy = 0), so the
                             last row of each block's band gets only terms of 0
      band heights           image i moves every 512th point i rows down: bands
                             of every height from the block's own to 23 rows
                             more, past what a block's shared memory holds
      scattered              uniform over [-1.2, 1.2]²: clamped points pile
                             onto the border
      corners                every point beyond a corner
      P not a multiple of W  near-identity, h·w − 37 points: the last block
                             starts mid-row, and P is odd
      odd P                  near-identity, 599 points of a 20×30 image
      views one point in     near-identity, uv and g one point into a larger
                             buffer (not 16-B aligned)
      views one float in     near-identity, h·w − 3 points, uv and g one float
                             in (uv not 8-B aligned)
    """
    n = 32
    if name == "near-identity":
        uv = make_uv(n, h, w, generator, scattered=False)
    elif name == "exact identity":
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        pix = torch.stack([xs, ys], -1).reshape(1, h * w, 2).float()
        uv = (pix / torch.tensor([w - 1.0, h - 1.0]) * 2 - 1).repeat(n, 1, 1)
    elif name == "band heights":
        n = 24
        uv = make_uv(n, h, w, generator, scattered=False)
        uv[:, :14] = uv[:, 14:28]  # no edge points: the moved points alone widen the bands
        shift = torch.arange(n, dtype=torch.float32)[:, None] * 2 / (h - 1)
        uv[:, ::512, 1] = (uv[:, ::512, 1] + shift).clamp(max=1.0)
    elif name == "scattered":
        uv = make_uv(n, h, w, generator, scattered=True)
    elif name == "corners":
        n = 4
        corners = torch.tensor([[-2.0, -2.0], [2.0, 2.0], [-2.0, 2.0], [2.0, -2.0]])
        uv = corners.repeat(n, (h * w + 3) // 4, 1)[:, : h * w]
    elif name == "P not a multiple of W":
        n = 4
        uv = make_uv(n, h, w, generator, scattered=False, p=h * w - 37)
    elif name == "odd P":
        n, h, w = 3, 20, 30
        uv = make_uv(n, h, w, generator, scattered=False, p=599)
    elif name in ("views one point in", "views one float in"):
        n = 4
        uv = make_uv(n, h, w, generator, scattered=False, p=h * w - (3 if name.endswith("float in") else 0))
    else:
        raise ValueError(f"unknown case {name!r}; choose from {BWD_IMG_CASES}")
    img = torch.rand((n, h, w, c), generator=generator).to(device)
    g = torch.randn((n, uv.shape[1], c), generator=generator).to(device)
    uv = uv.contiguous().to(device)
    if name == "views one point in":
        uv, g = offset_view(uv, 2), offset_view(g, c)
    elif name == "views one float in":
        uv, g = offset_view(uv, 1), offset_view(g, 1)
    return img, uv, g


def method_fns(method: str, img, uv, g):
    """(forward, forward + full VJP) callables of one method on fixed inputs."""
    if method == "cuda":
        fwd = lambda: GS.grid_sample_fwd(img, uv)
        bwd = lambda: (GS.grid_sample_bwd_img(img, uv, g), GS.grid_sample_bwd_uv(img, uv, g))
    elif method == "plain":
        fwd = lambda: GS.grid_sample_fwd_plain(img, uv)
        bwd = lambda: (GS.grid_sample_bwd_img_plain(img, uv, g), GS.grid_sample_bwd_uv_plain(img, uv, g))
    elif method == "library":
        n, _, _, c = img.shape
        p = uv.shape[1]
        img_nchw = img.permute(0, 3, 1, 2)
        grid = uv.reshape(n, 1, p, 2)
        g_nchw = g.permute(0, 2, 1).reshape(n, c, 1, p).contiguous()
        fwd = lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)
        # interpolation 0 = bilinear, padding 1 = border, align_corners True
        bwd = lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 1, True, [True, True])
    else:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    return fwd, lambda: (fwd(), bwd())


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32, help="warped images (Src*S*batch)")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--methods", default=",".join(METHODS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    N, H, W, C = args.n, args.height, args.width, args.channels
    P = H * W
    img, uv, g = make_inputs(N, H, W, C, device)
    nbytes = kernel_bytes(N, H, W, C)
    on_card = device.type == "cuda"
    bound_ms = {k: v / H100_BYTES_PER_S * 1e3 for k, v in nbytes.items()}
    iters_bwd = max(args.iters // 3, 2)

    def timed(fn, iters):
        return {
            "cold": time_ms(fn, device, iters, flush_l2=True),
            "warm": time_ms(fn, device, iters, flush_l2=False),
        }

    def pct(bound, ms):
        return 100 * bound / ms if on_card else None

    rows = []
    for method in args.methods.split(","):
        fwd, fwd_bwd = method_fns(method, img, uv, g)
        tf, tb = timed(fwd, args.iters), timed(fwd_bwd, iters_bwd)
        row = {
            "method": method,
            "fwd_ms": tf["cold"],
            "fwd_bwd_ms": tb["cold"],
            "fwd_ms_warm": tf["warm"],
            "fwd_bwd_ms_warm": tb["warm"],
            "fwd_pct_hbm_roofline": pct(bound_ms["fwd"], tf["cold"]),
            "fwd_bwd_pct_hbm_roofline": pct(bound_ms["fwd_bwd"], tb["cold"]),
        }
        if method == "cuda":
            row["kernel_ms"] = {
                k.name: timed(fn, args.iters)
                for k, fn in (
                    (GS.grid_sample_fwd, lambda: GS.grid_sample_fwd(img, uv)),
                    (GS.grid_sample_bwd_uv, lambda: GS.grid_sample_bwd_uv(img, uv, g)),
                    (GS.grid_sample_bwd_img, lambda: GS.grid_sample_bwd_img(img, uv, g)),
                )
            }
        rows.append(row)
        print(json.dumps(row), flush=True)

    summary = {
        "shape": {"N": N, "H": H, "W": W, "C": C, "P": P},
        **describe(device),
        "bytes": nbytes,
        "h100_hbm_bound_us": {k: v * 1e3 for k, v in bound_ms.items()},
        "bwd_img_timed_with": "the wrapper's zero fill of d_img (+4·N·H·W·C bytes) and the kernel",
        "rows": rows,
    }
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
