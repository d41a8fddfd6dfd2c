"""The grid-sample kernels K1 (grid_sample_fwd), K2 (grid_sample_bwd_uv) and
K3 (grid_sample_bwd_img) of the current ops/cuda/grid_sample.cu against
earlier versions of that source, on one card in one process.

    git show <commit>:monodepth2_torch/ops/cuda/grid_sample.cu > _archive/old.cu
    python -m monodepth2_torch.tools.kernel_ab --baseline _archive/old.cu [--baseline ...]

Each baseline must have the current source's C interface; it is built with
the current flags (`ops/cuda/_lib.NVCC_FLAGS`) beside the current library,
and ptxas's report of each build is printed, with the dynamic shared memory
of each K3 launch at the shape (ptxas counts only the static part). At the
training shape (32 images of 128×416, one point a pixel), for each
`--channels` C, on three kinds of uv: near the identity with ±3 px of
jitter a point and edge and out-of-range points first (`near-identity`, as
in chip_smoke.py), the warp bench's smooth warp (`smooth`: identity plus a
per-image horizontal shift, the case nearest training's warps) and uniform
over [-1.2, 1.2]² (`scattered`):

  - every version's out, duv and d_img against the first baseline's,
    bitwise (`torch.equal`) and by their largest difference, and every
    version's against the plain PyTorch versions within chip_smoke.py's
    tolerances (forward 1e-6 abs, d_uv 1e-4 abs + 1e-5 rel, d_img per pixel
    1e-5·Σ_p|g·w| + 1e-6); d_img also conserves the sum of g over each
    image and channel (in float64, within that tolerance summed over the
    pixels, 1e-5·Σ_p|g| + 1e-6·H·W), and two launches of one version are
    compared bitwise (`bwd_img_repeat_bitwise`: atomics add in no fixed
    order);
  - times in turns, the versions in order and then in reverse (old, new,
    new, old for one baseline), each kernel with `utils.profiler.time_ms`:
    cold with a clean L2 (`clean`), cold after the write-only flush
    (`dirty`) and warm; K1 and K2 on near-identity uv, K3 (with the zero
    fill of d_img that the wrapper runs, as callers get it) on each kind;
    the library's call for the same function (F.grid_sample;
    aten.grid_sampler_2d_backward with the one output the kernel computes)
    beside each turn.

Prints one JSON line per turn and a summary line per C (times in µs; the
bytes bound of each kernel, and for K3 also the bound with the zero fill;
each version's and the library's clean share of each), with the card's
name and power limit; `--json-out` writes all of it. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import H100_BYTES_PER_S, describe, resolve_device
from ..ops.cuda import _lib
from ..utils.profiler import time_ms
from .warp_kernel_bench import kernel_bytes, make_inputs, make_uv

GS = importlib.import_module("monodepth2_torch.ops.grid_sample")
KERNELS = ("grid_sample_fwd", "grid_sample_bwd_uv", "grid_sample_bwd_img")
K3 = "grid_sample_bwd_img"
UV_KINDS = ("near-identity", "smooth", "scattered")
MODES = ("clean", "dirty", "warm")


def _launch(lib, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
    sizes = [a for a in args if not isinstance(a, torch.Tensor)]
    _lib.check(lib, getattr(lib, name)(*ptrs, *sizes, stream), name)


def version_fns(lib, img, uv, g, out, duv, dimg):
    """{kernel name: a call of that version's kernel into out / duv / dimg};
    K3's call zeroes dimg first, as the wrapper does."""
    n, h, w, c = img.shape
    p = uv.shape[1]

    def bwd_img():
        dimg.zero_()
        _launch(lib, K3, uv, g, dimg, n, h, w, c, p)

    return {
        "grid_sample_fwd": lambda: _launch(lib, "grid_sample_fwd", img, uv, out, n, h, w, c, p),
        "grid_sample_bwd_uv": lambda: _launch(lib, "grid_sample_bwd_uv", img, uv, g, duv, n, h, w, c, p),
        K3: bwd_img,
    }


def library_fns(img, uv, g):
    n, _, _, c = img.shape
    p = uv.shape[1]
    img_nchw, grid = img.permute(0, 3, 1, 2), uv.reshape(n, 1, p, 2)
    g_nchw = g.permute(0, 2, 1).reshape(n, c, 1, p).contiguous()

    def bwd(mask):
        # interpolation 0 = bilinear, padding 1 = border, align_corners True
        return lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 1, True, mask)

    return {
        "grid_sample_fwd": lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True
        ),
        "grid_sample_bwd_uv": bwd([False, True]),
        K3: bwd([True, False]),
    }


def timings(fn, device, iters: int) -> dict:
    return {
        "clean": time_ms(fn, device, iters, flush_l2=True),
        "dirty": time_ms(fn, device, iters, flush_l2="dirty"),
        "warm": time_ms(fn, device, iters),
    }


def dimg_checks(img, uv, g, dimg) -> dict:
    """K3's output against the plain version: the largest excess over the
    per-pixel tolerance 1e-5·Σ_p|g·w| + 1e-6 and over the summed tolerance of
    Σ conservation (float64 sums of d_img over each image's pixels against
    those of g over its points); both pass at <= 0."""
    _, h, w, _ = img.shape
    plain = GS.grid_sample_bwd_img_plain(img, uv, g)
    scale = GS.grid_sample_bwd_img_plain(img, uv, g.abs())
    conservation = (dimg.double().sum((1, 2)) - g.double().sum(1)).abs()
    return {
        "max_abs_err": float((dimg - plain).abs().max()),
        "excess": float(((dimg - plain).abs() - (1e-5 * scale + 1e-6)).max()),
        "sum_excess": float((conservation - (1e-5 * g.double().abs().sum(1) + 1e-6 * h * w)).max()),
    }


def compare(versions: dict, img, uvs: dict, g) -> dict:
    """Per uv kind and version: bitwise equality with the first version and
    the largest differences, after checking each against the plain versions."""
    n, h, w, c = img.shape
    report = {}
    for kind, uv in uvs.items():
        p = uv.shape[1]
        ref_out, ref_duv = GS.grid_sample_fwd_plain(img, uv), GS.grid_sample_bwd_uv_plain(img, uv, g)
        outs = {}
        for name, lib in versions.items():
            out, duv = torch.empty((n, p, c), device=img.device), torch.empty((n, p, 2), device=img.device)
            dimg, again = (torch.empty((n, h, w, c), device=img.device) for _ in range(2))
            fns = version_fns(lib, img, uv, g, out, duv, dimg)
            for fn in fns.values():
                fn()
            version_fns(lib, img, uv, g, out, duv, again)[K3]()
            torch.cuda.synchronize()
            fwd_err = float((out - ref_out).abs().max())
            excess = float(((duv - ref_duv).abs() - (1e-4 + 1e-5 * ref_duv.abs())).max())
            img_check = dimg_checks(img, uv, g, dimg)
            if fwd_err > 1e-6 or excess > 0 or img_check["excess"] > 0 or img_check["sum_excess"] > 0:
                raise RuntimeError(
                    f"{name} ({kind} uv, C = {c}) disagrees with plain: {fwd_err}, {excess}, {img_check}"
                )
            outs[name] = (out, duv, dimg, bool(torch.equal(dimg, again)), img_check)
        first = outs[next(iter(outs))]
        report[kind] = {
            name: {
                "fwd_bitwise": bool(torch.equal(out, first[0])),
                "bwd_uv_bitwise": bool(torch.equal(duv, first[1])),
                "bwd_img_bitwise": bool(torch.equal(dimg, first[2])),
                "fwd_max_abs_diff": float((out - first[0]).abs().max()),
                "bwd_uv_max_abs_diff": float((duv - first[1]).abs().max()),
                "bwd_img_max_abs_diff": float((dimg - first[2]).abs().max()),
                "bwd_img_repeat_bitwise": repeat,
                "bwd_img_vs_plain": img_check,
            }
            for name, (out, duv, dimg, repeat, img_check) in outs.items()
        }
    return report


def bounds_us(n: int, h: int, w: int, c: int) -> dict:
    """Bytes bounds in µs at H100_BYTES_PER_S: each kernel's function (each
    input read once, each output written once) and K3's with the wrapper's
    zero fill of d_img (4·N·H·W·C more bytes written), which its times
    include."""
    nbytes = kernel_bytes(n, h, w, c)
    out = {k: nbytes[k] / H100_BYTES_PER_S * 1e6 for k in KERNELS}
    out[f"{K3}_with_fill"] = (nbytes[K3] + 4 * n * h * w * c) / H100_BYTES_PER_S * 1e6
    return out


def summarize(c: int, turns: list, order: list, bounds: dict, nvidia_smi: str) -> dict:
    """One C's summary of its turns: every version's and the library's times
    in µs for each kind of uv and mode, one entry a turn, and each one's
    share of the bytes bound, bound over its mean clean time (K3: of both
    bounds)."""
    summary = {"C": c, "nvidia_smi": nvidia_smi}
    for k in KERNELS:
        summary[f"{k}_bound_us"] = bounds[k]
        if k == K3:
            summary[f"{k}_bound_with_fill_us"] = bounds[f"{k}_with_fill"]
        for kind in UV_KINDS if k == K3 else ("near-identity",):
            tag = f"{k}_{kind}" if k == K3 else k
            for name in order + ["library"]:
                runs = [t for t in turns if name == "library" or t["version"] == name]
                key = f"library_{k}" if name == "library" else k
                for mode in MODES:
                    summary[f"{tag}_{name}_{mode}_us"] = [
                        1e3 * (t[key][kind] if k == K3 else t[key])[mode] for t in runs
                    ]
                clean = statistics.mean(summary[f"{tag}_{name}_clean_us"])
                summary[f"{tag}_{name}_clean_share_of_bound"] = bounds[k] / clean
                if k == K3:
                    summary[f"{tag}_{name}_clean_share_of_bound_with_fill"] = bounds[f"{k}_with_fill"] / clean
    return summary


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", action="append", required=True, help="an earlier grid_sample.cu (repeatable)")
    ap.add_argument("--channels", default="1,3")
    ap.add_argument("--n", type=int, default=32, help="warped images (Src*S*batch)")
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("kernel_ab compares CUDA kernels: it needs a card")
    versions = {str(path): _lib.load_source(Path(path)) for path in args.baseline}
    versions["current"] = _lib.load()
    channels = [int(x) for x in args.channels.split(",")]
    N, H, W = args.n, args.height, args.width
    ptxas = {
        name: {
            "kernels": _lib.ptxas_report(source=_lib.SOURCE if name == "current" else Path(name)),
            "bwd_img_dynamic_smem_bytes": {c: _lib.bwd_img_smem_bytes(lib, H, W, c) for c in channels},
        }
        for name, lib in versions.items()
    }
    print(json.dumps({"ptxas": ptxas}), flush=True)

    P = H * W
    gen = torch.Generator().manual_seed(0)
    result = {**describe(device), "shape": {"N": N, "H": H, "W": W, "P": P}, "ptxas": ptxas, "channels": {}}
    for c in channels:
        img = torch.rand((N, H, W, c), generator=gen).to(device)
        g = torch.randn((N, P, c), generator=gen).to(device)
        uvs = {
            "near-identity": make_uv(N, H, W, gen, scattered=False).to(device),
            "smooth": make_inputs(N, H, W, c, device)[1],
            "scattered": make_uv(N, H, W, gen, scattered=True).to(device),
        }
        checks = compare(versions, img, uvs, g)
        out, duv = torch.empty((N, P, c), device=device), torch.empty((N, P, 2), device=device)
        dimg = torch.empty((N, H, W, c), device=device)
        libraries = {kind: library_fns(img, uv, g) for kind, uv in uvs.items()}
        order = list(versions)
        turns = []
        for name in order + order[::-1]:
            fns = {kind: version_fns(versions[name], img, uv, g, out, duv, dimg) for kind, uv in uvs.items()}
            turn = {"C": c, "version": name}
            for k in KERNELS:
                if k == K3:
                    turn[k] = {kind: timings(fns[kind][k], device, args.iters) for kind in UV_KINDS}
                    turn[f"library_{k}"] = {kind: timings(libraries[kind][k], device, args.iters) for kind in UV_KINDS}
                else:
                    turn[k] = timings(fns["near-identity"][k], device, args.iters)
                    turn[f"library_{k}"] = timings(libraries["near-identity"][k], device, args.iters)
            turns.append(turn)
            print(json.dumps(turn), flush=True)
        summary = summarize(c, turns, order, bounds_us(N, H, W, c), result["nvidia_smi"])
        print(json.dumps(summary), flush=True)
        result["channels"][c] = {"checks": checks, "turns": turns, "summary": summary}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
