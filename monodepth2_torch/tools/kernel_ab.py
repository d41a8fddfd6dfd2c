"""The coordinate-warp kernels K1 (grid_sample_fwd) and K2
(grid_sample_bwd_uv) of the current ops/cuda/grid_sample.cu against earlier
versions of that source, on one card in one process.

    git show <commit>:monodepth2_torch/ops/cuda/grid_sample.cu > _archive/old.cu
    python -m monodepth2_torch.tools.kernel_ab --baseline _archive/old.cu [--baseline ...]

Each baseline must have the current source's C interface; it is built with
the current flags (`ops/cuda/_lib.NVCC_FLAGS`) beside the current library,
and ptxas's report of each build is printed. At the training shape (32
images of 128×416, one point a pixel, uv near the identity with ±3 px of
jitter as in chip_smoke.py), for each `--channels` C:

  - every version's out and duv against the first baseline's, bitwise
    (`torch.equal`) and by their largest difference, and every version's
    against the plain PyTorch versions within chip_smoke.py's tolerances
    (forward 1e-6 abs, d_uv 1e-4 abs + 1e-5 rel), on near-identity and on
    scattered uv;
  - times in turns, the versions in order and then in reverse (old, new,
    new, old for one baseline), each kernel with `utils.profiler.time_ms`:
    cold with a clean L2 (`clean`), cold after the write-only flush
    (`dirty`) and warm; the library's call for the same function
    (F.grid_sample; aten.grid_sampler_2d_backward, grid gradient only)
    beside each turn.

Prints one JSON line per turn and a summary line per C (times in µs, the
bytes bound, each version's clean share of it), with the card's name and
power limit; `--json-out` writes all of it. Needs a card.
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
from .warp_kernel_bench import kernel_bytes, make_uv

GS = importlib.import_module("monodepth2_torch.ops.grid_sample")
KERNELS = ("grid_sample_fwd", "grid_sample_bwd_uv")


def _launch(lib, name: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [a.data_ptr() for a in args if isinstance(a, torch.Tensor)]
    sizes = [a for a in args if not isinstance(a, torch.Tensor)]
    _lib.check(lib, getattr(lib, name)(*ptrs, *sizes, stream), name)


def version_fns(lib, img, uv, g, out, duv):
    """{kernel name: a call of that version's kernel into out / duv}."""
    n, h, w, c = img.shape
    p = uv.shape[1]
    return {
        "grid_sample_fwd": lambda: _launch(lib, "grid_sample_fwd", img, uv, out, n, h, w, c, p),
        "grid_sample_bwd_uv": lambda: _launch(lib, "grid_sample_bwd_uv", img, uv, g, duv, n, h, w, c, p),
    }


def library_fns(img, uv, g):
    n, _, _, c = img.shape
    p = uv.shape[1]
    img_nchw, grid = img.permute(0, 3, 1, 2), uv.reshape(n, 1, p, 2)
    g_nchw = g.permute(0, 2, 1).reshape(n, c, 1, p).contiguous()
    return {
        "grid_sample_fwd": lambda: F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="border", align_corners=True
        ),
        # interpolation 0 = bilinear, padding 1 = border, align_corners True
        "grid_sample_bwd_uv": lambda: torch.ops.aten.grid_sampler_2d_backward(
            g_nchw, img_nchw, grid, 0, 1, True, [False, True]
        ),
    }


def timings(fn, device, iters: int) -> dict:
    return {
        "clean": time_ms(fn, device, iters, flush_l2=True),
        "dirty": time_ms(fn, device, iters, flush_l2="dirty"),
        "warm": time_ms(fn, device, iters),
    }


def compare(versions: dict, img, uvs: dict, g) -> dict:
    """Per uv kind and version: bitwise equality with the first version and
    the largest differences, after checking each against the plain versions."""
    n, _, _, c = img.shape
    report = {}
    for kind, uv in uvs.items():
        p = uv.shape[1]
        ref_out, ref_duv = GS.grid_sample_fwd_plain(img, uv), GS.grid_sample_bwd_uv_plain(img, uv, g)
        outs = {}
        for name, lib in versions.items():
            out, duv = torch.empty((n, p, c), device=img.device), torch.empty((n, p, 2), device=img.device)
            for fn in version_fns(lib, img, uv, g, out, duv).values():
                fn()
            torch.cuda.synchronize()
            fwd_err = float((out - ref_out).abs().max())
            excess = float(((duv - ref_duv).abs() - (1e-4 + 1e-5 * ref_duv.abs())).max())
            if fwd_err > 1e-6 or excess > 0:
                raise RuntimeError(f"{name} ({kind} uv, C = {c}) disagrees with plain: {fwd_err}, {excess}")
            outs[name] = (out, duv)
        first = outs[next(iter(outs))]
        report[kind] = {
            name: {
                "fwd_bitwise": bool(torch.equal(out, first[0])),
                "bwd_uv_bitwise": bool(torch.equal(duv, first[1])),
                "fwd_max_abs_diff": float((out - first[0]).abs().max()),
                "bwd_uv_max_abs_diff": float((duv - first[1]).abs().max()),
            }
            for name, (out, duv) in outs.items()
        }
    return report


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
    ptxas = {
        name: _lib.ptxas_report(source=_lib.SOURCE if name == "current" else Path(name)) for name in versions
    }
    print(json.dumps({"ptxas": ptxas}), flush=True)

    N, H, W = args.n, args.height, args.width
    P = H * W
    gen = torch.Generator().manual_seed(0)
    result = {**describe(device), "shape": {"N": N, "H": H, "W": W, "P": P}, "ptxas": ptxas, "channels": {}}
    for c in (int(x) for x in args.channels.split(",")):
        img = torch.rand((N, H, W, c), generator=gen).to(device)
        g = torch.randn((N, P, c), generator=gen).to(device)
        uv = make_uv(N, H, W, gen, scattered=False).to(device)
        uvs = {"near-identity": uv, "scattered": make_uv(N, H, W, gen, scattered=True).to(device)}
        bitwise = compare(versions, img, uvs, g)
        out, duv = torch.empty((N, P, c), device=device), torch.empty((N, P, 2), device=device)
        library = library_fns(img, uv, g)
        order = list(versions)
        turns = []
        for name in order + order[::-1]:
            fns = version_fns(versions[name], img, uv, g, out, duv)
            turn = {"C": c, "version": name}
            for k in KERNELS:
                turn[k] = timings(fns[k], device, args.iters)
                turn[f"library_{k}"] = timings(library[k], device, args.iters)
            turns.append(turn)
            print(json.dumps(turn), flush=True)
        nbytes = kernel_bytes(N, H, W, c)
        summary = {"C": c, "nvidia_smi": result["nvidia_smi"]}
        for k in KERNELS:
            bound_us = nbytes[k] / H100_BYTES_PER_S * 1e6
            summary[f"{k}_bound_us"] = bound_us
            for name in order:
                for mode in ("clean", "dirty", "warm"):
                    summary[f"{k}_{name}_{mode}_us"] = [1e3 * t[k][mode] for t in turns if t["version"] == name]
                summary[f"{k}_{name}_clean_share_of_bound"] = bound_us / statistics.mean(
                    summary[f"{k}_{name}_clean_us"]
                )
            for mode in ("clean", "dirty", "warm"):
                summary[f"{k}_library_{mode}_us"] = [1e3 * t[f"library_{k}"][mode] for t in turns]
        print(json.dumps(summary), flush=True)
        result["channels"][c] = {"bitwise": bitwise, "turns": turns, "summary": summary}
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
