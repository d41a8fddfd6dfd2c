"""Variants of the image VJP K3 (grid_sample_bwd_img in ops/cuda/grid_sample.cu),
built side by side from the current source and timed in turns on one card.

    python -m monodepth2_torch.tools.k3_sweep [--variants a,b,...] [--channels 1,3]

Each variant is the current source with one edit (VARIANTS): K3's launch
constants (threads a block, points a thread, band slack rows) or one of its
choices turned off — the 16-B vector flush, the band, the shared border
copy — or, as a probe that computes a wrong d_img and is timed only, one
phase taken out: the shared-memory adds (`no-shared-adds`: the terms summed
in a register instead), their atomicity (`plain-shared-adds`: a racy
read-add-write), the flush (`no-flush`) or the whole kernel (`fill-only`:
the wrapper's zero fill alone). An edit that no longer matches the source
raises. The variants are built in parallel with the current flags under
ops/cuda/_build/ and loaded beside the current library (`current`).

At the training shape (32 images of 128×416, one point a pixel), for each
C, on near-identity, smooth and scattered uv (as tools.kernel_ab): every
variant but the probes is held to the plain version (per-pixel tolerance
and Σ conservation, `kernel_ab.dimg_checks`); then every variant and the
library's input gradient are timed clean-L2 cold (`time_ms`, with the zero
fill), in order and then in reverse. Prints the ptxas report and dynamic
shared memory of each build, then one line per C with each variant's two
times in µs, with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..device import describe, resolve_device
from ..ops.cuda import _lib
from ..utils.profiler import time_ms
from . import kernel_ab
from .warp_kernel_bench import make_inputs, make_uv

K3 = kernel_ab.K3
BAND_ADD = "      atomicAdd(sums + c * plane + (y - row0) * W + x, term);\n"
PROBES = ("no-shared-adds", "plain-shared-adds", "no-flush", "fill-only")

# name: ({constant: value}, [(text of the current source, its replacement)])
VARIANTS = {
    "threads-128": ({"kImgThreads": 128}, []),
    "threads-512": ({"kImgThreads": 512}, []),
    "points-2": ({"kImgPts": 2}, []),
    "points-8": ({"kImgPts": 8}, []),
    "slack-8": ({"kBandSlackRows": 8}, []),
    "scalar-flush": ({}, [(
        "      atomicAdd(reinterpret_cast<float4*>(dst + e), v);\n",
        "      atomicAdd(dst + e, v.x), atomicAdd(dst + e + 1, v.y), atomicAdd(dst + e + 2, v.z),"
        " atomicAdd(dst + e + 3, v.w);\n",
    )]),
    "no-band": ({}, [("  const bool band = rows * W * nc <= cap;\n", "  const bool band = false;\n")]),
    "no-border-copy": ({}, [(
        "  const bool border = !band && border_pixels(H, W) * nc <= cap;\n", "  const bool border = false;\n"
    )]),
    "no-shared-adds": ({}, [
        (BAND_ADD, "      probe += term;\n"),
        ("  if (band) {\n    for_each_term", "  float probe = 0.0f;\n  if (band) {\n    for_each_term"),
        ("  __syncthreads();\n\n  // 4.", "  if (probe == 1234.5f) sums[0] = probe;\n  __syncthreads();\n\n  // 4."),
    ]),
    "plain-shared-adds": ({}, [(BAND_ADD, "      sums[c * plane + (y - row0) * W + x] += term;\n")]),
    "no-flush": ({}, [("    flush_planar<CT>(sums, plane, rows * W, dimgn + row0 * W * nc, nc);\n", "")]),
    "fill-only": ({}, [(
        "  grid_sample_bwd_img_kernel<CT><<<grid, kImgThreads, smem, stream>>>(u, gg, d, H, W, C, P, vec, cap);\n",
        "",
    )]),
}


def variant_source(name: str, source: str) -> str:
    """The current source with variant `name`'s edits; raises ValueError if
    one of them no longer matches the source."""
    constants, edits = VARIANTS[name]
    for constant, value in constants.items():
        source, n = re.subn(rf"constexpr int {constant} = \d+;", f"constexpr int {constant} = {value};", source)
        if n != 1:
            raise ValueError(f"{name}: constant {constant} not found once in the source")
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"{name}: edit does not match the source once: {old.strip()[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str]) -> dict:
    """{name: (its source, its library)}, built in parallel under
    ops/cuda/_build/."""
    text = _lib.SOURCE.read_text()
    folder = _lib.BUILD_DIR / "k3_variants"
    folder.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name in names:
        sources[name] = folder / f"{name}.cu"
        sources[name].write_text(variant_source(name, text))
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        built = dict(zip(names, pool.map(_lib.build, sources.values())))
    return {name: (sources[name], built[name]) for name in names}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--channels", default="1,3")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("k3_sweep times CUDA kernels: it needs a card")
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; choose from {list(VARIANTS)}")
    builds = build_variants(names)
    libs = {"current": _lib.load(), **{n: _lib.load_source(src) for n, (src, _) in builds.items()}}
    N, H, W = 32, 128, 416
    P = H * W
    channels = [int(c) for c in args.channels.split(",")]
    result = {**describe(device), "shape": {"N": N, "H": H, "W": W}, "builds": {}, "channels": {}}
    for name, lib in libs.items():
        source = _lib.SOURCE if name == "current" else builds[name][0]
        result["builds"][name] = {
            "ptxas": {k: v for k, v in _lib.ptxas_report(source=source).items() if K3 in k},
            "dynamic_smem_bytes": {c: _lib.bwd_img_smem_bytes(lib, H, W, c) for c in channels},
        }
    print(json.dumps({"builds": result["builds"]}), flush=True)
    gen = torch.Generator().manual_seed(0)
    for c in channels:
        img = torch.rand((N, H, W, c), generator=gen).to(device)
        g = torch.randn((N, P, c), generator=gen).to(device)
        uvs = {
            "near-identity": make_uv(N, H, W, gen, scattered=False).to(device),
            "smooth": make_inputs(N, H, W, c, device)[1],
            "scattered": make_uv(N, H, W, gen, scattered=True).to(device),
        }
        out, duv = torch.empty((N, P, c), device=device), torch.empty((N, P, 2), device=device)
        dimg = torch.empty((N, H, W, c), device=device)
        for kind, uv in uvs.items():
            for name, lib in libs.items():
                if name in PROBES:
                    continue
                kernel_ab.version_fns(lib, img, uv, g, out, duv, dimg)[K3]()
                torch.cuda.synchronize()
                checks = kernel_ab.dimg_checks(img, uv, g, dimg)
                if checks["excess"] > 0 or checks["sum_excess"] > 0:
                    raise RuntimeError(f"variant {name} ({kind} uv, C = {c}) disagrees with plain: {checks}")
        times = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                for kind, uv in uvs.items():
                    fn = kernel_ab.version_fns(libs[name], img, uv, g, out, duv, dimg)[K3]
                    times.setdefault(name, {}).setdefault(kind, []).append(
                        1e3 * time_ms(fn, device, args.iters, flush_l2=True)
                    )
            for kind, uv in uvs.items():
                fn = kernel_ab.library_fns(img, uv, g)[K3]
                times.setdefault("library", {}).setdefault(kind, []).append(
                    1e3 * time_ms(fn, device, args.iters, flush_l2=True)
                )
        line = {"C": c, "nvidia_smi": result["nvidia_smi"], "clean_us": times}
        print(json.dumps(line), flush=True)
        result["channels"][c] = line
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
