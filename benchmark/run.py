"""One run of one cell of the benchmark of monodepth2_torch.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. Loads, warms up, measures
for `--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line, last on standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number compared beside its
limit. The same numbers close standard error. Earlier lines on standard
error carry the peak device memory, the card's clocks and power, and the
kind's own notes.

It exits nonzero and prints no result without a CUDA device (or with fewer
than the cell asks for), and when a module of JAX or of the JAX package is
loaded once the window has closed. The program's build caches stay inside
the checkout: the kernels' nvcc build in `monodepth2_torch/ops/cuda/_build`
and the native decoder's in `monodepth2_torch/data/_build` (fixed in the
program), and any Triton or Inductor cache under `.bench_cache/`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import spec
from .result import check_lines, forbidden_modules, line

ROOT = Path(__file__).resolve().parent.parent


def process_start() -> float:
    """When this process started, on the monotonic clock (Linux: the boot
    clock and /proc/self/stat's start time, in clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started_since_boot = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - started_since_boot
    return time.monotonic() - age


def fixed_caches() -> None:
    """Any Triton or Inductor cache inside the checkout, at a fixed path;
    no library of the run loads JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / ".bench_cache" / "inductor")
    os.environ["USE_FLAX"] = "0"


def gpu_state() -> str:
    """nvidia-smi's name, clocks, power and temperature of every card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def limits_of(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "limits" / f"{name}.json").read_text())


def execute(cell, seed: int, seconds: float, trace: bool, device, plant=None) -> tuple:
    """Everything of a run after the look for the card: (exit code, the
    result's line or None). `plant` breaks the timed path (tests only)."""
    import torch

    outcome = spec.kind(cell.traffic).run(cell, seed, seconds, trace, device, process_start(),
                                          limits_of(cell.name), plant=plant)
    print(f"gpu after: {gpu_state()}", file=sys.stderr)
    print(f"memory_peak_bytes {outcome.memory_peak_bytes} (max_memory_allocated)", file=sys.stderr)
    for key, value in outcome.notes.items():
        print(f"note {key} {json.dumps(value)}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3, None
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.layer_metric(m["name"]).read(outcome.reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if trace and outcome.reading.trace is not None:
        t = outcome.reading.trace
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        breakdown = t.breakdown()
    for text in check_lines(outcome):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0, line(outcome, metrics, device_info, breakdown)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); this machine has {count}",
              file=sys.stderr)
        return 2
    print(f"gpu before: {gpu_state()}", file=sys.stderr, flush=True)
    code, text = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    if text is not None:
        print(text, flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
