"""What the program's spans and counters cost when they are on: the train
path of a benchmark cell (`benchmark.kinds.train.Session`: fit's loader,
groups, device_prefetch and the replayed scanned step) timed in windows of
`--seconds` with the recorder off and on (`utils.profiler.record`), in
turns off, on, on, off, with no torch.profiler session, for each seed.

    python experiments/tracing_cost.py --workload kitti416_b4_train_mem \\
        --seeds 3000000001 3000000002 3000000003 --seconds 20 --out runs/tracing_cost.json

Prints and writes one JSON object: each window's img/s and steps, the
recorder's span counts of each "on" window, the median of each side and
their relative difference (on over off, less 1). Needs a CUDA device; with
`--device cpu` it runs at the cell's size on the CPU, for a rehearsal only
(`--width`/`--height` shrink it). Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec
    from benchmark.kinds.train import Session, sync
    from monodepth2_torch.utils import profiler

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tracing_cost: no CUDA device (pass --device cpu for a rehearsal)")
    cell = spec.cell(args.workload)
    config = dict(cell.config)
    if args.width and args.height:
        config["target_size"] = [args.width, args.height]
    out = {"workload": args.workload, "seconds": args.seconds,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "seeds": {}}
    for seed in args.seeds:
        session = Session(config, cell.traffic, seed, device)
        session.setup()
        session.first_call()
        session.warm()
        windows = []
        for on in (False, True, True, False):
            profiler.reset()
            profiler.record(on)
            try:
                reading = session.window(args.seconds)
            finally:
                profiler.record(False)
            sync(device)
            spans = {k: v["count"] for k, v in profiler.snapshot()["spans"].items()}
            windows.append({"on": on, "steps": reading.steps, "window_s": reading.window_s,
                            "img_per_s": reading.steps * session.cfg.batch_size / reading.window_s, "spans": spans})
        session.release()
        profiler.reset()
        out["seeds"][str(seed)] = windows
        print(json.dumps({"seed": seed, "img_per_s": [round(w["img_per_s"], 2) for w in windows]}), flush=True)
    sides = {on: [w["img_per_s"] for ws in out["seeds"].values() for w in ws if w["on"] == on] for on in (False, True)}
    out["median_off"], out["median_on"] = statistics.median(sides[False]), statistics.median(sides[True])
    out["on_over_off"] = out["median_on"] / out["median_off"] - 1
    print(json.dumps({k: out[k] for k in ("workload", "device", "median_off", "median_on", "on_over_off")}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
