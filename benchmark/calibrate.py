"""Readings that set the limits of a cell's comparison, on the card.

    python3 -m benchmark.calibrate --workload <train cell> --read program=1,2,3 --read control=4,5,6
        [--read <fault>=7,8,9 ...] [--read fp32=10] [--out FILE]

For each seed of each `--read WHAT=SEEDS`, in one process: the program's
first call as a run makes it (set-up, first call, freed) against the
float32 reference. WHAT is `program` (the lower readings); `control`, the
reference computing in float8 put in the program's place, or a fault of
`benchmark.faults` planted in the program (the upper readings); or `fp32`,
the program with its network in float32, a witness of how far float32
itself strays. Prints one JSON line a reading, with each number's detail:
every step's loss gap, and the worst leaves and the median leaf of each
leaf gap. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import torch

from . import faults, spec
from .kinds import train


def _leaves(side: dict, ref: dict, start: dict) -> dict:
    """The worst four leaves and the median leaf of each leaf gap."""
    out = {}
    names = list(ref["grad"])
    for key, fn in (("grad", lambda d, n: d["grad"][n]), ("change", lambda d, n: d["params3"][n] - start[n]),
                    ("replay_change", lambda d, n: d["params_end"][n] - side["params3"][n])):
        try:
            r = {n: float(fn(ref, n).norm()) for n in names}
            s = {n: float(fn(side, n).norm()) for n in names}
        except KeyError:
            continue
        median = statistics.median(r.values())
        gaps = sorted(((abs(s[n] - r[n]) / max(r[n], median, 1e-30), n) for n in names), reverse=True)
        out[f"{key}_worst"] = gaps[:4]
        out[f"{key}_median_leaf_gap"] = statistics.median(g for g, _ in gaps)
    return out


def reading(cell, seed: int, device, what: str, overrides: dict | None = None) -> dict:
    """One reading: `what` is program, control, a fault of
    `faults.PLANTS`, or fp32 (the program computing its network in
    float32, a witness)."""
    t0 = time.perf_counter()
    config = {**cell.config, "compute_dtype": "float32"} if what == "fp32" else dict(cell.config)
    config.update(overrides or {})
    session = train.Session(config, cell.traffic, seed, device)
    with faults.PLANTS[what]() if what in faults.PLANTS else contextlib.nullcontext():
        session.setup()
        session.first_call()
    session.release()
    side = session.control_side() if what == "control" else session.program_side()
    ref = session.reference(side)
    numbers = session.compare(side, ref)
    detail = _leaves(side, ref, session.start)
    return {"what": what, "seed": seed, **numbers, **detail, "losses": side["losses"],
            "reference_losses": ref["losses"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--read", action="append", default=[], metavar="WHAT=SEEDS",
                    help="program, control, fp32 or a fault, and a comma-separated list of seeds")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                    help="override a configuration key for a look at a reading's cause")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    overrides = {k: json.loads(v) for k, v in (item.split("=", 1) for item in args.set)}
    device = torch.device("cuda", 0)
    plan = []
    for item in args.read:
        what, seeds = item.split("=", 1)
        if what not in ("program", "control", "fp32", *faults.PLANTS):
            ap.error(f"unknown reading {what!r}")
        plan += [(int(s), what) for s in seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, what in plan:
            text = json.dumps(reading(cell, seed, device, what, overrides))
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
