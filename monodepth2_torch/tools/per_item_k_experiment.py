"""Per-item intrinsics on a chain of two calibrations, port of
tools/per_item_k_experiment.py.

    python -m monodepth2_torch.tools.per_item_k_experiment --steps 5000 --out runs/per_item_k_torch

The reference trains a whole DChain with the FIRST sequence's K
(src/Monodepth.jl:99). This experiment measures what that costs and what
per_item_K recovers: two SyntheticDriving datasets whose cameras differ
(focal_scale renders through another calibration, with frames, ground-truth
depth and poses consistent), trained under the same data order, seed and
recipe-C stabilizers in two conditions:

  first_child_K  per_item_K=False: every item warps with dataset A's K (the
                 reference's behavior; dataset B is miscalibrated throughout)
  per_item_K     per_item_K=True: each item warps with its own K

and scored (median-scaled AbsRel, δ<1.25) on held-out scenes of each
calibration separately. Writes <out>/results.json and each condition's
checkpoints and logs under <out> (keep <out> under the gitignored runs/).
Runs on the card unless `--device cpu` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--n-scenes", type=int, default=128, help="per dataset")
    ap.add_argument("--n-val", type=int, default=12, help="per dataset")
    ap.add_argument("--focal-scale", type=float, default=0.7)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--steps-per-call", type=int, default=10)
    ap.add_argument("--out", default="runs/per_item_k_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--conditions", default="first_child_K,per_item_K")
    args = ap.parse_args(argv)

    from ..data import DChain, SyntheticDriving
    from ..device import resolve_device
    from ..eval import eval_depth_accuracy
    from ..training import TrainConfig
    from ..training.checkpoint import latest_checkpoint
    from ..training.loop import fit

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    size = (args.width, args.height)

    def make_chain():
        # fresh per condition: the renderer's cache would otherwise pin the
        # first condition's frames
        a = SyntheticDriving(n=args.n_scenes, target_size=size, seed=0)
        b = SyntheticDriving(n=args.n_scenes, target_size=size, seed=5000, focal_scale=args.focal_scale)
        return DChain([a, b])

    # held-out val scenes per calibration
    vals = {}
    for tag, seed, fs in (("A", 9999, 1.0), ("B", 10999, args.focal_scale)):
        ds = SyntheticDriving(n=args.n_val, target_size=size, seed=seed, focal_scale=fs)
        vals[tag] = ([ds[i][ds.target_id] for i in range(len(ds))], [ds.gt_depth_for(i) for i in range(len(ds))])

    base = TrainConfig(
        target_size=size,
        batch_size=args.batch_size,
        epochs=10_000,  # max_steps ends the run
        lr=1e-4,
        seed=42,
        # recipe C: the stabilizers that make from-scratch SSL converge on
        # these scenes
        min_depth=1.0,
        max_depth=80.0,
        disp_reg=0.01,
        disp_reg_steps=2500,
        compute_dtype="bfloat16",
        steps_per_call=args.steps_per_call,
        log_every=500,
        save_every=0,
    )

    results = {"config": vars(args)}
    for cond in args.conditions.split(","):
        cdir = os.path.join(args.out, cond)
        cfg = dataclasses.replace(base, per_item_K=cond == "per_item_K", log_dir=os.path.join(cdir, "logs"),
                                  save_dir=os.path.join(cdir, "ckpts"))
        t0 = time.time()
        fit(cfg, make_chain(), max_steps=args.steps, verbose=False, progress=False, device=device)
        wall = time.time() - t0
        ck = latest_checkpoint(cfg.save_dir)
        scores = {tag: eval_depth_accuracy(cfg, ck, images, gts, device=device) for tag, (images, gts) in vals.items()}
        results[cond] = {"wall_s": round(wall, 1), "val": scores}
        print(json.dumps({cond: results[cond]}), flush=True)
        with open(os.path.join(args.out, "results.json"), "w") as f:
            json.dump(results, f, indent=2)

    if all(c in results for c in ("first_child_K", "per_item_K")):
        a, b = results["first_child_K"]["val"], results["per_item_K"]["val"]
        results["summary"] = {
            "A_subset_absrel": [a["A"]["abs_rel"], b["A"]["abs_rel"]],
            "B_subset_absrel": [a["B"]["abs_rel"], b["B"]["abs_rel"]],
            "order": ["first_child_K", "per_item_K"],
        }
        print(json.dumps({"summary": results["summary"]}), flush=True)
    return results


if __name__ == "__main__":
    main()
