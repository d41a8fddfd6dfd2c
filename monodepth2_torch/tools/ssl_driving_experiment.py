"""Self-supervised convergence experiment on SyntheticDriving scenes, port
of tools/ssl_driving_experiment.py.

    python -m monodepth2_torch.tools.ssl_driving_experiment --steps 6000 --out runs/ssl_torch_c \\
        --min-depth 1 --max-depth 80 --disp-reg 0.01 --disp-reg-steps 2500    # recipe C

The system-level proof that the full SSL loop — pose network in the loop,
no ground truth in training — learns depth: the port's trainer
(`training.loop.fit`, its data loader, and on the card the captured CUDA
graph of 10 steps a call) trains ResNet-18 on ray-cast
SyntheticDriving scenes (forward ego-motion with yaw), and every
`--eval-every` steps the model is scored on held-out scenes (seed 9999)
against their ground-truth depth with the median-scaled `depth_metrics`,
and its poses against the renderer's (rotation geodesic error and the angle
of the translation direction, the parts of a pose that monocular SSL can
observe). A constant-disparity prediction gives the "learned nothing"
baseline.

The training runs as one `fit` call per evaluation interval, each resuming
from the checkpoint the one before saved (the step, the weights, Adam's
state, the data cursor), so a killed run resumes from its newest checkpoint
too. Writes <out>/history.json (step, loss and mean disparity of the step
fit logged, val metrics, pose errors, elapsed seconds) and keeps the newest
two checkpoints in <out>/ckpts. Without a card it raises unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import SyntheticDriving
from ..device import resolve_device
from ..eval import make_infer_fn
from ..ops.geometry import compose_transform
from ..training.checkpoint import latest_checkpoint
from ..training.config import TrainConfig
from ..training.loop import fit
from ..utils.metrics import depth_metrics

# micro-steps a call of the scanned step, as configs/kitti_ssl.json: on the
# card one captured CUDA graph replayed that many times
STEPS_PER_CALL = 10


def _prune(ckpt_dir: str, keep: int = 2) -> None:
    """Delete all but the newest `keep` checkpoints."""
    steps = sorted(int(f[len("ckpt-"):-len(".npz")]) for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt-") and f.endswith(".npz"))
    for step in steps[:-keep]:
        for ext in (".npz", ".json"):
            path = os.path.join(ckpt_dir, f"ckpt-{step}{ext}")
            if os.path.exists(path):
                os.remove(path)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--n-scenes", type=int, default=256)
    ap.add_argument("--n-val", type=int, default=16)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--grad-clip", type=float, default=0.0)
    ap.add_argument("--lr-warmup", type=int, default=0)
    ap.add_argument("--lr-decay-steps", type=int, default=0)
    ap.add_argument("--lr-decay-factor", type=float, default=0.1)
    ap.add_argument("--smoothness", type=float, default=1e-3)
    ap.add_argument("--min-depth", type=float, default=0.1)
    ap.add_argument("--max-depth", type=float, default=100.0)
    ap.add_argument("--disp-reg", type=float, default=0.0)
    ap.add_argument("--disp-reg-steps", type=int, default=0)
    ap.add_argument("--pose-tz-init", type=float, default=0.0)
    ap.add_argument("--fp32", action="store_true", help="float32 network (default bf16)")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--out", default="runs/ssl_driving_torch")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ckpt_dir = os.path.join(args.out, "ckpts")
    os.makedirs(args.out, exist_ok=True)
    train_ds = SyntheticDriving(n=args.n_scenes, target_size=(args.width, args.height), seed=0)
    val_ds = SyntheticDriving(n=args.n_val, target_size=(args.width, args.height), seed=9999)
    steps_per_epoch = len(train_ds) // args.batch_size
    cfg = TrainConfig(
        target_size=(args.width, args.height), batch_size=args.batch_size, lr=args.lr, seed=args.seed,
        grad_clip=args.grad_clip, lr_warmup_steps=args.lr_warmup, lr_decay_steps=args.lr_decay_steps,
        lr_decay_factor=args.lr_decay_factor, disparity_smoothness=args.smoothness,
        min_depth=args.min_depth, max_depth=args.max_depth, disp_reg=args.disp_reg,
        disp_reg_steps=args.disp_reg_steps, pose_tz_init=args.pose_tz_init,
        compute_dtype="float32" if args.fp32 else "bfloat16", steps_per_call=STEPS_PER_CALL,
        epochs=math.ceil(args.steps / steps_per_epoch) + 1, log_every=args.eval_every, save_every=0,
        save_dir=ckpt_dir, log_dir=os.path.join(args.out, "logs"),
    )

    # ---- the val harness: targets, GT depth, GT target→source poses
    val_frames = np.stack([val_ds[i] for i in range(len(val_ds))])  # (V,3,H,W,C)
    val_targets = val_frames[:, val_ds.target_id]
    val_gt = np.stack([val_ds.gt_depth_for(i) for i in range(len(val_ds))])
    val_gt_poses = [val_ds.gt_poses_for(i) for i in range(len(val_ds))]

    def evaluate(model) -> dict:
        disp = make_infer_fn(model, "float32")(val_targets).cpu().numpy()
        # the network's depth; median scaling absorbs the monocular scale
        pred = 1.0 / (disp * (1.0 / cfg.min_depth - 1.0 / cfg.max_depth) + 1.0 / cfg.max_depth)
        ms = [depth_metrics(pred[i], val_gt[i], max_depth=80.0) for i in range(len(pred))]
        return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}

    def pose_errors(model):
        """Mean rotation geodesic error and translation-direction angle (deg)
        over the val scenes and both sources, the predicted target→source
        transforms composed as the training warp composes them."""
        model.eval()
        with torch.inference_mode():
            frames = torch.from_numpy(val_frames).to(device)
            _, poses = model(frames, val_ds.source_ids, val_ds.target_id)
            pred = [
                [t.float().cpu().numpy() for t in compose_transform(
                    rvec.float(), tvec.float(), invert=sid < val_ds.target_id)]
                for sid, (rvec, tvec) in zip(val_ds.source_ids, poses)
            ]
        rot, tdir = [], []
        for s, (R_p, t_p) in enumerate(pred):
            for i in range(len(val_ds)):
                R_g, t_g = val_gt_poses[i][s]
                cosang = (np.trace(R_p[i] @ R_g.T) - 1.0) / 2.0
                rot.append(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))
                tp, tg = t_p[i].ravel(), np.asarray(t_g).ravel()
                denom = np.linalg.norm(tp) * np.linalg.norm(tg)
                if denom > 1e-12:
                    tdir.append(np.degrees(np.arccos(np.clip(float(tp @ tg) / denom, -1.0, 1.0))))
        return float(np.mean(rot)), float(np.mean(tdir)) if tdir else float("nan")

    const = {
        k: float(np.mean([depth_metrics(np.ones_like(g), g, max_depth=80.0)[k] for g in val_gt]))
        for k in ("abs_rel", "a1", "rmse")
    }
    print(json.dumps({"baseline_constant_disparity": const}), flush=True)

    history_path = os.path.join(args.out, "history.json")
    history = []
    if os.path.exists(history_path):
        with open(history_path) as f:
            history = json.load(f)
    ck = latest_checkpoint(ckpt_dir)
    done = int(ck.rsplit("-", 1)[1]) if ck is not None else 0
    # drop rows past the resumed step (a run killed after its row and before
    # its checkpoint)
    history = [r for r in history if r["step"] <= done]
    resumed_at = done
    if ck is not None:
        print(f"resuming from {ck} at step {done}", flush=True)

    t0 = time.time()
    while done < args.steps:
        target = min(args.steps, (done // args.eval_every + 1) * args.eval_every)
        state, model = fit(cfg, train_ds, max_steps=target, verbose=False, device=device)
        done = state.step
        logged = {}
        metrics_path = os.path.join(cfg.log_dir, "metrics.jsonl")
        if os.path.exists(metrics_path):
            with open(metrics_path) as f:
                lines = [json.loads(line) for line in f]
            if lines:
                logged = lines[-1]
        m = evaluate(model)
        rot_err, tdir_err = pose_errors(model)
        rec = {
            "step": done, "loss": logged.get("loss"), "loss_step": logged.get("step"),
            "mean_disparity": logged.get("mean_disparity"), "val_abs_rel": m["abs_rel"], "val_a1": m["a1"],
            "val_rmse": m["rmse"], "scale": m["scale"], "rot_err_deg": rot_err, "t_dir_err_deg": tdir_err,
            "elapsed_s": time.time() - t0,
        }
        # fit saved ckpt-<done> before this row: a kill between the two leaves
        # a checkpoint without its row, never a row ahead of the checkpoints
        history.append(rec)
        with open(history_path, "w") as f:
            json.dump(history, f, indent=1)
        print(json.dumps(rec), flush=True)
        _prune(ckpt_dir)
    final = history[-1] if history else {}
    print(json.dumps({"done": done, "val_abs_rel": final.get("val_abs_rel"),
                      "baseline_abs_rel": const["abs_rel"]}), flush=True)
    return dict(history=history, baseline=const, resumed_at=resumed_at, step=done, history_path=history_path)


if __name__ == "__main__":
    main()
