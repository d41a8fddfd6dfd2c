"""One rank of the port's data-parallel training, run as its own process.

    python -m monodepth2_torch.tools.dp_worker fit --out DIR --world-size 2 --rank R --port P [--device cpu]
    python -m monodepth2_torch.tools.dp_worker steps --inputs IN.pt --results OUT.pt --world-size 2 --rank R --port P

The counterpart of the JAX package's multi-process test worker: each process
joins a process group over localhost:PORT (gloo on the CPU, NCCL on the
card, or --backend), builds the mesh and runs one rank of

  fit    `training.loop.fit` on a mesh: SyntheticTriplets (n=16), steps_per_call
         2, 4 steps, optionally with per-item intrinsics (--per-item-k, two
         calibrations alternating over the global index) and in float64
         (--dtype float64; on the card with --warp-method gather, since the
         kernels take fp32). Each rank is given its own log and checkpoint
         directories (logs-p<R>, ckpt-p<R>); fit writes in rank 0's only.
         Reports a sha256 of the final state (params, BN statistics, Adam's
         moments and steps); --save-reference writes the final params and
         statistics to an .npz, --reference reports the largest difference
         from such a file, per leaf over the leaf's largest entry.
         --check-desync then calls fit again with resume: rank 0 finds its
         checkpoint and the others find none, and every rank must raise
         "resume desync".
  steps  the data-parallel steps from the weights and global batches of an
         input file (torch.save of {"state_dict", "cfg", "K", "cases"}):
         for each case a fresh state, this rank's rows (`shard_batch`), and
         make_parallel_train_step ("gspmd"), make_shardmap_train_step
         ("shardmap") or make_parallel_scanned_train_step ("scanned", against
         as many single GSPMD steps from the same state). Reports a sha256 of
         each case's grads, state and metrics; rank 0 writes the values of the
         "gspmd" and "shardmap" cases to --results (a path, or - for its
         standard output, the report then going to standard error).

Without --port it reads the launcher's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), so `torchrun --nproc-per-node N
-m monodepth2_torch.tools.dp_worker fit --out DIR` runs N ranks; with
neither, the single-process mesh that make_mesh sets up by itself. Reports one JSON line with its rank, and exits
nonzero on any failure. It imports torch and the port only.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch


class HeteroK:
    """A dataset with per-item intrinsics: global items alternate between two
    calibrations, keyed on the global index, so every process layout sees
    the same (frames, K) pairs."""

    supports_item_K = True

    def __init__(self, base):
        self.base = base
        self.K, self.invK = np.asarray(base.K), np.asarray(base.invK)
        self.target_id, self.source_ids = base.target_id, base.source_ids

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i, rng=None):
        return self.base.__getitem__(i, rng)

    def K_of(self, i):
        K = self.K.copy()
        if i % 2:
            K[0, 0] *= 0.7
            K[1, 1] *= 0.7
        return K.astype(np.float32)


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    """sha256 of the whole train state: params, buffers, Adam's state."""
    adam = [v for p in state.model.parameters() for v in state.optimizer.state[p].values()]
    return digest([*state.model.state_dict().values(), *adam])


MAX_STEPS = 4


def fit_config(args, pid: int):
    from ..training import TrainConfig

    return TrainConfig(
        target_size=(64, 32), batch_size=4, scale_levels=(5,), epochs=4, seed=7,
        steps_per_call=2, log_every=1, save_every=0, per_item_K=args.per_item_k,
        warp_method=args.warp_method,
        log_dir=os.path.join(args.out, f"logs-p{pid}"), save_dir=os.path.join(args.out, f"ckpt-p{pid}"),
    )


def run_fit(args, mesh) -> dict:
    from ..data import SyntheticTriplets
    from ..training.loop import fit

    cfg = fit_config(args, mesh.rank)
    dataset = SyntheticTriplets(n=16, target_size=cfg.target_size, channels=1)
    if args.per_item_k:
        dataset = HeteroK(dataset)
    state, _ = fit(cfg, dataset, mesh=mesh, resume=False, verbose=False, max_steps=MAX_STEPS,
                   device=mesh.device)
    out = {"step": state.step, "state_sha256": state_digest(state)}
    values = {k: v.detach().cpu().numpy() for k, v in state.model.state_dict().items()}
    if args.save_reference:
        np.savez(args.save_reference.format(rank=mesh.rank), **values)
    if args.reference:
        with np.load(args.reference) as ref:
            errs = {k: float(np.abs(values[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-300))
                    for k in ref.files if ref[k].dtype.kind == "f"}
            out["ints_equal"] = all(np.array_equal(values[k], ref[k]) for k in ref.files if ref[k].dtype.kind != "f")
        worst = max(errs, key=errs.get)
        out["reference_worst"] = [worst, errs[worst]]
    if args.check_desync:
        try:
            fit(cfg, dataset, mesh=mesh, resume=True, verbose=False, max_steps=MAX_STEPS + 2,
                device=mesh.device)
            out["desync"] = None
        except RuntimeError as e:
            out["desync"] = str(e)
    return out


def run_steps(args, mesh) -> dict:
    from ..models import create_model
    from ..parallel import (
        make_parallel_scanned_train_step,
        make_parallel_train_step,
        make_shardmap_train_step,
        shard_batch,
    )
    from ..training import TrainConfig, TrainContext, create_train_state

    inputs = torch.load(args.inputs, weights_only=False)
    cfg = TrainConfig(**inputs["cfg"])
    dtype = torch.get_default_dtype()
    ctx = TrainContext.create(inputs["K"], cfg.width, cfg.height, dtype=dtype, device=mesh.device)

    def fresh():
        state = create_train_state(create_model(cfg, device=mesh.device), cfg)
        state.model.load_state_dict(inputs["state_dict"])
        return state

    def values(state, metrics):
        return {
            "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters() if p.grad is not None},
            "state_dict": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
            "step": state.step,
        }

    def digests(v):
        return {"grads": digest(v["grads"].values()), "state": digest(v["state_dict"].values()),
                "metrics": digest(v["metrics"].values()), "loss": v["metrics"]["loss"].tolist(), "step": v["step"]}

    results, report = {}, {}
    for case in inputs["cases"]:
        name, kind, batch = case["name"], case["kind"], case["batch"]
        if kind == "scanned":
            scanned = make_parallel_scanned_train_step(ctx, cfg, mesh)
            state, metrics, _ = scanned(fresh(), shard_batch(batch, mesh, stacked=True))
            single = make_parallel_train_step(ctx, cfg, mesh)
            twin, rows = fresh(), []
            for i in range(len(batch["frames"] if isinstance(batch, dict) else batch)):
                micro = {k: v[i] for k, v in batch.items()} if isinstance(batch, dict) else batch[i]
                twin, m, _ = single(twin, shard_batch(micro, mesh))
                rows.append(m)
            report[name] = {"scanned": digests(values(state, metrics)),
                            "singles": digests(values(twin, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}))}
            continue
        make = {"gspmd": make_parallel_train_step, "shardmap": make_shardmap_train_step}[kind]
        state, metrics, _ = make(ctx, cfg, mesh)(fresh(), shard_batch(batch, mesh))
        results[name] = values(state, metrics)
        report[name] = digests(results[name])
    if mesh.rank == 0 and args.results:
        if args.results == "-":
            torch.save(results, sys.stdout.buffer)
            sys.stdout.buffer.flush()
        else:
            torch.save(results, args.results)
    return {"cases": report}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("fit", "steps"))
    ap.add_argument("--out", default=None, help="fit mode: the directory of each rank's logs and checkpoints")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=None,
                    help="localhost port of rank 0's store; none: the launcher's environment, else a group of one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--inputs", default=None, help="steps mode: the torch.save'd weights, config and batches")
    ap.add_argument("--per-item-k", action="store_true")
    ap.add_argument("--warp-method", default=None, help="fit mode: the config's warp_method (gather: the plain warp)")
    ap.add_argument("--check-desync", action="store_true")
    ap.add_argument("--save-reference", default=None,
                    help="fit mode: write the final params and statistics here ({rank}: this rank's number)")
    ap.add_argument("--reference", default=None, help="fit mode: compare the final params and statistics")
    ap.add_argument("--results", default=None, help="steps mode: rank 0 writes the cases' values here (- : stdout)")
    args = ap.parse_args(argv)

    from ..parallel import make_mesh
    from ..parallel.distributed import initialize_distributed, initialize_single_process

    torch.set_default_dtype(getattr(torch, args.dtype))
    if args.mode == "fit":
        if not args.out:
            raise SystemExit("fit mode needs --out")
        os.makedirs(args.out, exist_ok=True)
    if args.port is not None:
        initialize_distributed(f"localhost:{args.port}", args.world_size, args.rank, device=args.device,
                               backend=args.backend)
    elif not initialize_distributed(device=args.device, backend=args.backend):  # torchrun's environment
        if args.world_size != 1:
            raise SystemExit("more than one rank needs --port or the launcher's environment")
        initialize_single_process(args.device, backend=args.backend)
    mesh = make_mesh(device=args.device)
    try:
        out = (run_fit if args.mode == "fit" else run_steps)(args, mesh)
    finally:
        torch.distributed.destroy_process_group()
    out = {"done": True, "rank": mesh.rank, "world_size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device), **out}
    print(json.dumps(out), file=sys.stderr if args.results == "-" else sys.stdout, flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
