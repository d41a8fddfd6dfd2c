"""Epoch training loop, port of monodepth2_tpu/training/loop.py
(reference: train(), src/Monodepth.jl:70-199).

Resumable (the full state checkpointed at the save cadence, the epoch
position recovered from the step), a durable metrics.jsonl, disparity and
warp PNGs at the log cadence, the input copied to the card ahead of use
(data.device_prefetch), and `steps_per_call` steps a call of the scanned
step, which on the card replays one captured CUDA graph. Over a mesh
(parallel.make_mesh: the process group's ranks, one card each) every
process runs `fit` on its own rows of each global batch, as the JAX loop's
mesh and multi-process branches do (loop.py:177-304, :340-366). The JAX
loop's retrace tripwire (`jit_trace_count`) and its cache of jitted steps
have no counterpart, since nothing here is traced or compiled.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import DataLoader, device_prefetch
from ..device import resolve_device
from ..models import create_model
from ..parallel import Mesh, PerHostSampler, make_parallel_scanned_train_step, make_parallel_train_step
from ..utils.profiler import span
from ..utils.viz import save_disparity, save_warped
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .config import TrainConfig, TrainContext
from .state import create_train_state, make_scanned_train_step, make_train_step


def _group_batches(iterator, k: int):
    """Stack k consecutive host batches into (k, N, ...) steps_per_call
    groups; a smaller tail group is emitted as-is. Batches may be arrays or
    {"frames", "K"} per-item-K batches, stacked leaf-wise."""

    def stack(bufs):
        if isinstance(bufs[0], dict):
            return {key: np.stack([b[key] for b in bufs]) for key in bufs[0]}
        return np.stack(bufs)

    buf = []
    for b in iterator:
        buf.append({k_: np.asarray(v) for k_, v in b.items()} if isinstance(b, dict) else np.asarray(b))
        if len(buf) == k:
            with span("feed.stack"):
                group = stack(buf)
            yield group
            buf = []
    if buf:
        with span("feed.stack"):
            group = stack(buf)
        yield group


def _batch_frames(batch):
    """The frames leaf of an array-or-{"frames","K"} batch."""
    return batch["frames"] if isinstance(batch, dict) else batch


def _crossed(every: int, step: int, k: int) -> bool:
    """Did [step-k, step] cross a multiple of `every`? (steps_per_call can
    jump the counter past exact multiples.)"""
    return bool(every) and (step // every) > ((step - k) // every)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


_RESUME_SEQ = 0


def _agree_on_resume(step: int, mesh, save_dir: str) -> None:
    """Every process publishes the step it resumed at through the process
    group's store (TCP key-value), reads every other's, and raises on any
    disagreement. Only rank 0 writes checkpoints, but every process reads
    latest_checkpoint(save_dir): without a filesystem they all see, the
    others would start at step 0 while rank 0 resumes, and their data
    cursors would part with no error (loop.py:184-210). All ranks raise, so
    none is left waiting in a collective."""
    global _RESUME_SEQ
    _RESUME_SEQ += 1  # the same on every process: the same sequence of calls
    store = dist.distributed_c10d._get_default_store()
    key = f"fit_resume_step_{_RESUME_SEQ}"
    store.set(f"{key}/{mesh.rank}", str(step))
    steps = [int(store.get(f"{key}/{r}")) for r in range(mesh.size)]
    if any(s != steps[0] for s in steps):
        raise RuntimeError(
            f"resume desync: process {mesh.rank} resumed at step {step} but the processes resumed at "
            f"{steps} (rank order) — save_dir ({save_dir}) must be a shared filesystem visible to every process"
        )


def fit(
    cfg: TrainConfig,
    dataset,
    K: Optional[np.ndarray] = None,
    mesh=None,
    resume: bool = True,
    verbose: bool = True,
    max_steps: Optional[int] = None,
    progress: bool = False,
    device: str | torch.device = "cuda",
):
    """Train on `dataset` (items (3,H,W,C)); returns (state, model).

    K defaults to dataset.K. Runs on the card unless device="cpu"; without
    a card, or when the kernels do not build, it raises. The state's
    dtype is torch's default dtype (float32 unless the caller sets another).

    mesh=None trains one process on one device. A parallel.Mesh makes this
    process one rank of GSPMD-semantics data parallelism: the mesh has one
    rank per process and one card per rank (a 1×N JAX mesh is N processes,
    launched e.g. by `torchrun --nproc-per-node N`), runs on the mesh's
    device (`device` must be of its type), and cfg.batch_size is the global
    batch. Each process loads only its rows of every global batch through
    a PerHostSampler, which owns the global shuffle (also on a
    one-process mesh, so that any process layout sees the same data); the
    ranks agree on the resumed step through the process group's store;
    only rank 0 writes checkpoints, metrics.jsonl and PNGs; and the ranks
    meet at a barrier once the step is built, before the first real step.
    """
    if K is None:
        K = getattr(dataset, "K", None)
        if K is None:
            raise ValueError(
                "fit() needs camera intrinsics: pass K= or use a dataset "
                "exposing .K (KittiDataset/Depth10k/DChain all do)"
            )
    # frame-layout consistency: both sides are configurable, so a mismatch
    # must be caught, not trained through
    ds_target = getattr(dataset, "target_id", None)
    ds_sources = getattr(dataset, "source_ids", None)
    if ds_target is not None and ds_target != cfg.target_id:
        raise ValueError(f"dataset target_id {ds_target} != cfg.target_id {cfg.target_id}")
    if ds_sources is not None and tuple(ds_sources) != tuple(cfg.source_ids):
        raise ValueError(
            f"dataset source_ids {tuple(ds_sources)} != cfg.source_ids {tuple(cfg.source_ids)}"
        )
    device = resolve_device(device)
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"fit(mesh=...) takes a parallel.Mesh (parallel.make_mesh()), got {type(mesh).__name__}")
        if device.type != mesh.device.type:
            raise ValueError(f"fit(device={device}) over a mesh on {mesh.device}")
        device = mesh.device
    dtype = torch.get_default_dtype()
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    ctx = TrainContext.create(np.asarray(K), cfg.width, cfg.height, dtype=dtype, device=device)
    model = create_model(cfg, device=device)
    state = create_train_state(model, cfg)

    start_epoch = 0
    if resume:
        ck = latest_checkpoint(cfg.save_dir)
        if ck is not None:
            load_checkpoint(ck, state)
            if verbose:
                print(f"resumed from {ck} at step {state.step}")
    if mesh is not None:
        _agree_on_resume(state.step, mesh, cfg.save_dir)
    # only rank 0 writes shared artifacts (checkpoints, metrics.jsonl, PNGs):
    # the state is the same on every rank, and writers on a shared
    # filesystem would collide on the same temporary checkpoint path
    is_writer = mesh is None or mesh.rank == 0
    spc = max(1, int(cfg.steps_per_call))
    if mesh is not None:
        step = (make_parallel_scanned_train_step if spc > 1 else make_parallel_train_step)(ctx, cfg, mesh)
        # each process loads only its rows of every global batch; the sampler
        # owns the global shuffle, the same on every process
        sampler = PerHostSampler(dataset, cfg.batch_size, seed=cfg.seed, process_id=mesh.rank,
                                 num_processes=mesh.size)
        loader = DataLoader(sampler, sampler.per_host, shuffle=False, seed=cfg.seed, with_K=cfg.per_item_K)
    else:
        step = make_scanned_train_step(ctx, cfg) if spc > 1 else make_train_step(ctx, cfg)
        sampler = None
        loader = DataLoader(dataset, cfg.batch_size, shuffle=True, seed=cfg.seed, with_K=cfg.per_item_K)
    steps_per_epoch = len(loader)
    if mesh is not None:
        # the ranks start their first step together, whatever each one's
        # set-up took (the JAX loop's compile barrier, loop.py:239-303); the
        # capture of the scanned step happens in its first call, where the
        # warm-up steps' collectives keep the ranks in step
        dist.barrier(device_ids=[device.index] if mesh.backend == "nccl" else None)

    if is_writer:
        os.makedirs(cfg.log_dir, exist_ok=True)
        os.makedirs(cfg.save_dir, exist_ok=True)

    # debug_nans: the steps check each loss (training/state.py) and autograd's
    # anomaly mode checks the backward, a global switch set for this fit()
    # only and restored on every exit, the FloatingPointError included
    prev_anomaly = None
    if cfg.debug_nans:
        prev_anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
    try:
        # epoch-position resume: the shuffle is a pure function of (seed,
        # epoch) and step counts batches, so (epoch, batch cursor) follows
        # from the step alone
        resumed_step = state.step
        if resumed_step and steps_per_epoch:
            start_epoch = resumed_step // steps_per_epoch
            loader.epoch = start_epoch
            loader.skip_next = resumed_step % steps_per_epoch
        host_step = resumed_step
        # img_per_sec: the images of the steps between two log points over
        # the host time between the loss reads there, each of which waits for
        # the card; the first interval starts here
        synced_at, synced_step = time.perf_counter(), resumed_step
        # a fit() resumed at or past max_steps trains nothing
        done = max_steps is not None and resumed_step >= max_steps
        for epoch in range(start_epoch, cfg.epochs):
            if done:
                break
            if sampler is not None:
                sampler.set_epoch(epoch)
            src = iter(loader)
            if spc > 1:
                src = _group_batches(src, spc)
            batches = device_prefetch(src, size=2, device=device, dtype=np_dtype)
            if progress:
                from tqdm import tqdm

                # the first epoch after a mid-epoch resume yields only the
                # un-skipped remainder
                ep_batches = steps_per_epoch
                if epoch == start_epoch and resumed_step and steps_per_epoch:
                    ep_batches -= resumed_step % steps_per_epoch
                batches = tqdm(
                    batches, total=-(-ep_batches // spc), desc=f"epoch {epoch + 1}/{cfg.epochs}", leave=False,
                )
            for batch in batches:
                state, metrics, aux = step(state, batch)
                # micro-steps this call (tail groups may be short)
                k_done = int(_batch_frames(batch).shape[0]) if spc > 1 else 1
                host_step += k_done
                global_step = host_step  # == state.step

                if _crossed(cfg.log_every, global_step, k_done):
                    # the loss of the micro-step that crossed the log_every
                    # multiple, at its own step index
                    log_step = (global_step // cfg.log_every) * cfg.log_every
                    off = k_done - 1 - (global_step - log_step)
                    if spc > 1 and 0 <= off < k_done:
                        loss = float(metrics["loss"][off])
                        mean_disp = float(metrics["mean_disparity"][off])
                    else:
                        log_step = global_step
                        loss = float(metrics["loss"][-1] if spc > 1 else metrics["loss"])
                        mean_disp = float(
                            metrics["mean_disparity"][-1] if spc > 1 else metrics["mean_disparity"]
                        )
                    now = time.perf_counter()
                    ips = cfg.batch_size * (global_step - synced_step) / (now - synced_at)
                    synced_at, synced_step = now, global_step
                    if is_writer:
                        with open(os.path.join(cfg.log_dir, "metrics.jsonl"), "a") as mf:
                            mf.write(json.dumps({
                                "step": log_step, "epoch": epoch, "loss": loss,
                                "mean_disparity": mean_disp,
                                "img_per_sec": round(ips, 1), "ts": time.time(),
                            }) + "\n")
                    if progress and hasattr(batches, "set_postfix"):
                        batches.set_postfix(loss=f"{loss:.4f}", ips=f"{ips:.0f}")
                    if verbose and not progress:
                        print(f"epoch {epoch + 1}/{cfg.epochs} step {global_step} loss {loss:.5f} {ips:.1f} img/s")
                    if is_writer:
                        save_disparity(
                            _host(aux["disparity"][0, ..., 0]),
                            os.path.join(cfg.log_dir, f"disp-{global_step}.png"),
                        )
                        for sid, w in enumerate(aux["warped"]):
                            save_warped(_host(w[0]), os.path.join(cfg.log_dir, f"warp-{global_step}-{sid}.png"))

                if _crossed(cfg.save_every, global_step, k_done) and is_writer:
                    last_loss = float(metrics["loss"][-1] if spc > 1 else metrics["loss"])
                    save_checkpoint(
                        os.path.join(cfg.save_dir, f"ckpt-{global_step}"),
                        state,
                        metadata={"step": global_step, "loss": last_loss, "config": cfg.to_json()},
                    )

                if max_steps is not None and global_step >= max_steps:
                    done = True
                    break
    finally:
        if prev_anomaly is not None:
            torch.autograd.set_detect_anomaly(prev_anomaly)

    if is_writer:
        save_checkpoint(
            os.path.join(cfg.save_dir, f"ckpt-{state.step}"),
            state,
            metadata={"step": state.step, "config": cfg.to_json()},
        )
    return state, model
