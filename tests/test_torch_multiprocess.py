"""The port's multi-process training, really in several processes (the
analog of tests/test_multiprocess.py, run in tier-1).

Two gloo processes each run one rank of `training.loop.fit` on a mesh
(tools/dp_worker.py, which imports no jax): PerHostSampler's global shuffle,
each process's DataLoader over its own rows, steps_per_call 2 groups and the
GSPMD-semantics scanned step, 4 steps of ResNet-18 at 64×32 on a global
batch of 4, in float64. Both ranks must end with the same state, bitwise,
equal within 1e-9 of each leaf's largest entry (params and BatchNorm
statistics) to a 1-process fit on the single-process mesh of the same global
batch (the order of the sums differs; measured ~1e-11), with and without
per-item intrinsics. Only rank 0 writes
checkpoints, metrics.jsonl and PNGs; a second fit that resumes with a save
directory each rank sees alone (rank 0's has checkpoints, rank 1's none)
raises "resume desync" on every rank. The per-item-K pod's ranks read their
configuration from the launcher's environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK), as under torchrun; the other's from flags."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-9  # of each leaf's largest entry


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(out: Path, world: int, extra=(), launcher_env: bool = False) -> list:
    """Start `world` ranks of dp_worker fit (world 1: the single-process mesh,
    no port). launcher_env: configure the ranks as torchrun does, through
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, not flags."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                                            "LOCAL_RANK")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    port = str(free_port())
    procs = []
    for r in range(world):
        if world == 1:
            flags, rank_env = [], {}
        elif launcher_env:
            flags = []
            rank_env = dict(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(r),
                            LOCAL_RANK=str(r))
        else:
            flags, rank_env = ["--world-size", str(world), "--rank", str(r), "--port", port], {}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "monodepth2_torch.tools.dp_worker", "fit", "--out", str(out), "--device", "cpu",
             "--dtype", "float64", *flags, *extra],
            env={**env, **rank_env}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return procs


def _wait(procs) -> list:
    try:
        logs = [p.communicate(timeout=1200)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Each configuration as 1 process, whose final params and statistics
    are the reference, then as 2; what the tests read is kept, and the
    checkpoints (390 MB each in float64) are deleted."""
    tmp = tmp_path_factory.mktemp("mp")
    out = {}
    for per_item_k in (False, True):
        extra = ["--per-item-k"] if per_item_k else []
        sp, mp, ref = tmp / f"sp-{per_item_k}", tmp / f"mp-{per_item_k}", tmp / f"ref-{per_item_k}.npz"
        (single,) = _wait(_launch(sp, 1, extra + ["--save-reference", str(ref)]))
        # the per-item-K pod is configured as torchrun configures its ranks
        reports = _wait(_launch(mp, 2, extra + ["--reference", str(ref), "--check-desync"], launcher_env=per_item_k))
        out[per_item_k] = dict(
            single=single, reports=reports,
            files={d: sorted(str(f.relative_to(d)) for f in d.rglob("*") if f.is_file()) for d in (sp, mp)},
            logged=[[json.loads(line) for line in open(d / "logs-p0" / "metrics.jsonl")] for d in (mp, sp)],
            sp=sp, mp=mp,
        )
        for f in [ref, *sp.rglob("*.npz"), *mp.rglob("*.npz")]:
            f.unlink()
    return out


@pytest.mark.parametrize("per_item_k", [False, True])
def test_two_process_fit_matches_single_process(pods, per_item_k):
    run = pods[per_item_k]
    reports = run["reports"]
    assert [r["step"] for r in reports] == [4, 4] and [r["rank"] for r in reports] == [0, 1]
    assert all(r["world_size"] == 2 and r["backend"] == "gloo" for r in reports)
    assert run["single"]["world_size"] == 1 and run["single"]["step"] == 4
    # both ranks hold the same state (params, statistics, Adam's), bitwise
    assert reports[0]["state_sha256"] == reports[1]["state_sha256"]
    for r in reports:
        leaf, err = r["reference_worst"]
        assert err <= TOL and r["ints_equal"], (leaf, err)
    # the logged losses too, at the same steps
    mp_log, sp_log = run["logged"]
    assert [r["step"] for r in mp_log] == [r["step"] for r in sp_log] == [2, 4]
    for a, b in zip(mp_log, sp_log):
        assert abs(a["loss"] - b["loss"]) <= 1e-12 * abs(b["loss"])


@pytest.mark.parametrize("per_item_k", [False, True])
def test_only_rank_0_writes(pods, per_item_k):
    run = pods[per_item_k]
    files = run["files"][run["mp"]]
    assert "ckpt-p0/ckpt-4.npz" in files and "logs-p0/metrics.jsonl" in files and "logs-p0/disp-4.png" in files
    assert not [f for f in files if f.startswith(("ckpt-p1", "logs-p1"))], files


@pytest.mark.parametrize("per_item_k", [False, True])
def test_unshared_save_dirs_raise_resume_desync(pods, per_item_k):
    for r in pods[per_item_k]["reports"]:
        assert r["desync"] is not None and r["desync"].startswith("resume desync"), r
        assert "[4, 0]" in r["desync"]
