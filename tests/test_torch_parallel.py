"""monodepth2_torch.parallel against monodepth2_tpu.parallel (the analog of
tests/test_parallel.py).

The port's data-parallel steps run as 2 gloo ranks, each its own process
(tools/dp_worker.py, which imports no jax), in float64 from the JAX
package's initial weights (through `bridge`), on the global batch of 4 at
64×32 (ResNet-18); the reference is the JAX step of the same name on a
2-device CPU mesh (make_mesh(2) of the conftest's 8), jitted once a case.
Held within 1e-7 of each leaf's largest entry: the gradients (the JAX side's
from its Adam moment after the step, mu / (1 - b1)), the new params, the
BatchNorm running statistics and the loss — GSPMD semantics (global-batch
BatchNorm) and shard_map semantics (per-rank BatchNorm, pmean of the
gradients, running statistics and loss), each with and without per-item K.
Single-device float64 parity reaches 5e-8 of each leaf's max
(tests/test_torch_training.py). The JAX BatchNorm rounds the batch moments
to float32 and takes `m * moment` in float32 (nn/core.py:146-147: the Python
momentum is weakly typed), so each running statistic is held to 1e-7 of its
leaf's max plus two float32 roundings of that term, 2^-23·|m·moment| an
element (measured: 9.9e-8 of the max without that allowance).

Also: the scanned step against as many single steps, the divisibility
check, initialize_distributed's no-op and its refusals, PerHostSampler
against the JAX sampler (indices and augmentation draws, 2 processes × 2
epochs), shard_host_batch against shard_batch in one process, the
single-process mesh's step against the plain step, and the global-batch
BatchNorm hook against the plain layer."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth2_tpu.models import Model as JModel
from monodepth2_tpu.parallel import make_mesh as j_make_mesh
from monodepth2_tpu.parallel import make_parallel_train_step as j_parallel_step
from monodepth2_tpu.parallel import make_shardmap_train_step as j_shardmap_step
from monodepth2_tpu.parallel import shard_batch as j_shard_batch
from monodepth2_tpu.training import TrainConfig as JConfig
from monodepth2_tpu.training import TrainContext as JContext
from monodepth2_tpu.training import create_train_state as j_create
from monodepth2_torch.bridge import params_from_jax
from monodepth2_torch.nn.core import BatchNorm, global_batch_stats
from monodepth2_torch.parallel import (
    Mesh,
    PerHostSampler,
    initialize_distributed,
    local_batch_slice,
    make_parallel_scanned_train_step,
    make_parallel_train_step,
    make_shardmap_train_step,
    process_info,
    shard_batch,
    shard_host_batch,
)
from monodepth2_torch.training import TrainConfig, TrainContext

ROOT = Path(__file__).resolve().parent.parent
W, H, N = 64, 32, 4
KW = dict(target_size=(W, H), batch_size=N, in_channels=1, lr=1e-4, warp_method="gather")
K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])
TOL = 1e-7  # of each leaf's largest entry
B1 = 0.9  # optax.adam's b1: after one step from zero, mu = (1 - b1) * grad
CASES = [(kind, per_item_K) for kind in ("gspmd", "shardmap") for per_item_K in (False, True)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, which torch's default of one thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(args, world: int = 2, timeout: int = 900):
    """`python -m monodepth2_torch.tools.dp_worker <args> --results -` as
    `world` gloo ranks on the CPU: (rank 0's standard output, the values it
    wrote there, as bytes; each rank's JSON report from its standard error).
    The values go through a pipe, not a file: ResNet-18's grads and state
    in float64 are 260 MB a case."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "monodepth2_torch.tools.dp_worker", *args, "--results", "-", "--device", "cpu",
             "--world-size", str(world), "--rank", str(r), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-4000:]
    return outs[0][0], [json.loads(err.decode().strip().splitlines()[-1]) for _, err in outs]


def _batch(per_item_K: bool, seed: int = 0, lead=()):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(size=(*lead, N, 3, H, W, 1)).astype(np.float32).astype(np.float64)
    if not per_item_K:
        return frames
    Ks = np.stack([K * [[1.0 + 0.1 * i], [1.0 - 0.05 * i], [1.0]] for i in range(N)])
    return {"frames": frames, "K": np.broadcast_to(Ks, (*lead, N, 3, 3)).copy()}


def _port_layout(params, stats=None) -> dict:
    """JAX (params, stats) trees -> float64 arrays under the port's
    state_dict names (HWIO -> OIHW), as bridge.params_from_jax lays them out
    without its float32 cast."""
    out = {}

    def walk(p, s, prefix):
        if "w" in p:
            out[prefix + "weight"] = np.asarray(p["w"], np.float64).transpose(3, 2, 0, 1)
            if "b" in p:
                out[prefix + "bias"] = np.asarray(p["b"], np.float64)
        elif "scale" in p:
            out[prefix + "weight"] = np.asarray(p["scale"], np.float64)
            out[prefix + "bias"] = np.asarray(p["bias"], np.float64)
            if s:
                out[prefix + "running_mean"] = np.asarray(s["mean"], np.float64)
                out[prefix + "running_var"] = np.asarray(s["var"], np.float64)
        else:
            for key in p:
                walk(p[key], (s or {}).get(key, {}), f"{prefix}{key}.")

    walk(params, stats, "")
    return out


def _jax_rounding(key: str, ref: np.ndarray) -> np.ndarray:
    """The JAX side's float32 rounding of a running statistic after one step:
    two roundings (the moment's cast, the product) of m·moment, which is the
    statistic less (1 - m) times its initial value (mean 0, var 1)."""
    if "running" not in key:
        return np.zeros_like(ref)
    return 2.0 ** -23 * np.abs(ref - 0.9 * (1.0 if key.endswith("running_var") else 0.0))


def _close(got: dict, ref: dict, what: str, rel_of_max: float = TOL) -> float:
    """Each leaf within rel_of_max of its largest entry (plus the JAX side's
    float32 rounding of a running statistic); returns the worst excess over
    that allowance as a share of the leaf's max, plus rel_of_max."""
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    worst = 0.0
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        scale = max(np.abs(r).max(), 1e-300)
        err = float((np.abs(g - r) - _jax_rounding(k, r)).max() / scale)
        assert err <= rel_of_max, (what, k, err)
        worst = max(worst, err)
    return worst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case, once: the JAX steps on a 2-device mesh and
    the port's 2 ranks in one launch."""
    tmp = tmp_path_factory.mktemp("dp")
    jm = JModel.create(depth=18, in_channels=1)
    cfg = JConfig(**KW)
    state, tx = j_create(jm, cfg)
    init = (jax.device_get(state.params), jax.device_get(state.stats))
    cast = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), t)
    state = state._replace(params=cast(state.params), stats=cast(state.stats),
                           opt_state=tx.init(cast(state.params)))
    ctx = JContext.create(K, W, H, dtype=jnp.float64)
    mesh = j_make_mesh(2)
    jax_out = {}
    for kind, per_item_K in CASES:
        make = j_parallel_step if kind == "gspmd" else j_shardmap_step
        step = make(jm, tx, ctx, cfg, mesh, donate=False) if kind == "gspmd" else make(jm, tx, ctx, cfg, mesh)
        batch = jax.tree_util.tree_map(jnp.asarray, _batch(per_item_K))
        # the shard_map step donates its state: give it a copy
        new, metrics, _ = step(jax.tree_util.tree_map(jnp.copy, state), j_shard_batch(batch, mesh))
        (adam,) = [s for s in jax.tree_util.tree_leaves(new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                   if isinstance(s, optax.ScaleByAdamState)]
        grads = jax.tree_util.tree_map(lambda m: np.asarray(m, np.float64) / (1 - B1), jax.device_get(adam.mu))
        jax_out[(kind, per_item_K)] = dict(
            grads=_port_layout(grads), state=_port_layout(jax.device_get(new.params), jax.device_get(new.stats)),
            loss=float(metrics["loss"]),
        )
    cases = [dict(name=f"{kind}-{int(k)}", kind=kind, batch=_batch(k)) for kind, k in CASES]
    cases += [dict(name=f"scanned-{int(k)}", kind="scanned", batch=_batch(k, seed=1, lead=(2,))) for k in (False, True)]
    torch.save({"state_dict": params_from_jax(*init), "cfg": KW, "K": K, "cases": cases}, tmp / "inputs.pt")
    values, reports = run_ranks(["steps", "--inputs", str(tmp / "inputs.pt"), "--dtype", "float64"])
    (tmp / "inputs.pt").unlink()
    return jax_out, torch.load(io.BytesIO(values), weights_only=False), [r["cases"] for r in reports]


def _np(tree: dict) -> dict:
    return {k: v.double().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("kind,per_item_K", CASES)
def test_step_matches_jax_on_two_ranks(runs, kind, per_item_K):
    jax_out, values, reports = runs
    ref, name = jax_out[(kind, per_item_K)], f"{kind}-{int(per_item_K)}"
    r0 = values[name]
    # both ranks hold the same grads and state after the step, bitwise (GSPMD:
    # the metrics too; shard_map keeps each rank's own mean disparity)
    keys = ("grads", "state", "metrics") if kind == "gspmd" else ("grads", "state", "loss")
    assert all(reports[0][name][k] == reports[1][name][k] for k in keys), (reports[0][name], reports[1][name])
    state = {k: v for k, v in _np(r0["state_dict"]).items() if not k.endswith("num_batches_tracked")}
    _close(_np(r0["grads"]), ref["grads"], f"{name} grads")
    _close(state, ref["state"], f"{name} params and BN running stats")
    assert abs(r0["metrics"]["loss"].item() - ref["loss"]) <= TOL * abs(ref["loss"])


def test_semantics_differ_where_they_should(runs):
    """GSPMD's global-batch BatchNorm and shard_map's per-rank BatchNorm give
    different losses (each side alike), so the two cases do test different
    things."""
    jax_out, values, _ = runs
    for k in (False, True):
        g, s = jax_out[("gspmd", k)], jax_out[("shardmap", k)]
        assert abs(g["loss"] - s["loss"]) > 1e-6 * abs(g["loss"])
        t_g, t_s = values[f"gspmd-{int(k)}"], values[f"shardmap-{int(k)}"]
        assert abs(t_g["metrics"]["loss"].item() - t_s["metrics"]["loss"].item()) > 1e-6 * abs(g["loss"])


def test_per_item_K_changes_the_step(runs):
    jax_out, values, _ = runs
    for kind in ("gspmd", "shardmap"):
        assert abs(jax_out[(kind, True)]["loss"] - jax_out[(kind, False)]["loss"]) > 1e-6
        t = [values[f"{kind}-{int(k)}"]["metrics"]["loss"].item() for k in (False, True)]
        assert abs(t[0] - t[1]) > 1e-6


@pytest.mark.parametrize("per_item_K", [False, True])
def test_scanned_step_equals_single_steps(runs, per_item_K):
    """Two micro-steps of the scanned step and two single steps from the same
    state: the same grads, state and metrics, bitwise, on both ranks."""
    _, _, reports = runs
    recs = [r[f"scanned-{int(per_item_K)}"] for r in reports]
    for rec in recs:
        assert rec["scanned"] == rec["singles"] and rec["scanned"]["step"] == 2
    assert recs[0] == recs[1]


def _mesh(size=2, rank=0):
    return Mesh(size=size, rank=rank, device=torch.device("cpu"), backend="gloo")


def test_global_batch_not_divisible_raises():
    cfg, ctx = TrainConfig(**dict(KW, batch_size=3)), TrainContext.create(K, W, H, device="cpu")
    for make in (make_parallel_train_step, make_shardmap_train_step, make_parallel_scanned_train_step):
        with pytest.raises(ValueError, match="not divisible"):
            make(ctx, cfg, _mesh())
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((3, 1)), _mesh())
    with pytest.raises(ValueError, match="not divisible"):
        PerHostSampler(list(range(8)), 3, process_id=0, num_processes=2)
    with pytest.raises(ValueError, match="no axis"):
        make_parallel_train_step(ctx, TrainConfig(**KW), _mesh(), axis="model")


LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_initialize_distributed_noop_without_config(monkeypatch):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert process_info() == (0, 1)
    assert local_batch_slice(8) == slice(0, 8)


@pytest.mark.parametrize("env,kw,error", [
    ({"RANK": "1"}, {}, ValueError),
    ({}, {"process_id": 0}, ValueError),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "1"}, {}, ValueError),
    ({"WORLD_SIZE": "2", "RANK": "0"}, {}, ValueError),
    ({}, {"auto": True}, RuntimeError),
])
def test_initialize_distributed_refuses_a_partial_config(monkeypatch, env, kw, error):
    for var in LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(error):
        initialize_distributed(device="cpu", **kw)
    assert not torch.distributed.is_initialized()


class _Draws:
    """Items that record their global index and their augmentation draws."""

    def __init__(self, n):
        self.n = n
        self.K = np.eye(3)

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return np.asarray([i, rng.integers(1 << 30), rng.integers(1 << 30)], np.int64)


def test_per_host_sampler_matches_jax():
    """Two processes × two epochs: the same global rows, the same draws, the
    same per-item K, through each package's DataLoader too."""
    import monodepth2_tpu.data as J
    import monodepth2_torch.data as T
    from monodepth2_tpu.parallel import PerHostSampler as JSampler

    ds = _Draws(16)
    for pid in range(2):
        t = PerHostSampler(ds, 8, seed=5, process_id=pid, num_processes=2)
        j = JSampler(ds, 8, seed=5, process_id=pid, num_processes=2)
        assert len(t) == len(j) == 8 and t.per_host == j.per_host == 4
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(t)):
                np.testing.assert_array_equal(t[i], j[i])
                np.testing.assert_array_equal(t.K_of(i), j.K_of(i))
            tl = list(T.DataLoader(t, t.per_host, shuffle=False, seed=5))
            jl = list(J.DataLoader(j, j.per_host, shuffle=False, seed=5))
            assert len(tl) == len(jl) == 2
            for a, b in zip(tl, jl):
                np.testing.assert_array_equal(a, b)


def test_per_host_sampler_partitions_and_caches_epoch_order():
    ds = _Draws(16)
    samplers = [PerHostSampler(ds, 8, seed=5, process_id=p, num_processes=2) for p in range(2)]
    for epoch in (0, 1):
        for s in samplers:
            s.set_epoch(epoch)
        order = samplers[0]._global_order()
        assert samplers[0]._global_order() is order  # cached within the epoch
        rows = [[s[i][0] for i in range(len(s))] for s in samplers]
        for gb in range(2):
            got = rows[0][4 * gb : 4 * gb + 4] + rows[1][4 * gb : 4 * gb + 4]
            np.testing.assert_array_equal(got, order[8 * gb : 8 * gb + 8])
    samplers[0].set_epoch(0)
    o0 = samplers[0]._global_order().copy()
    samplers[0].set_epoch(1)
    assert not np.array_equal(o0, samplers[0]._global_order())


def test_shard_host_batch_equals_shard_batch_in_one_process():
    mesh = _mesh(size=1)
    rng = np.random.default_rng(0)
    frames = rng.uniform(size=(4, 3, 8, 16, 1)).astype(np.float32)
    batch = {"frames": frames, "K": np.stack([K] * 4).astype(np.float32)}
    for b, stacked in ((frames, False), (batch, False), (frames[None], True)):
        a, s = shard_host_batch(b, mesh, stacked=stacked), shard_batch(b, mesh, stacked=stacked)
        if isinstance(b, dict):
            assert a.keys() == s.keys()
            for k in a:
                assert torch.equal(a[k], s[k])
        else:
            assert torch.equal(a, s) and a.shape == np.asarray(b).shape
    # two ranks take contiguous rows in rank order (stacked: of the batch axis)
    parts = [shard_batch(frames, _mesh(2, r)) for r in range(2)]
    assert torch.equal(torch.cat(parts), torch.from_numpy(frames))
    parts = [shard_batch(frames[None], _mesh(2, r), stacked=True) for r in range(2)]
    assert torch.equal(torch.cat(parts, dim=1), torch.from_numpy(frames[None]))


def test_global_batch_stats_hook_against_the_plain_layer():
    """With a sum over one rank, the hook's BatchNorm gives the plain layer's
    output, gradients and running statistics to rounding, in float64, fp32
    and with a bf16 input under autocast (the rounding of
    `_bf16_running_update`); a frozen layer normalizes and leaves its
    statistics alone."""
    gen = torch.Generator().manual_seed(0)
    for dtype, x_dtype, tol in ((torch.float64, torch.float64, 1e-12), (torch.float32, torch.float32, 2e-6),
                                (torch.float32, torch.bfloat16, 1e-2)):
        x = (torch.randn((3, 5, 4, 6), generator=gen, dtype=torch.float64) * 2 + 1).to(x_dtype)
        r = torch.randn((3, 5, 4, 6), generator=gen, dtype=torch.float64)
        layers = [BatchNorm(5).to(dtype) for _ in range(2)]
        for m in layers:
            with torch.no_grad():
                m.weight.copy_(torch.linspace(0.5, 1.5, 5))
                m.bias.copy_(torch.linspace(-1, 1, 5))
        outs, grads = [], []
        for m, hook in zip(layers, (False, True)):
            xi = x.clone().requires_grad_()
            with torch.autocast("cpu", dtype=torch.bfloat16, enabled=x_dtype == torch.bfloat16):
                with global_batch_stats(m, lambda t: t.clone()) if hook else contextlib.nullcontext():
                    y = m(xi)
            assert y.dtype == x_dtype
            (y.double() * r).sum().backward()
            outs.append(y.detach().double())
            grads.append((xi.grad.double(), m.weight.grad.double()))
        assert float((outs[0] - outs[1]).abs().max()) <= tol * float(outs[0].abs().max()), dtype
        for a, b in zip(*grads):
            assert float((a - b).abs().max()) <= tol * float(a.abs().max()), dtype
        for name in ("running_mean", "running_var"):
            a, b = getattr(layers[0], name), getattr(layers[1], name)
            assert float((a - b).abs().max()) <= tol * float(a.abs().max()), (dtype, name)
        assert int(layers[0].num_batches_tracked) == int(layers[1].num_batches_tracked) == 1
    m = BatchNorm(5).double()
    m.frozen_stats = True
    with global_batch_stats(m, lambda t: t.clone()):
        m(torch.randn(2, 5, 3, 3, dtype=torch.float64))
    assert m.global_sum is None
    assert torch.equal(m.running_mean, torch.zeros(5, dtype=torch.float64)) and int(m.num_batches_tracked) == 0


@pytest.fixture
def one_rank_group():
    """A gloo group of one in this process (what make_mesh sets up alone),
    destroyed afterwards."""
    from monodepth2_torch.parallel import make_mesh

    assert not torch.distributed.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    torch.distributed.destroy_process_group()


def test_single_process_mesh_step_equals_the_plain_step(one_rank_group):
    """On the mesh of one process both data-parallel steps run their
    collectives and give the plain step's result, float64, to rounding."""
    from monodepth2_torch.models import Model
    from monodepth2_torch.parallel import COUNTS, reset_counts
    from monodepth2_torch.training import create_train_state, make_train_step

    mesh = one_rank_group
    assert (mesh.size, mesh.rank, mesh.backend, mesh.device.type) == (1, 0, "gloo", "cpu")
    cfg = TrainConfig(**dict(KW, batch_size=2))
    ctx = TrainContext.create(K, W, H, dtype=torch.float64, device="cpu")
    frames = torch.from_numpy(_batch(False)[:2])
    results = {}
    for name, make in (("plain", lambda: make_train_step(ctx, cfg)),
                       ("gspmd", lambda: make_parallel_train_step(ctx, cfg, mesh)),
                       ("shardmap", lambda: make_shardmap_train_step(ctx, cfg, mesh))):
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu").double(), cfg)
        reset_counts()
        state, metrics, _ = make()(state, frames)
        results[name] = (state, metrics, dict(COUNTS))
    plain = results["plain"][0]
    assert results["plain"][2]["calls"] == 0
    # GSPMD: 2 forward and 2 backward sums a BatchNorm, the grads, the metrics
    n_bn = sum(isinstance(m, BatchNorm) for m in plain.model.modules())
    assert results["gspmd"][2] == {"calls": 4 * n_bn + 2, "captured": 0}
    assert results["shardmap"][2] == {"calls": 3, "captured": 0}
    # grads and running stats within 1e-10 of each leaf's max; params within
    # 1e-6·lr: Adam turns a near-zero grad's rounding into up to lr a step
    for name in ("gspmd", "shardmap"):
        state, metrics, _ = results[name]
        for (k, p), q in zip(plain.model.named_parameters(), state.model.parameters()):
            assert float((p.grad - q.grad).abs().max()) <= 1e-10 * float(p.grad.abs().max()), (name, k)
            assert float((p.detach() - q.detach()).abs().max()) <= 1e-6 * cfg.lr, (name, k)
        for (k, a), b in zip(plain.model.named_buffers(), state.model.buffers()):
            scale = float(a.abs().max()) if a.is_floating_point() else 0
            assert float((a.double() - b.double()).abs().max()) <= 1e-10 * scale, (name, k)
        for key in ("loss", "mean_disparity"):
            assert abs(metrics[key].item() - results["plain"][1][key].item()) <= 1e-12, (name, key)


def test_single_process_mesh_step_with_remat(one_rank_group):
    """remat under the global-batch BatchNorm: the recomputed forward takes
    the same global moments (its sums run again, 6 a BatchNorm in all) and
    leaves the running statistics to the first pass; grads and statistics
    as without remat, float64."""
    import dataclasses

    from monodepth2_torch.models import Model
    from monodepth2_torch.parallel import COUNTS, reset_counts
    from monodepth2_torch.training import create_train_state

    mesh = one_rank_group
    cfg = TrainConfig(**dict(KW, batch_size=2))
    ctx = TrainContext.create(K, W, H, dtype=torch.float64, device="cpu")
    frames = torch.from_numpy(_batch(False)[:2])
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu").double(), c)
        reset_counts()
        state, _, _ = make_parallel_train_step(ctx, c, mesh)(state, frames)
        out[remat] = (state, COUNTS["calls"])
    n_bn = sum(isinstance(m, BatchNorm) for m in out[False][0].model.modules())
    assert (out[False][1], out[True][1]) == (4 * n_bn + 2, 6 * n_bn + 2)
    plain, remat = out[False][0], out[True][0]
    for (k, p), q in zip(plain.model.named_parameters(), remat.model.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-10 * float(p.grad.abs().max()), k
    for (k, a), b in zip(plain.model.named_buffers(), remat.model.buffers()):
        assert torch.equal(a, b), k
