"""monodepth2_torch.training.loop.fit, the trainer's entry point, on the CPU
at 64×32, batch 2, ResNet-18: it trains, checkpoints, writes PNGs and a
metrics.jsonl whose steps and fields are those of the JAX package's fit on
the same config; it resumes at the epoch position, bitwise equal to an
uninterrupted run; and the repairs of this slice: `remat` recomputes the
network without updating the BN stats twice, `debug_nans` raises on a
non-finite loss and restores autograd's anomaly mode on every exit."""

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from monodepth2_torch.data import SyntheticTriplets
from monodepth2_torch.models import Model
from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, train_loss
from monodepth2_torch.training.loop import _crossed, _group_batches, fit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, which torch's default of one thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cfg(tmp_path):
    yield TrainConfig(
        target_size=(64, 32), batch_size=2, epochs=2, log_every=2, save_every=0,
        log_dir=str(tmp_path / "logs"), save_dir=str(tmp_path / "ckpts"),
    )
    # a ResNet-18 checkpoint is ~190 MB: remove the test's own at its end,
    # rather than leave them to pytest's kept temporary directories
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fit(cfg, ds, **kw):
    return fit(cfg, ds, verbose=False, device="cpu", **kw)


def test_fit_trains_and_checkpoints(cfg):
    ds = SyntheticTriplets(n=4, target_size=cfg.target_size)
    state, model = _fit(cfg, ds, max_steps=3)
    assert state.step == 3 and state.model is model
    assert os.path.exists(os.path.join(cfg.save_dir, "ckpt-3.npz"))
    assert os.path.exists(os.path.join(cfg.log_dir, "disp-2.png"))
    assert os.path.exists(os.path.join(cfg.log_dir, "warp-2-0.png"))
    assert os.path.exists(os.path.join(cfg.log_dir, "warp-2-1.png"))


def test_fit_steps_per_call_groups_calls(cfg):
    """steps_per_call 2 with save_every 4: the counter jumps by 2 a call and
    the cadences still fire; the tail of an odd epoch is a short group."""
    cfg2 = dataclasses.replace(cfg, steps_per_call=2, save_every=4)
    ds = SyntheticTriplets(n=4, target_size=cfg2.target_size)
    state, _ = _fit(cfg2, ds, max_steps=4, progress=True)
    assert state.step == 4
    assert os.path.exists(os.path.join(cfg2.log_dir, "disp-2.png"))
    assert os.path.exists(os.path.join(cfg2.save_dir, "ckpt-4.npz"))
    groups = list(_group_batches(iter([np.zeros((2, 1))] * 5), 2))
    assert [g.shape for g in groups] == [(2, 2, 1), (2, 2, 1), (1, 2, 1)]
    dicts = list(_group_batches(iter([{"frames": np.zeros((2, 1)), "K": np.eye(3)}] * 3), 2))
    assert [d["K"].shape for d in dicts] == [(2, 3, 3), (1, 3, 3)]


def test_crossed():
    assert _crossed(5, 10, 10) and _crossed(5, 22, 10) and not _crossed(5, 24, 2)
    assert not _crossed(0, 10, 10) and _crossed(1, 1, 1)


def test_metrics_jsonl_matches_jax_fit(cfg, tmp_path):
    """One JAX fit and one port fit on the same config (steps_per_call 2,
    log_every 3, save_every 4, 3 epochs): the same metrics.jsonl fields,
    steps and epochs, and the same checkpoint names. Bookkeeping only: no
    weight is compared."""
    from monodepth2_tpu.data import SyntheticTriplets as JSyntheticTriplets
    from monodepth2_tpu.training import TrainConfig as JConfig
    from monodepth2_tpu.training.loop import fit as j_fit

    kw = dict(target_size=(64, 32), batch_size=2, epochs=3, steps_per_call=2, log_every=3, save_every=4)
    runs = {}
    for name, Config, Dataset, run in (
        ("jax", JConfig, JSyntheticTriplets, lambda c, d: j_fit(c, d, verbose=False)),
        ("port", TrainConfig, SyntheticTriplets, lambda c, d: _fit(c, d)),
    ):
        c = Config(**kw, log_dir=str(tmp_path / name / "logs"), save_dir=str(tmp_path / name / "ckpts"))
        state, _ = run(c, Dataset(n=4, target_size=c.target_size))
        rows = [json.loads(line) for line in open(os.path.join(c.log_dir, "metrics.jsonl"))]
        runs[name] = dict(step=int(state.step), rows=rows, ckpts=sorted(os.listdir(c.save_dir)),
                          pngs=sorted(f for f in os.listdir(c.log_dir) if f.endswith(".png")))
    j, t = runs["jax"], runs["port"]
    assert t["step"] == j["step"] == 6
    assert [r.keys() for r in t["rows"]] == [r.keys() for r in j["rows"]]
    assert [(r["step"], r["epoch"]) for r in t["rows"]] == [(r["step"], r["epoch"]) for r in j["rows"]] == [(3, 1), (6, 2)]
    assert all(np.isfinite(r["loss"]) and 0 < r["mean_disparity"] < 1 for r in t["rows"])
    assert t["ckpts"] == j["ckpts"] == ["ckpt-4.json", "ckpt-4.npz", "ckpt-6.json", "ckpt-6.npz"]
    assert t["pngs"] == j["pngs"]


class _Recording(SyntheticTriplets):
    """Logs every requested index — lets tests observe the data order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.requested = []
        self.lock = threading.Lock()

    def __getitem__(self, i, rng=None):
        with self.lock:
            self.requested.append(int(i))
        return super().__getitem__(i, rng)


def test_fit_resume_keeps_epoch_position_and_is_bitwise(cfg):
    """Interrupted at step 3 (mid-epoch 2) and resumed: exactly one more
    step, on the final batch of the uninterrupted run's order, and the final
    state equal to the uninterrupted run's, bitwise."""
    full_ds = _Recording(n=4, target_size=cfg.target_size)
    full, _ = _fit(dataclasses.replace(cfg, log_every=0), full_ds)
    assert full.step == 4
    full_order = list(full_ds.requested)

    cfg2 = dataclasses.replace(cfg, log_every=0, save_dir=cfg.save_dir + "-b", log_dir=cfg.log_dir + "-b")
    ds = _Recording(n=4, target_size=cfg.target_size)
    _fit(cfg2, ds, max_steps=3)
    ds = _Recording(n=4, target_size=cfg.target_size)
    resumed, _ = _fit(cfg2, ds)
    assert resumed.step == 4
    assert sorted(ds.requested) == sorted(full_order[-cfg.batch_size:])
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(full.model.parameters(), resumed.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(full.optimizer.state[p][key], resumed.optimizer.state[q][key]), key


def test_fit_resume_at_max_steps_trains_nothing(cfg):
    cfg2 = dataclasses.replace(cfg, steps_per_call=2)
    ds = SyntheticTriplets(n=4, target_size=cfg.target_size)
    _fit(cfg2, ds, max_steps=2)
    state, _ = _fit(cfg2, ds, max_steps=2)
    assert state.step == 2  # not 4


def test_fit_requires_intrinsics(cfg):
    class NoK:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise AssertionError("should not be reached")

    with pytest.raises(ValueError, match="intrinsics"):
        _fit(cfg, NoK())


@pytest.mark.parametrize("attr, value", [("target_id", 0), ("source_ids", (0, 1))])
def test_fit_rejects_frame_layout_mismatch(cfg, attr, value):
    ds = SyntheticTriplets(n=4, target_size=cfg.target_size)
    setattr(ds, attr, value)
    with pytest.raises(ValueError, match=attr):
        _fit(cfg, ds)


def test_fit_mesh_not_ported(cfg):
    """fit over a mesh is ported (tests/test_torch_multiprocess.py): what is
    not a parallel.Mesh is refused, and so is a mesh on another device type
    than the one asked for."""
    from monodepth2_torch.parallel import Mesh

    ds = SyntheticTriplets(n=4, target_size=cfg.target_size)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _fit(cfg, ds, mesh=object())
    on_card = Mesh(size=1, rank=0, device=torch.device("cuda", 0), backend="nccl")
    with pytest.raises(ValueError, match="over a mesh on cuda"):
        _fit(cfg, ds, mesh=on_card)


def test_fit_on_cuda_refuses_without_a_card(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(cfg, SyntheticTriplets(n=4, target_size=cfg.target_size), verbose=False)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_keeps_grads_and_bn_stats(compute_dtype):
    """With remat the model's forward runs again in the backward; the BN
    layers leave their stats alone then, so grads and stats (and the batch
    counts) equal those without remat."""
    W, H = 64, 32
    K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, W, H, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 3, H, W, 1)).astype(np.float32))
    out = []
    for remat in (False, True):
        cfg = TrainConfig(target_size=(W, H), batch_size=2, remat=remat, compute_dtype=compute_dtype)
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
        loss, _ = train_loss(state.model, frames, ctx, cfg)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in state.model.named_parameters()},
                    {k: v for k, v in state.model.state_dict().items() if "running" in k or "num_batches" in k}))
    (l0, g0, s0), (l1, g1, s1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9, msg=k)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k
    assert all(int(v) == 1 for k, v in s1.items() if "num_batches" in k)


class _NaNAfter(SyntheticTriplets):
    """Frames turn NaN from item `bad` on."""

    def __init__(self, bad, *a, **kw):
        super().__init__(*a, **kw)
        self.bad = bad

    def __getitem__(self, i, rng=None):
        x = super().__getitem__(i, rng)
        return x * np.nan if i >= self.bad else x


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_debug_nans_raises_and_restores(cfg, steps_per_call):
    cfg2 = dataclasses.replace(cfg, debug_nans=True, steps_per_call=steps_per_call)
    assert not torch.is_anomaly_enabled()
    state, _ = _fit(cfg2, SyntheticTriplets(n=4, target_size=cfg.target_size), max_steps=2)
    assert state.step == 2 and not torch.is_anomaly_enabled()
    cfg3 = dataclasses.replace(cfg2, save_dir=cfg.save_dir + "-nan", log_dir=cfg.log_dir + "-nan")
    with pytest.raises(FloatingPointError):
        _fit(cfg3, _NaNAfter(0, n=4, target_size=cfg.target_size))
    assert not torch.is_anomaly_enabled()
    # without debug_nans the same data trains through the NaN (no logging:
    # a NaN disparity has no heatmap, in the JAX package's viz as here)
    cfg4 = dataclasses.replace(cfg3, debug_nans=False, log_every=0, save_dir=cfg.save_dir + "-on",
                               log_dir=cfg.log_dir + "-on")
    state, _ = _fit(cfg4, _NaNAfter(0, n=4, target_size=cfg.target_size), max_steps=2)
    assert state.step == 2
