"""monodepth2_torch.training.checkpoint: the full train state (params, BN
stats, Adam's moments and step counts, the train step) round-trips bitwise,
a resume continues bitwise, and a checkpoint of another structure or shape
is refused — the cases of tests/test_checkpoint.py for the port's format.
64×32, batch 2, ResNet-18, on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from monodepth2_torch.models import Model
from monodepth2_torch.training import (
    TrainConfig,
    TrainContext,
    create_train_state,
    latest_checkpoint,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from monodepth2_torch.training import checkpoint as ckpt

W, H, N = 64, 32, 2
# the lr schedule and disp_reg on, so a resume must restore the step they read
CFG = TrainConfig(target_size=(W, H), batch_size=N, disp_reg=0.01, disp_reg_steps=4,
                  lr_warmup_steps=2, lr_decay_steps=4, lr_decay_factor=0.5)
K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])


def _state(cfg=CFG, depth=18):
    return create_train_state(Model.create(depth=depth, in_channels=1, device="cpu"), cfg)


def _frames(i):
    return torch.from_numpy(np.random.default_rng(i).uniform(size=(N, 3, H, W, 1)).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, which torch's default of one thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A ResNet-18 checkpoint is ~190 MB: each test removes its own at its
    end, rather than leave them to pytest's kept temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _snapshot(state):
    """Copies of everything a checkpoint holds."""
    return dict(
        step=state.step,
        model={k: v.clone() for k, v in state.model.state_dict().items()},
        optim=[{k: v.clone() for k, v in state.optimizer.state[p].items()} for p in state.model.parameters()],
    )


def _assert_same(a, b):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        x, y = a["model"][k], b["model"][k]
        assert x.dtype == y.dtype and torch.equal(x, y), k
    for sa, sb in zip(a["optim"], b["optim"]):
        assert sa.keys() == sb.keys() == {"exp_avg", "exp_avg_sq", "step"}
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One 5-step trajectory, checkpointed after steps 1, 2 and 3, with a
    snapshot of the state at each and at the end; and the step function."""
    d = tmp_path_factory.mktemp("ckpts")
    step = make_train_step(TrainContext.create(K, W, H, device="cpu"), CFG)
    state, snaps = _state(), {}
    for i in range(5):
        state, _, _ = step(state, _frames(i))
        if state.step <= 3:
            save_checkpoint(str(d / f"ckpt-{state.step}"), state, metadata={"loss": 1.5})
        snaps[state.step] = _snapshot(state)
    yield d, step, snaps
    shutil.rmtree(d, ignore_errors=True)


def test_roundtrip_is_bitwise(run):
    d, _, snaps = run
    back = load_checkpoint(str(d / "ckpt-2"), _state())
    _assert_same(_snapshot(back), snaps[2])
    meta = json.loads((d / "ckpt-2.json").read_text())
    assert meta["step"] == 2 and meta["loss"] == 1.5 and meta["fingerprint"] == ckpt.fingerprint(back)
    assert meta["n_arrays"] == len(ckpt.structure(back))


def test_roundtrip_before_the_first_step(tmp_path):
    """A state Adam has not stepped yet saves zero moments and step 0, and
    loads as one."""
    state = _state()
    save_checkpoint(str(tmp_path / "ckpt-0"), state)
    back = load_checkpoint(str(tmp_path / "ckpt-0"), _state())
    assert back.step == 0
    for p in back.model.parameters():
        st = back.optimizer.state[p]
        assert float(st["step"]) == 0 and not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def test_resume_continues_bitwise(run):
    """3 steps, save, load into a fresh state, 2 steps == 5 steps."""
    d, step, snaps = run
    resumed = load_checkpoint(latest_checkpoint(str(d)), _state())
    assert resumed.step == 3
    for i in range(3, 5):
        resumed, _, _ = step(resumed, _frames(i))
    _assert_same(_snapshot(resumed), snaps[5])


def test_load_copies_into_the_states_tensors(run):
    """Loading keeps the state's own tensors (a captured CUDA graph holds
    their addresses) once Adam has created them."""
    d, _, snaps = run
    state = load_checkpoint(str(d / "ckpt-1"), _state())
    params = [p.data_ptr() for p in state.model.parameters()]
    moments = [state.optimizer.state[p]["exp_avg"].data_ptr() for p in state.model.parameters()]
    load_checkpoint(str(d / "ckpt-2"), state)
    assert [p.data_ptr() for p in state.model.parameters()] == params
    assert [state.optimizer.state[p]["exp_avg"].data_ptr() for p in state.model.parameters()] == moments
    _assert_same(_snapshot(state), snaps[2])


def test_structure_mismatch_refused(tmp_path):
    """A ResNet-34 checkpoint into a ResNet-18 state: another structure."""
    save_checkpoint(str(tmp_path / "ckpt-0"), _state(depth=34))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(tmp_path / "ckpt-0"), _state())


def test_optimizer_mismatch_refused(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path / "ckpt-0"), state)
    other = _state()
    other.optimizer = torch.optim.AdamW(other.model.parameters(), lr=1e-4)
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(str(tmp_path / "ckpt-0"), other)


def test_shape_mismatch_refused(tmp_path):
    """An array of another shape than its sidecar promises is refused before
    anything is copied."""
    path = str(tmp_path / "ckpt-0")
    state = _state()
    save_checkpoint(path, state)
    with np.load(path + ".npz") as data:
        arrays = dict(data)
    key = "model/encoder.stem_conv.weight"
    arrays[key] = np.zeros((3,) + arrays[key].shape[1:], arrays[key].dtype)
    np.savez(path + ".npz", **arrays)
    target = _state(TrainConfig(**{**CFG.__dict__, "seed": 7}))
    before = target.model.encoder.stem_conv.weight.clone()
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, target)
    assert torch.equal(target.model.encoder.stem_conv.weight, before)


def test_missing_array_refused(tmp_path):
    path = str(tmp_path / "ckpt-0")
    save_checkpoint(path, _state())
    with np.load(path + ".npz") as data:
        arrays = dict(data)
    del arrays["train_step"]
    np.savez(path + ".npz", **arrays)
    with pytest.raises(ValueError, match="arrays"):
        load_checkpoint(path, _state())


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    state = _state()
    for s in (2, 10, 7):
        state.step = s
        save_checkpoint(str(tmp_path / f"ckpt-{s}"), state)
    (tmp_path / "ckpt-99.json").write_text("{}")  # a sidecar without its arrays
    (tmp_path / "other-50.npz").write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt-10")


def test_no_temporary_file_left(tmp_path):
    save_checkpoint(str(tmp_path / "sub" / "ckpt-0"), _state())
    assert sorted(os.listdir(tmp_path / "sub")) == ["ckpt-0.json", "ckpt-0.npz"]


def test_resume_under_a_schedule_the_checkpoint_lacked(tmp_path, capsys):
    """The case tools/migrate_checkpoint.py exists for in the JAX package: a
    run started without lr_warmup_steps/lr_decay_steps resumes with them.
    The port's checkpoint is keyed by name (its fingerprint covers the
    model's and Adam's arrays, not the schedule) and the schedule is
    computed from the train step, so it loads as it is: the step, Adam's
    moments and counts come back, the steps after the resume take the
    schedule's lr at their step, and fit resumes under the new config."""
    from dataclasses import replace

    from monodepth2_torch.data import SyntheticTriplets
    from monodepth2_torch.training.loop import fit
    from monodepth2_torch.training.state import lr_at

    plain = TrainConfig(target_size=(W, H), batch_size=N, log_every=0, save_every=0,
                        log_dir=str(tmp_path / "logs"), save_dir=str(tmp_path / "ckpts"))
    sched = replace(plain, lr_warmup_steps=4, lr_decay_steps=3, lr_decay_factor=0.5)
    ds = SyntheticTriplets(n=4, target_size=(W, H))
    state, _ = fit(plain, ds, max_steps=2, verbose=False, device="cpu")
    saved = _snapshot(state)
    back = load_checkpoint(latest_checkpoint(plain.save_dir), _state(sched))
    _assert_same(_snapshot(back), saved)
    assert back.step == 2 and all(float(st["step"]) == 2 for st in back.optimizer.state.values())
    step = make_train_step(TrainContext.create(ds.K, W, H, device="cpu"), sched)
    for want_step in (2, 3):  # warmup at 2/4; warmup 3/4 and the decay at 3
        back, m, _ = step(back, _frames(want_step))
        assert float(m["lr"]) == pytest.approx(lr_at(sched, want_step), rel=1e-6)
        assert back.optimizer.param_groups[0]["lr"].item() == pytest.approx(lr_at(sched, want_step), rel=1e-6)
    capsys.readouterr()
    resumed, _ = fit(sched, ds, max_steps=4, verbose=True, device="cpu")
    assert resumed.step == 4 and "ckpt-2 at step 2" in capsys.readouterr().out
