"""monodepth2_torch's scanned train step (make_scanned_train_step) against
the JAX package's (lax.scan over K steps in one jit), and the port's
learning-rate and disp_reg schedules, computed as tensors from a step-count
tensor, against the JAX arithmetic.

On the CPU the port's scanned step runs K eager steps; on the card it
replays a captured CUDA graph of the same code (tests/test_torch_cuda.py
holds the replay to the eager step). K = 3 at 64×32, batch 2, ResNet-18, in
float64, with disp_reg on and lr_warmup_steps = lr_decay_steps = 2, so that
both schedules change inside the scan. Tolerances are those of
tests/test_torch_training.py in float64: loss and mean disparity 1e-8 rel,
BN stats and Adam moments 1e-6 of each leaf's largest entry, params 1e-6
abs, and the last step's aux 1e-6 of its largest entry.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth2_tpu.models import Model as JModel
from monodepth2_tpu.training import TrainConfig as JConfig
from monodepth2_tpu.training import TrainContext as JContext
from monodepth2_tpu.training import create_train_state as j_create
from monodepth2_tpu.training.state import _lr_schedule
from monodepth2_tpu.training.state import make_scanned_train_step as j_make_scanned
from monodepth2_torch.bridge import params_from_jax, params_to_jax
from monodepth2_torch.models import Model
from monodepth2_torch.training import (
    TrainConfig,
    TrainContext,
    create_train_state,
    make_scanned_train_step,
    make_train_step,
)
from monodepth2_torch.training.state import disp_reg_schedule, lr_at, lr_schedule

W, H, N, KSTEPS = 64, 32, 2, 3
CFG = dict(
    target_size=(W, H), batch_size=N, in_channels=1, lr=1e-4, warp_method="gather",
    disp_reg=0.01, disp_reg_steps=4, lr_warmup_steps=2, lr_decay_steps=2, lr_decay_factor=0.5,
    steps_per_call=KSTEPS,
)
K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, which torch's default of one thread a core oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(seed=0, k=KSTEPS):
    return np.random.default_rng(seed).uniform(size=(k, N, 3, H, W, 1)).astype(np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _compare(got, ref, rel_of_max=None, **tol):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        if rel_of_max is not None:
            tol = dict(rtol=0, atol=rel_of_max * max(np.abs(ref[k]).max(), 1e-12))
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def _adam_moments(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState)
    ) if isinstance(s, optax.ScaleByAdamState)]
    return adam.mu, adam.nu


@pytest.fixture(scope="module")
def scanned_runs():
    """One call of K = 3 steps on each side, float64, from the same weights."""
    cfg = JConfig(**CFG)
    jm = JModel.create(depth=18, in_channels=1)
    state, tx = j_create(jm, cfg)
    init = (jax.device_get(state.params), jax.device_get(state.stats))
    f64 = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), t)
    state = state._replace(params=f64(state.params), stats=f64(state.stats), opt_state=tx.init(f64(state.params)))
    ctx = JContext.create(K, W, H, dtype=jnp.float64)
    stack = _stack()
    state, metrics, aux = jax.jit(j_make_scanned(jm, tx, ctx, cfg))(state, jnp.asarray(stack, jnp.float64))
    mu, nu = _adam_moments(state.opt_state)
    jax_run = dict(
        loss=np.asarray(metrics["loss"]), mean_disparity=np.asarray(metrics["mean_disparity"]),
        params=jax.device_get(state.params), stats=jax.device_get(state.stats),
        mu=jax.device_get(mu), nu=jax.device_get(nu), step=int(state.step),
        aux={"disparity": np.asarray(aux["disparity"]), "warped": [np.asarray(w) for w in aux["warped"]]},
    )

    pcfg = TrainConfig(**CFG)
    model = Model.create(depth=18, in_channels=1, device="cpu").double()
    pstate = create_train_state(model, pcfg)
    pstate.model.load_state_dict(params_from_jax(*init))
    pctx = TrainContext.create(K, W, H, dtype=torch.float64, device="cpu")
    pstate, pm, paux = make_scanned_train_step(pctx, pcfg)(pstate, torch.from_numpy(stack).double())
    moments = {
        name: params_to_jax(pstate.model, {k: pstate.optimizer.state[p][name] for k, p in pstate.model.named_parameters()})[0]
        for name in ("exp_avg", "exp_avg_sq")
    }
    params, stats = params_to_jax(pstate.model)
    port_run = dict(
        loss=pm["loss"].numpy(), mean_disparity=pm["mean_disparity"].numpy(), params=params, stats=stats,
        mu=moments["exp_avg"], nu=moments["exp_avg_sq"], step=pstate.step,
        aux={"disparity": paux["disparity"].detach().numpy(), "warped": [w.detach().numpy() for w in paux["warped"]]},
        metrics=pm,
    )
    return jax_run, port_run


def test_scanned_metrics_match_jax(scanned_runs):
    j, t = scanned_runs
    assert t["loss"].shape == (KSTEPS,) and t["mean_disparity"].shape == (KSTEPS,)
    assert t["step"] == j["step"] == KSTEPS
    for key in ("loss", "mean_disparity"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-8, err_msg=key)


@pytest.mark.parametrize("name", ["stats", "mu", "nu"])
def test_scanned_state_matches_jax(scanned_runs, name):
    j, t = scanned_runs
    _compare(t[name], j[name], rel_of_max=1e-6)


def test_scanned_params_match_jax(scanned_runs):
    j, t = scanned_runs
    _compare(t["params"], j["params"], rtol=0, atol=1e-6)


def test_scanned_aux_is_the_last_steps(scanned_runs):
    j, t = scanned_runs
    for got, ref in zip([t["aux"]["disparity"], *t["aux"]["warped"]], [j["aux"]["disparity"], *j["aux"]["warped"]]):
        assert got.shape == (N, H, W, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_scanned_metrics_carry_the_schedules(scanned_runs):
    """The stacked lr and disp_reg weight are those of steps 0, 1, 2: both
    schedules change inside the scan."""
    _, t = scanned_runs
    lr, reg = t["metrics"]["lr"].numpy(), t["metrics"]["disp_reg_weight"].numpy()
    np.testing.assert_allclose(lr, [lr_at(TrainConfig(**CFG), s) for s in range(KSTEPS)], rtol=1e-6)
    assert len(set(lr.tolist())) > 1 and len(set(reg.tolist())) == KSTEPS
    np.testing.assert_allclose(reg, [0.01, 0.0075, 0.005], rtol=1e-6)


SCHEDULES = [
    dict(lr=1e-3, lr_warmup_steps=4, lr_decay_steps=6, lr_decay_factor=0.1, disp_reg=0.01, disp_reg_steps=8),
    dict(lr=1e-4, lr_warmup_steps=0, lr_decay_steps=3, lr_decay_factor=0.5, disp_reg=0.5, disp_reg_steps=3),
    dict(lr=3e-4, lr_warmup_steps=7, lr_decay_steps=0, disp_reg=0.02, disp_reg_steps=10),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedules_match_jax(kw):
    """lr_schedule and disp_reg_schedule over steps 0-10, from an int64
    step tensor, equal JAX's _lr_schedule (state.py:32-53) and the disp_reg
    weight of state.py:105-112, bitwise: the same float32 operations."""
    cfg, jcfg = TrainConfig(**kw), JConfig(**kw)
    sched = _lr_schedule(jcfg)
    for s in range(11):
        step = torch.tensor(s, dtype=torch.int64)
        lr = lr_schedule(cfg, step)
        assert lr.dtype == torch.float32
        j_step = jnp.asarray(s, jnp.int32)
        assert lr.item() == float(sched(j_step)), (s, lr.item(), float(sched(j_step)))
        frac = jnp.clip(1.0 - j_step.astype(jnp.float32) / jcfg.disp_reg_steps, 0.0, 1.0)
        reg = disp_reg_schedule(cfg, step)
        assert reg.dtype == torch.float32
        assert reg.item() == float(jcfg.disp_reg * frac), (s, reg.item())


def test_schedules_off():
    """With warmup and decay off the lr stays the plain cfg.lr, as JAX's
    _lr_schedule returns the float (Adam keeps a float lr); disp_reg off is
    no weight at all."""
    cfg = TrainConfig()
    assert lr_schedule(cfg, torch.tensor(5)) is None and disp_reg_schedule(cfg, torch.tensor(5)) is None
    assert _lr_schedule(JConfig()) == cfg.lr
    state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
    assert state.optimizer.param_groups[0]["lr"] == cfg.lr


def _per_item_batches():
    rng = np.random.default_rng(3)
    frames = rng.uniform(size=(KSTEPS, N, 3, H, W, 1)).astype(np.float32)
    Ks = np.stack([[K * [[1.0 + 0.1 * i + 0.05 * k], [1.0 - 0.05 * i], [1.0]] for i in range(N)]
                   for k in range(KSTEPS)]).astype(np.float32)
    return torch.from_numpy(frames), torch.from_numpy(Ks)


def test_per_item_K_stack_equals_single_steps():
    """A stacked {"frames", "K"} batch through the scanned step gives what
    K single eager steps on its slices give, bitwise (the CPU path)."""
    cfg = TrainConfig(**dict(CFG, per_item_K=True, automasking=True, grad_clip=0.05))
    ctx = TrainContext.create(K, W, H, device="cpu")
    frames, Ks = _per_item_batches()
    runs = []
    for scanned in (True, False):
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
        if scanned:
            state, m, aux = make_scanned_train_step(ctx, cfg)(state, {"frames": frames, "K": Ks})
        else:
            step, ms = make_train_step(ctx, cfg), []
            for i in range(KSTEPS):
                state, mi, aux = step(state, {"frames": frames[i], "K": Ks[i]})
                ms.append(mi)
            m = {k: torch.stack([mi[k] for mi in ms]) for k in ms[0]}
        runs.append((state, m, aux))
    (a, ma, auxa), (b, mb, auxb) = runs
    assert a.step == b.step == KSTEPS
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(auxa["disparity"], auxb["disparity"])


def test_configs_keep_steps_per_call():
    """Every committed config asks for 10 steps a call, which fit now acts on."""
    import glob
    import json

    for path in sorted(glob.glob("configs/*.json")):
        assert asdict(TrainConfig.from_json(open(path).read()))["steps_per_call"] == json.load(open(path))["steps_per_call"]


@pytest.mark.gpu
@pytest.mark.parametrize("per_item_K", [False, True])
def test_capture_launches_the_projection_once_per_source(per_item_K):
    """On the card the scanned step's capture launches project_fwd and
    project_bwd once per source (the loss projects each source once over
    all scales), and its replays launch none from Python: the launches
    happen inside the graph, where the wrappers do not see them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the projection kernels have no CPU mode")
    from monodepth2_torch.ops import geometry
    from monodepth2_torch.training.state import WARMUP_STEPS

    dev = torch.device("cuda")
    cfg = TrainConfig(**dict(CFG, warp_method=None, per_item_K=per_item_K))
    ctx = TrainContext.create(K, W, H, device=dev)
    frames, Ks = (x.to(dev) for x in _per_item_batches())
    batch = (lambda i, j: {"frames": frames[i:j], "K": Ks[i:j]}) if per_item_K else (lambda i, j: frames[i:j])
    state = create_train_state(Model.create(depth=18, in_channels=1, device=dev), cfg)
    scanned = make_scanned_train_step(ctx, cfg)
    for _ in range(WARMUP_STEPS):  # the eager warm-up steps
        scanned(state, batch(0, 1))
    src = len(cfg.source_ids)
    before = [k.launches for k in geometry.KERNELS]
    scanned(state, batch(0, KSTEPS))  # the capture, then replays
    after = [k.launches for k in geometry.KERNELS]
    assert [a - b for a, b in zip(after, before)] == [src, src]
    scanned(state, batch(0, KSTEPS))  # replays only
    assert [k.launches for k in geometry.KERNELS] == after
