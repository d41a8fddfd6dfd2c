"""The slice end to end: monodepth2_torch's create_train_state +
make_train_step against the JAX package's (warp_method="gather", CPU) from
the same weights and batch, at 64×32, batch 2, ResNet-18, for 1 and 3 steps,
in float64 and in float32 on both sides.

float64 pins the algorithm. Both sides agree to rounding: loss 1e-8 rel,
grads and Adam moments 1e-6 of each leaf's largest entry, params 1e-6 abs
(1e-2·lr: Adam scales a near-zero gradient's rounding up to a visible step),
BN statistics 1e-6 of each leaf's largest entry (the JAX BatchNorm casts the
batch moments to float32 before the running update, nn/core.py:146-147).

float32 is held to:
  loss, mean disparity       1e-4 rel,
  grads, Adam moments,       1e-3 of the leaf's largest entry,
  BN running stats           each plus the JAX float32 reference's own error
                             against its float64 value, measured in the same
                             fixture. That error is large at this shape: 1.9e-2
                             of the largest grad of encoder/layer2_0/conv2, and
                             2.4e-3 of the mean disparity after 3 steps
                             (ROADMAP.md §3), while the port's float32 grads stay
                             within 1e-3 of the float64 value
  params                     2·lr·steps abs — Adam normalizes each element's
                             step to ~lr, so a near-zero gradient whose sign
                             differs by rounding moves the element by up to lr
                             a step (the same bound as tests/test_multiprocess.py).
That Adam noise also reaches the gradients of steps 2-3: in float32 each
side's Adam moments after 3 steps differ from its own float64 run by up to
9e-2 of the largest entry of encoder/layer4_0/proj (measured at this shape),
so after 3 steps the moments are held to each other in float64 only.

bfloat16 (compute_dtype "bfloat16": float32 master weights, the network in
bf16, geometry and loss in float32) has no exact side: both packages round
the network to bf16, at different places (XLA's bf16 convolutions and
fusions against oneDNN's under autocast). Each quantity is held to twice
the JAX package's own bf16-vs-float32 difference measured in the same
fixture: √2 for two independent roundings of the same size, rounded up.
One BatchNorm layer alone is held exactly, since there both sides see the
same bf16 input.
"""

import glob
import json
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monodepth2_tpu.models import Model as JModel
from monodepth2_tpu.nn.core import BatchNorm as JBatchNorm
from monodepth2_tpu.nn.core import cast_tree
from monodepth2_tpu.training import TrainConfig as JConfig
from monodepth2_tpu.training import TrainContext as JContext
from monodepth2_tpu.training import create_train_state as j_create
from monodepth2_tpu.training import make_train_step as j_make_step
from monodepth2_tpu.training import train_loss as j_train_loss
from monodepth2_tpu.ops.losses import automasking_loss
from monodepth2_torch.bridge import params_from_jax, params_to_jax
from monodepth2_torch.models import Model
from monodepth2_torch.nn.core import BatchNorm
from monodepth2_torch.training import (
    TrainConfig,
    TrainContext,
    create_train_state,
    make_train_step,
    train_loss,
)
from monodepth2_torch.training.state import lr_at

W, H, N = 64, 32, 2
BASE = dict(target_size=(W, H), batch_size=N, in_channels=1, lr=1e-4, warp_method="gather")
# every optional term of the step at once: automask, anti-collapse
# regularizer, a clip that fires, warmup + decay inside 3 steps, per-item K
VARIANT = dict(
    BASE, automasking=True, disp_reg=0.01, disp_reg_steps=4, grad_clip=0.05,
    lr_warmup_steps=2, lr_decay_steps=2, lr_decay_factor=0.5,
)
K = np.asarray([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1.0]])


def _batch(seed, per_item_K):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(size=(N, 3, H, W, 1)).astype(np.float32)
    Ks = np.stack([K * [[1.0 + 0.1 * i], [1.0 - 0.05 * i], [1.0]] for i in range(N)]).astype(np.float32)
    return frames, (Ks if per_item_K else None)


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


def _jax_run(kw, per_item_K, dtype, steps=3):
    """JAX reference in `dtype`: (clipped) grads at the initial state, then the loss,
    metrics and state after each of `steps` train steps. Returns the float32
    initial weights too, which both dtypes start from."""
    cfg = JConfig(**kw)
    jm = JModel.create(depth=18, in_channels=1)
    state, tx = j_create(jm, cfg)
    init = (jax.device_get(state.params), jax.device_get(state.stats))
    cast = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), t)
    state = state._replace(
        params=cast(state.params), stats=cast(state.stats), opt_state=tx.init(cast(state.params))
    )
    ctx = JContext.create(K, W, H, dtype=dtype)
    frames, Ks = (None if a is None else jnp.asarray(a, dtype) for a in _batch(0, per_item_K))
    batch = {"frames": frames, "K": Ks} if per_item_K else frames
    auto = None
    if cfg.automasking:
        auto = automasking_loss(frames, frames[:, cfg.target_id], cfg.source_ids)
    reg = cfg.disp_reg if cfg.disp_reg > 0 else None
    grads = jax.jit(jax.grad(lambda p: j_train_loss(
        jm, p, state.stats, frames, ctx, cfg, auto_loss=auto, disp_reg_weight=reg, Ks=Ks,
    )[0]))(state.params)
    if cfg.grad_clip > 0:  # the port clips p.grad in place: compare clipped
        clip = optax.clip_by_global_norm(cfg.grad_clip)
        grads, _ = clip.update(grads, clip.init(grads))
    step = jax.jit(j_make_step(jm, tx, ctx, cfg))
    history = []
    for _ in range(steps):
        state, metrics, _ = step(state, batch)
        mu, nu = _adam_moments(state.opt_state)
        history.append(dict(
            loss=float(metrics["loss"]), mean_disparity=float(metrics["mean_disparity"]),
            params=jax.device_get(state.params), stats=jax.device_get(state.stats),
            mu=jax.device_get(mu), nu=jax.device_get(nu),
        ))
    return init, jax.device_get(grads), history


def _moments(state, name):
    model, opt = state.model, state.optimizer
    tensors = {k: opt.state[p][name] for k, p in model.named_parameters()}
    return params_to_jax(model, tensors)[0]


def _port_run(kw, per_item_K, init, dtype, steps=3):
    """The port from the same weights: grads of the first step, then the same
    per-step record as _jax_run."""
    cfg = TrainConfig(**kw)
    model = Model.create(depth=18, in_channels=1, device="cpu").to(dtype)
    state = create_train_state(model, cfg)
    state.model.load_state_dict(params_from_jax(*init))
    ctx = TrainContext.create(K, W, H, dtype=dtype, device="cpu")
    frames, Ks = (None if a is None else torch.from_numpy(a).to(dtype) for a in _batch(0, per_item_K))
    batch = {"frames": frames, "K": Ks} if per_item_K else frames
    step = make_train_step(ctx, cfg)
    history = []
    for i in range(steps):
        state, metrics, aux = step(state, batch)
        if i == 0:
            grads = params_to_jax(state.model, {k: p.grad for k, p in state.model.named_parameters()})[0]
        params, stats = params_to_jax(state.model)
        history.append(dict(
            loss=metrics["loss"].item(), mean_disparity=metrics["mean_disparity"].item(),
            params=params, stats=stats, mu=_moments(state, "exp_avg"),
            nu=_moments(state, "exp_avg_sq"), aux=aux,
        ))
    assert state.step == steps
    return grads, history


CONFIGS = {"base": (BASE, False), "variant": (VARIANT, True)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    """Both sides in both dtypes for one configuration, computed once."""
    kw, per_item_K = CONFIGS[request.param]
    out = {"kw": kw}
    for name, jdt, tdt in (("f64", jnp.float64, torch.float64), ("f32", jnp.float32, torch.float32)):
        init, grads_j, history_j = _jax_run(kw, per_item_K, jdt)
        grads_t, history_t = _port_run(kw, per_item_K, init, tdt)
        out[name] = dict(grads_j=grads_j, history_j=history_j, grads_t=grads_t, history_t=history_t)
    return out


def _ref_error(f32, f64):
    """The JAX float32 reference's own elementwise error against float64."""
    return jax.tree_util.tree_map(lambda a, b: np.abs(np.asarray(a, np.float64) - b), f32, f64)


def _compare_with_ref_error(got, ref, ref_err, rel_of_max):
    got, ref, err = dict(_leaves(got)), dict(_leaves(ref)), dict(_leaves(ref_err))
    assert got.keys() == ref.keys()
    for k in ref:
        bound = rel_of_max * np.abs(ref[k]).max() + err[k] + 1e-30
        excess = np.abs(got[k].astype(np.float64) - ref[k]) - bound
        assert excess.max() <= 0, (k, float(excess.max()))


def test_grads_at_first_step(run):
    r64, r32 = run["f64"], run["f32"]
    _compare(r64["grads_t"], r64["grads_j"], rel_of_max=1e-6)
    # the port's float32 against the exact value, then against JAX's float32
    _compare(r32["grads_t"], r64["grads_j"], rel_of_max=1e-3)
    _compare_with_ref_error(
        r32["grads_t"], r32["grads_j"], _ref_error(r32["grads_j"], r64["grads_j"]), 1e-3
    )


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_parity_float64(run, steps):
    r = run["f64"]
    j, t = r["history_j"][steps - 1], r["history_t"][steps - 1]
    for i in range(steps):
        for key in ("loss", "mean_disparity"):
            np.testing.assert_allclose(r["history_t"][i][key], r["history_j"][i][key], rtol=1e-8)
    _compare(t["stats"], j["stats"], rel_of_max=1e-6)
    _compare(t["mu"], j["mu"], rel_of_max=1e-6)
    _compare(t["nu"], j["nu"], rel_of_max=1e-6)
    _compare(t["params"], j["params"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_parity_float32(run, steps):
    kw, r, r64 = run["kw"], run["f32"], run["f64"]
    j, t = r["history_j"][steps - 1], r["history_t"][steps - 1]
    for i in range(steps):
        for key in ("loss", "mean_disparity"):
            got, ref, exact = (h[i][key] for h in (r["history_t"], r["history_j"], r64["history_j"]))
            assert abs(got - ref) <= 1e-4 * abs(ref) + abs(ref - exact), (i, key, got, ref, exact)
    j64 = r64["history_j"][steps - 1]
    for name in ("stats", "mu", "nu") if steps == 1 else ("stats",):
        _compare_with_ref_error(t[name], j[name], _ref_error(j[name], j64[name]), 1e-3)
    _compare(t["params"], j["params"], rtol=0, atol=2 * kw["lr"] * steps)


def test_step_outputs(run):
    history_t = run["f32"]["history_t"]
    aux = history_t[0]["aux"]
    assert aux["disparity"].shape == (N, H, W, 1)
    assert [w.shape for w in aux["warped"]] == [(N, H, W, 1)] * 2
    assert aux["warp_loss"].shape == (N, H, W, 1)
    assert all(np.isfinite(h["loss"]) for h in history_t)


def test_lr_schedule_matches_jax():
    from monodepth2_tpu.training.state import _lr_schedule

    cfg = JConfig(lr=1e-3, lr_warmup_steps=4, lr_decay_steps=6, lr_decay_factor=0.1)
    sched = _lr_schedule(cfg)
    for step in range(9):
        np.testing.assert_allclose(lr_at(TrainConfig(**asdict(cfg)), step), float(sched(step)), rtol=1e-6)


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.json")))
def test_configs_load_unchanged(path):
    """A configuration of the JAX package's network loads alike in both
    packages (the port's `architecture` at its default, and left out of its
    JSON); one that names the port's other network round-trips in the port
    and is refused by the JAX package."""
    text = open(path).read()
    port = TrainConfig.from_json(text)
    if json.loads(text).get("architecture", "monodepth2") != "monodepth2":
        assert TrainConfig.from_json(port.to_json()) == port
        with pytest.raises(TypeError, match="architecture"):
            JConfig.from_json(text)
        return
    assert asdict(port) == {**asdict(JConfig.from_json(text)), "architecture": "monodepth2"}
    assert json.loads(port.to_json()) == json.loads(JConfig.from_json(text).to_json())


def test_bf16_network_step_is_finite_and_close_to_fp32():
    """compute_dtype="bfloat16" runs the network under autocast and the loss
    in fp32; the first-step loss stays within bf16's 1e-2 of fp32's."""
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg = TrainConfig(**dict(BASE, compute_dtype=dtype))
        state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
        ctx = TrainContext.create(K, W, H, device="cpu")
        loss, aux = train_loss(state.model, torch.from_numpy(_batch(0, False)[0]), ctx, cfg)
        assert aux["disparity"].dtype == torch.float32
        losses[dtype] = loss.item()
    assert np.isfinite(losses["bfloat16"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=1e-2)


@pytest.mark.parametrize("shape", [(4, 8, 12, 16), (1, 1, 7, 32), (2, 4, 4, 64)])
def test_bf16_batchnorm_running_update_matches_jax(shape):
    """One BatchNorm layer in training mode on the same bf16 input, from the
    same float32 running stats: the JAX layer as the jitted bf16 step runs it
    (stats cast to bf16, training/loss.py:77) against the port's under a bf16
    input. Both round the carried stat, 1 − m, the batch moments and
    n/(n−1) to bf16 and sum in float32, so they agree to a few float32 ulps
    (the remaining rounding: the moments' float32 sums, taken in another
    order, could round to a different bf16 value at a tie; at these seeds
    none does). A (1, 1, 7, 32) input has n = 7, where n/(n−1) rounds to
    1.1640625. Torch's own float32 update, which the port used before,
    misses by m·|Δ| of the unrounded stat, ~5e-3 here."""
    n, h, w, c = shape
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(shape) * 1.5 + 0.3, jnp.bfloat16)
    stats = {"mean": rng.standard_normal(c).astype(np.float32), "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    jbn = JBatchNorm(c)
    params, _ = jbn.init(jax.random.PRNGKey(0))
    _, ref = jax.jit(lambda p, s, x: jbn(p, s, x, train=True))(
        cast_tree(params, jnp.bfloat16), cast_tree(stats, jnp.bfloat16), x
    )
    x_t = torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2)
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        bn = BatchNorm(c).train()
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        bn(x_t.to(dtype))
        got[dtype] = {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    for k in ("mean", "var"):
        want = np.asarray(ref[k], np.float32)
        gaps = {str(dtype): float(np.abs(got[dtype][k] - want).max()) for dtype in got}
        print(f"running {k} {shape}: largest gap to JAX {gaps}")  # pytest -s shows the record
        np.testing.assert_allclose(got[torch.bfloat16][k], want, rtol=5e-7, atol=1e-7, err_msg=k)
        # the float32 update, unmirrored, is far outside that tolerance
        assert gaps[str(torch.float32)] > 1e-3, k


@pytest.fixture(scope="module")
def bf16_run():
    """The base configuration in bf16 on both sides, from the same weights,
    and the JAX package in float32 beside it: first-step grads, and the
    loss, mean disparity and BN stats after each of 3 steps."""
    kw = dict(BASE, compute_dtype="bfloat16")
    keep = lambda history: [{k: h[k] for k in ("loss", "mean_disparity", "stats")} for h in history]
    init, grads_j, history_j = _jax_run(kw, False, jnp.float32)
    grads_t, history_t = _port_run(kw, False, init, torch.float32)
    _, grads_j32, history_j32 = _jax_run(BASE, False, jnp.float32)
    return dict(grads_j=grads_j, grads_t=grads_t, grads_j32=grads_j32,
                history_j=keep(history_j), history_t=keep(history_t), history_j32=keep(history_j32))


def _leaf_distances(got, ref, scale):
    """Per leaf, the L2 distance of got from ref over the L2 norm of scale."""
    got, ref, scale = dict(_leaves(got)), dict(_leaves(ref)), dict(_leaves(scale))
    assert got.keys() == ref.keys() == scale.keys()
    return np.asarray([
        np.linalg.norm(got[k].astype(np.float64) - ref[k]) / max(np.linalg.norm(scale[k].astype(np.float64)), 1e-30)
        for k in sorted(ref)
    ])


def _assert_within_jax_bf16_error(got, ref, ref_f32, factor=2.0):
    """Port-vs-JAX distances, leaf by leaf relative to the JAX float32 leaf,
    against the JAX bf16-vs-float32 distances: their largest and their mean
    over the leaves each within `factor` of the JAX ones. Leaf by leaf would
    not do: a one-element leaf (a disparity head's bias) carries one draw of
    the bf16 noise."""
    port = _leaf_distances(got, ref, ref_f32)
    jax_err = _leaf_distances(ref, ref_f32, ref_f32)
    print(f"port vs JAX bf16: max {port.max():.4g}, mean {port.mean():.4g}; "
          f"JAX bf16 vs float32: max {jax_err.max():.4g}, mean {jax_err.mean():.4g}")
    assert port.max() <= factor * jax_err.max(), (port.max(), jax_err.max())
    assert port.mean() <= factor * jax_err.mean(), (port.mean(), jax_err.mean())


def test_bf16_steps_loss_matches_jax(bf16_run):
    """Loss of each of 3 bf16 steps. The mean disparity is not compared: the
    port's after 2 steps moves over 0.31-0.40 when the frames change by 1e-6
    relative (Adam's first steps take the sign of each gradient element, and
    bf16 rounding flips ~15% of the signs at this shape), while the loss moves
    by ~1e-3 relative."""
    r = bf16_run
    losses = [[h["loss"] for h in r[k]] for k in ("history_t", "history_j", "history_j32")]
    port, ref, ref_f32 = (np.asarray(v) for v in losses)
    print(f"losses: port bf16 {port}, JAX bf16 {ref}, JAX float32 {ref_f32}")
    assert np.isfinite(port).all()
    assert np.abs(port - ref).max() <= 2 * np.abs(ref - ref_f32).max(), (port, ref, ref_f32)


def test_bf16_first_step_grads_match_jax(bf16_run):
    r = bf16_run
    _assert_within_jax_bf16_error(r["grads_t"], r["grads_j"], r["grads_j32"])


@pytest.mark.parametrize("step", [1, 2, 3])
def test_bf16_bn_stats_match_jax(bf16_run, step):
    r = bf16_run
    _assert_within_jax_bf16_error(
        r["history_t"][step - 1]["stats"], r["history_j"][step - 1]["stats"], r["history_j32"][step - 1]["stats"]
    )
