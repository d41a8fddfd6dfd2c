"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA device: every test here is marked `gpu` and skips without one
(the kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import importlib

import pytest
import torch

from monodepth2_torch.ops import geometry as PG
from monodepth2_torch.tools import kernel_ab, project_bench, warp_kernel_bench

GS = importlib.import_module("monodepth2_torch.ops.grid_sample")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n, h, w, c, seed=0, p=None):
    p = h * w if p is None else p
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((n, h, w, c), generator=gen)
    uv = torch.rand((n, p, 2), generator=gen) * 2.4 - 1.2
    uv[:, :8] = torch.tensor([[-1, 0.3], [1, -0.2], [0.1, -1], [-0.4, 1], [-1, -1], [1, 1], [-1.5, 0], [0, 2]])
    g = torch.randn((n, p, c), generator=gen)
    return img.to(dev), uv.to(dev), g.to(dev)


def _assert_dimg_close(img, uv, g, d_img):
    """K3's tolerance (tools.kernel_ab.dimg_checks): atomics sum in no fixed
    order, so each pixel may differ from the plain sum by 1e-5 of the sum of
    its terms' magnitudes, Σ_p |g·w|, + 1e-6; and d_img conserves Σ_p g over
    each image and channel (in float64, within that tolerance summed over
    the pixels)."""
    checks = kernel_ab.dimg_checks(img, uv, g, d_img)
    assert checks["excess"] <= 0 and checks["sum_excess"] <= 0, checks


@pytest.mark.parametrize("shape", [(2, 12, 20, 1), (2, 12, 20, 3), (32, 128, 416, 1), (32, 128, 416, 3)])
def test_kernels_match_plain(dev, shape):
    img, uv, g = _case(dev, *shape)
    before = [k.launches for k in GS.KERNELS]
    torch.testing.assert_close(GS.grid_sample_fwd(img, uv), GS.grid_sample_fwd_plain(img, uv), rtol=0, atol=1e-6)
    torch.testing.assert_close(
        GS.grid_sample_bwd_uv(img, uv, g), GS.grid_sample_bwd_uv_plain(img, uv, g), rtol=1e-5, atol=1e-4
    )
    _assert_dimg_close(img, uv, g, GS.grid_sample_bwd_img(img, uv, g))
    torch.cuda.synchronize()
    assert [k.launches for k in GS.KERNELS] == [n + 1 for n in before]


# The ragged and unaligned cases of K1/K2 (2 points a thread, uv and duv as
# one 8-B access a point where uv is 8-B aligned): a P that is odd and not a
# multiple of the 64 points a warp takes, a tiny image, uv and g as contiguous views one point into a
# larger buffer (uv 8 B, g 4·C B: not 16-B aligned), and one float into it
# (uv 4 B: the scalar uv path). C = 2 takes the generic-C kernel.
EDGE_CASES = {
    "odd P": dict(n=3, h=20, w=30, p=599),
    "tiny image": dict(n=3, h=37, w=53),
    "views one point in": dict(n=4, h=16, w=24, offset="point"),
    "views one float in": dict(n=4, h=16, w=24, p=383, offset="float"),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("c", [1, 2, 3])
def test_kernels_match_plain_on_ragged_and_offset_inputs(dev, case, c):
    kw = dict(EDGE_CASES[case])
    offset = kw.pop("offset", None)
    img, uv, g = _case(dev, c=c, **kw)
    if offset == "point":
        uv, g = warp_kernel_bench.offset_view(uv, 2), warp_kernel_bench.offset_view(g, c)
        assert uv.is_contiguous() and uv.data_ptr() % 16 and g.data_ptr() % 16
    elif offset == "float":
        uv, g = warp_kernel_bench.offset_view(uv, 1), warp_kernel_bench.offset_view(g, 1)
        assert uv.is_contiguous() and uv.data_ptr() % 8
    before = [k.launches for k in GS.KERNELS]
    torch.testing.assert_close(GS.grid_sample_fwd(img, uv), GS.grid_sample_fwd_plain(img, uv), rtol=0, atol=1e-6)
    torch.testing.assert_close(
        GS.grid_sample_bwd_uv(img, uv, g), GS.grid_sample_bwd_uv_plain(img, uv, g), rtol=1e-5, atol=1e-4
    )
    _assert_dimg_close(img, uv, g, GS.grid_sample_bwd_img(img, uv, g))
    torch.cuda.synchronize()
    assert [k.launches for k in GS.KERNELS] == [n + 1 for n in before]


@pytest.mark.parametrize("case", warp_kernel_bench.BWD_IMG_CASES)
@pytest.mark.parametrize("c", [1, 2, 3])
def test_image_vjp_on_both_paths_and_their_edges(dev, case, c):
    """K3 sums a block's terms in a band of rows in shared memory where its
    taps fit one, and otherwise adds them to d_img directly, border pixels
    through a shared copy: each case (warp_kernel_bench.bwd_img_case) is
    within K3's tolerance."""
    img, uv, g = warp_kernel_bench.bwd_img_case(case, c, torch.Generator().manual_seed(0), dev)
    before = GS.grid_sample_bwd_img.launches
    d_img = GS.grid_sample_bwd_img(img, uv, g)
    torch.cuda.synchronize()
    assert GS.grid_sample_bwd_img.launches == before + 1
    assert bool(torch.isfinite(d_img).all())
    _assert_dimg_close(img, uv, g, d_img)


def test_image_gradient_clamped_taps_add_both_weights(dev):
    """At the right and bottom borders x1 = x0 and y1 = y0: both weights of a
    clamped tap pair land on one pixel, as in the plain scatter."""
    img = torch.rand((1, 4, 5, 2), device=dev)
    uv = torch.tensor([[[1.0, 1.0], [1.0, -0.3], [0.2, 1.0], [1.7, 2.0]]], device=dev)
    g = torch.tensor([[[1.0, 2.0], [3.0, -1.0], [0.5, 0.25], [2.0, 4.0]]], device=dev)
    d_img = GS.grid_sample_bwd_img(img, uv, g)
    _assert_dimg_close(img, uv, g, d_img)
    torch.testing.assert_close(d_img.sum(dim=(1, 2)), g.sum(dim=1), rtol=0, atol=1e-6)


def test_autograd_through_kernels_matches_plain(dev):
    img, uv, g = _case(dev, 2, 16, 24, 3)
    grads = []
    before = [k.launches for k in GS.KERNELS]
    for method in (None, "gather"):
        i, u = img.clone().requires_grad_(), uv.clone().requires_grad_()
        GS.grid_sample(i, u, method=method).backward(g)
        grads.append((i.grad, u.grad))
    torch.cuda.synchronize()
    assert [k.launches for k in GS.KERNELS] == [n + 1 for n in before]
    _assert_dimg_close(img, uv, g, grads[0][0])
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5, atol=1e-4)


def test_uv_only_gradient_launches_no_image_vjp(dev):
    img, uv, g = _case(dev, 2, 16, 24, 1)
    before = GS.grid_sample_bwd_img.launches
    u = uv.clone().requires_grad_()
    GS.grid_sample(img, u).backward(g)
    assert GS.grid_sample_bwd_img.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    img, uv, g = _case(dev, 2, 8, 8, 1)
    with pytest.raises(TypeError):
        GS.grid_sample_fwd(img.double(), uv)
    with pytest.raises(ValueError):
        GS.grid_sample_fwd(img, uv[:, ::2])
    with pytest.raises(ValueError):
        GS.grid_sample_fwd(img, uv[:1])
    with pytest.raises(ValueError):
        GS.grid_sample_bwd_uv(img, uv, g[:, :-1])
    with pytest.raises(ValueError):
        GS.grid_sample_bwd_img(img, uv, g[:, :-1])
    with pytest.raises(TypeError):
        GS.grid_sample_bwd_img(img, uv, g.double())
    with pytest.raises(ValueError):
        GS.grid_sample_bwd_img(img, uv.cpu(), g)


# project's kernels: batch 4's shape for one source (S·batch = 16 items of
# 128×416) and an odd size that is no multiple of a block (37×23)
PROJECT_SHAPES = [(16, 128, 416), (3, 23, 37)]


def _rel_fro(x, ref) -> float:
    return float((x.double() - ref.double()).norm() / ref.double().norm())


@pytest.mark.parametrize("per_item_K", [False, True])
@pytest.mark.parametrize("n, h, w", PROJECT_SHAPES)
def test_project_kernels_match_plain(dev, n, h, w, per_item_K):
    """project_fwd and project_bwd against their plain twins on the card,
    with a point behind the camera and one at c_z = 1e-2 in every item:
    uv within 1e-6; d_points within 1e-5 relative + 1e-6; dR and dt within
    1e-5 relative Frobenius; two backward runs the same bits; one launch
    each. (Both sides recompute c in fp32 with the same operations; against
    a float64 twin both are off by ~2e-2 here, all from the c_z = 1e-2
    point, whose fp32 c_z carries the rounding of its 1-100 m terms.)"""
    points, K, R, t, g = project_bench.make_inputs(n, h, w, dev, per_item_K, seed=n)
    before = [k.launches for k in PG.KERNELS]
    uv = PG.project_fwd(points, K, R, t, w, h)
    d_points, dR, dt = PG.project_bwd(points, K, R, t, g, w, h)
    torch.cuda.synchronize()
    assert [k.launches for k in PG.KERNELS] == [x + 1 for x in before]
    torch.testing.assert_close(uv, PG.project_plain(points, K, R, t, w, h), rtol=0, atol=1e-6)
    plain = PG.project_bwd_plain(points, K, R, t, g, w, h)
    torch.testing.assert_close(d_points, plain[0], rtol=1e-5, atol=1e-6)
    assert _rel_fro(dR, plain[1]) <= 1e-5 and _rel_fro(dt, plain[2]) <= 1e-5, (
        _rel_fro(dR, plain[1]), _rel_fro(dt, plain[2]))
    again = PG.project_bwd(points, K, R, t, g, w, h)
    assert all(torch.equal(a, b) for a, b in zip(again, (d_points, dR, dt)))


@pytest.mark.parametrize("per_item_K", [False, True])
def test_project_replayed_in_a_graph_equals_eager(dev, per_item_K):
    """project forward and backward through the autograd Function, captured
    in a CUDA graph: a replay gives the eager call's bits, and the capture is
    one launch of each kernel."""
    n, h, w = 4, 23, 37
    points, K, R, t, g = project_bench.make_inputs(n, h, w, dev, per_item_K)

    def run():
        xs = [x.detach().requires_grad_() for x in (points, R, t)]
        uv = PG.project(xs[0], K, xs[1], xs[2], w, h)
        return (uv.detach(), *torch.autograd.grad(uv, xs, g))

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # warm-up on a side stream, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    before = [k.launches for k in PG.KERNELS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    assert [k.launches for k in PG.KERNELS] == [x + 1 for x in before]
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert [k.launches for k in PG.KERNELS] == [x + 1 for x in before]
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_project_refuses_what_the_kernels_do_not_take(dev):
    """On the card the projection never falls back to the plain version."""
    points, K, R, t, g = project_bench.make_inputs(2, 8, 8, dev)
    with pytest.raises(TypeError):
        PG.project_fwd(points.double(), K.double(), R.double(), t.double(), 8, 8)
    with pytest.raises(TypeError):
        PG.project(points.double(), K, R.double(), t.double(), 8, 8)
    with pytest.raises(ValueError):
        PG.project_fwd(points[:, ::2], K, R, t, 8, 8)
    with pytest.raises(ValueError):
        PG.project_bwd(points, K, R, t, g.transpose(0, 1).contiguous().transpose(0, 1), 8, 8)
    with pytest.raises(ValueError):
        PG.project_fwd(points, K[None].expand(3, 3, 3).contiguous(), R, t, 8, 8)
    with pytest.raises(ValueError):
        PG.project_bwd(points, K, R, t, g[:, :-1], 8, 8)
    with pytest.raises(ValueError):
        PG.project_fwd(points, K.cpu(), R, t, 8, 8)
    with pytest.raises(ValueError, match="K"):
        PG.project(points, K.clone().requires_grad_(), R, t, 8, 8)


def test_project_gather_is_the_plain_version_on_the_card(dev):
    """method="gather" projects through project_plain on the card: float64,
    a gradient for K, and no kernel launched."""
    points, K, R, t, g = (x.double() for x in project_bench.make_inputs(2, 8, 8, dev))
    K = K.requires_grad_()
    before = [k.launches for k in PG.KERNELS]
    uv = PG.project(points, K, R, t, 8, 8, method="gather")
    (d_K,) = torch.autograd.grad(uv, K, g)
    assert uv.dtype == torch.float64 and bool(torch.isfinite(d_K).all())
    assert torch.equal(uv, PG.project_plain(points, K, R, t, 8, 8))
    assert [k.launches for k in PG.KERNELS] == before


@pytest.fixture
def exact_convs(dev):
    """fp32 convolutions without TF32, deterministic algorithms; restored."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    torch.backends.cudnn.benchmark = False
    yield dev
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _train_setup(dev, **kw):
    import copy

    import numpy as np

    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state

    w, h, n = 64, 32, 2
    cfg = TrainConfig(
        target_size=(w, h), batch_size=n, steps_per_call=4, disp_reg=0.01, disp_reg_steps=6,
        lr_warmup_steps=4, lr_decay_steps=6, lr_decay_factor=0.5, **kw,
    )
    K = np.asarray([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, w, h, device=dev)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(10, n, 3, h, w, 1)).astype(np.float32)).to(dev)

    def new_state():
        return create_train_state(Model.create(depth=18, in_channels=1, device=dev), cfg)

    def load_twin(twin, state):
        twin.model.load_state_dict(state.model.state_dict())
        twin.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        twin.step = state.step

    return cfg, ctx, frames, new_state, load_twin


def _rel_l2(xs, ys) -> float:
    """Relative L2 distance of two lists of tensors, taken as one vector."""
    x = torch.cat([t.detach().flatten().double() for t in xs])
    y = torch.cat([t.detach().flatten().double() for t in ys])
    return float((x - y).norm() / y.norm())


def _adam_state(state, key):
    return [state.optimizer.state[p][key] for p in state.model.parameters()]


# bounds on the relative L2 distance of (params, Adam's moments) after a
# replayed update from the eager one's, by the network's dtype. One update
# moves the 1.6e7 params by 4.8e-4 to 1.4e-3 of their norm at these steps,
# and a skipped Adam step leaves the moments far apart. What remains is the
# rounding of CUDA's atomic adds (reflect-pad, upsample backward), in no
# fixed order, which bf16's 8-bit adds make larger: `PYTHONPATH=. python
# tests/test_torch_cuda.py` prints the distances on the card
REPLAY_BOUNDS = {"float32": (1e-6, 1e-4), "bfloat16": (5e-5, 5e-2)}
REPLAY_CASES = [("float32", False), ("bfloat16", False), ("float32", True)]


def _replays_against_eager(dev, compute_dtype, per_item_K):
    """Warm the scanned step up, then replay steps 3-8 one call each, each
    from the state of an eager twin that takes the same step. Returns (cfg,
    the per-step comparisons, the last aux, and a function that replays step
    9)."""
    from monodepth2_torch.training import make_scanned_train_step, make_train_step
    from monodepth2_torch.training.state import WARMUP_STEPS, lr_at

    cfg, ctx, frames, new_state, load_twin = _train_setup(dev, compute_dtype=compute_dtype, per_item_K=per_item_K)
    Ks = ctx.K.expand(10, 2, 3, 3) * torch.linspace(0.8, 1.2, 10, device=dev).view(10, 1, 1, 1)
    Ks[..., 2, 2] = 1.0

    def batch(lo, hi):
        return {"frames": frames[lo:hi], "K": Ks[lo:hi]} if per_item_K else frames[lo:hi]

    state, twin = new_state(), new_state()
    scanned, eager = make_scanned_train_step(ctx, cfg), make_train_step(ctx, cfg)
    _, m, _ = scanned(state, batch(0, WARMUP_STEPS))
    assert state.step == WARMUP_STEPS and m["loss"].shape == (WARMUP_STEPS,)
    rows = []
    for i in range(WARMUP_STEPS, 9):
        load_twin(twin, state)
        step = state.step
        _, m, aux = scanned(state, batch(i, i + 1))
        _, tm, _ = eager(twin, {"frames": frames[i], "K": Ks[i]} if per_item_K else frames[i])
        rows.append(dict(
            step=step, loss=m["loss"][0], twin_loss=tm["loss"], lr=m["lr"][0].item(),
            lr_adam=state.optimizer.param_groups[0]["lr"].item(), lr_at=lr_at(cfg, step),
            disp_reg_weight=m["disp_reg_weight"][0].item(),
            params=_rel_l2(state.model.parameters(), twin.model.parameters()),
            **{key: _rel_l2(_adam_state(state, key), _adam_state(twin, key)) for key in ("exp_avg", "exp_avg_sq")},
            adam_steps_equal=all(
                torch.equal(a, b) for a, b in zip(_adam_state(state, "step"), _adam_state(twin, "step"))
            ),
        ))
    return cfg, rows, aux, lambda: scanned(state, batch(9, 10))


@pytest.mark.parametrize("compute_dtype, per_item_K", REPLAY_CASES)
def test_captured_step_replays_the_eager_step(exact_convs, compute_dtype, per_item_K):
    """The scanned step warms up eagerly, captures one step as a CUDA graph
    and replays it: from the same state, each replayed step's loss, the lr
    Adam read and the disp_reg weight equal an eager step's while both
    schedules change, and the params and Adam's moments after the update
    are within REPLAY_BOUNDS of the eager step's, so that a replay that
    skipped Adam's step, or ran it with a frozen lr (a third or half of the
    update off at steps 3-5), fails. With per-item intrinsics the graph
    copies each step's K into its own buffer too."""
    cfg, rows, aux, replay_next = _replays_against_eager(exact_convs, compute_dtype, per_item_K)
    param_bound, moment_bound = REPLAY_BOUNDS[compute_dtype]
    for r in rows:
        torch.testing.assert_close(r["loss"], r["twin_loss"], rtol=1e-5, atol=0)
        assert r["lr"] == pytest.approx(r["lr_at"], rel=1e-6)
        assert r["lr_adam"] == pytest.approx(r["lr_at"], rel=1e-6)
        assert r["disp_reg_weight"] == pytest.approx(
            cfg.disp_reg * min(max(1 - r["step"] / cfg.disp_reg_steps, 0), 1), rel=1e-6, abs=1e-12
        )
        assert r["params"] <= param_bound, r
        assert r["exp_avg"] <= moment_bound and r["exp_avg_sq"] <= moment_bound, r
        assert r["adam_steps_equal"], r
    assert aux["disparity"].shape == (2, 32, 64, 1)
    # aux is a copy: a later replay leaves it alone
    before = aux["disparity"].clone()
    replay_next()
    assert torch.equal(aux["disparity"], before)


def test_device_prefetch_copies_to_the_card(dev):
    """Pinned, side-stream copies: the batches arrive on the card equal to
    the arrays, in order, arrays and {"frames", "K"} dicts alike."""
    import numpy as np

    from monodepth2_torch.data import device_prefetch

    batches = [np.random.default_rng(i).uniform(size=(4, 3, 8, 8, 1)) for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device=dev))
    assert len(out) == 5
    for a, b in zip(out, batches):
        assert a.is_cuda and a.dtype == torch.float32
        assert torch.equal(a.cpu(), torch.from_numpy(b.astype(np.float32)))
    d = next(device_prefetch(iter([{"frames": batches[0], "K": np.eye(3)}]), device=dev))
    assert d["frames"].is_cuda and d["K"].is_cuda and torch.equal(d["K"].cpu(), torch.eye(3))


def test_scanned_step_is_bound_to_its_state(exact_convs):
    from monodepth2_torch.training import make_scanned_train_step

    cfg, ctx, frames, new_state, _ = _train_setup(exact_convs)
    scanned = make_scanned_train_step(ctx, cfg)
    scanned(new_state(), frames[:1])
    with pytest.raises(ValueError):
        scanned(new_state(), frames[:1])


def test_capturable_adam_matches_adam(dev):
    """The card's capturable Adam (a tensor lr, step counts on the card) and
    Adam as the CPU runs it take the same update from the same grads, but
    for the bias corrections: capturable Adam takes 1 − β2^t in float32 on
    the card (as optax does), where the CPU's Adam takes it in Python
    floats. At t = 1 float32(0.999) makes 1 − β2 off by 1.3e-5 of itself,
    so each update may differ by ~1e-5 of its size (~lr); and it adds the
    update in another association (p + m / (denom / -step)), which may
    round p differently by a few ulp."""
    gen = torch.Generator().manual_seed(0)
    params = [torch.randn(s, generator=gen).to(dev) for s in ((64, 3, 3, 3), (64,), (7,))]
    grads = [[torch.randn(p.shape, generator=gen).to(dev) for p in params] for _ in range(4)]
    outs = []
    for capturable in (True, False):
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        lr = torch.full((), 1e-3, device=dev) if capturable else torch.full((), 1e-3)
        opt = torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable, foreach=capturable)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = g.clone()
            opt.step()
        outs.append(ps)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=4 * 2.0**-23, atol=2e-5 * 1e-3 * len(grads))


if __name__ == "__main__":
    # the replays' distances from their eager twins, three runs of each case
    import json

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    for run in range(3):
        for compute_dtype, per_item_K in REPLAY_CASES:
            _, rows, _, _ = _replays_against_eager(torch.device("cuda"), compute_dtype, per_item_K)
            keys = ("step", "params", "exp_avg", "exp_avg_sq")
            print(json.dumps(dict(run=run, compute_dtype=compute_dtype, per_item_K=per_item_K,
                                  rows=[{k: r[k] for k in keys} for r in rows])), flush=True)
