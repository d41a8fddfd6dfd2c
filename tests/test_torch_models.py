"""monodepth2_torch's models against the JAX package's, from the same weights
carried over by bridge.py, at a small size (64×32, batch 2, ResNet-18):
disparities at all 4 scales, poses and the new BN statistics, in train and in
eval mode. Tolerance: float32 through ~20 conv layers, 1e-4 rel / 1e-5 abs
(poses, scaled by 1e-2, 1e-7 abs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth2_tpu.models import Model as JModel
from monodepth2_torch.bridge import params_from_jax, params_to_jax
from monodepth2_torch.models import Model

W, H, N = 64, 32, 2
TOL = dict(rtol=1e-4, atol=1e-5)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_close(got, ref, **tol):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its weights (non-trivial BN stats and biases) and its
    outputs in both modes, computed once for the module."""
    jm = JModel.create(depth=18, in_channels=1, pose_tz_init=-0.3)
    params, stats = jm.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    perturb = lambda t, lo, hi: jax.tree_util.tree_map(
        lambda x: jnp.asarray(x + rng.uniform(lo, hi, x.shape), jnp.float32), t
    )
    stats = perturb(stats, 0.0, 0.2)
    params["depth_decoder"] = perturb(params["depth_decoder"], -0.02, 0.02)
    frames = rng.uniform(size=(N, 3, H, W, 1)).astype(np.float32)
    out = {}
    for train in (True, False):
        disps, poses, new_stats = jm(params, stats, jnp.asarray(frames), train=train)
        out[train] = (disps, poses, new_stats)
    eval_disps = jm.eval_disparity(params, stats, jnp.asarray(frames[:, 1]))
    return params, stats, frames, out, eval_disps


def _port(params, stats):
    model = Model.create(depth=18, in_channels=1, pose_tz_init=-0.3, device="cpu")
    model.load_state_dict(params_from_jax(params, stats))
    return model


@pytest.mark.parametrize("train", [True, False])
def test_model_forward_and_bn_stats(ref, train):
    params, stats, frames, out, _ = ref
    disps_j, poses_j, stats_j = out[train]
    model = _port(params, stats).train(train)
    with torch.no_grad():
        disps_t, poses_t = model(torch.from_numpy(frames))
    assert [tuple(d.shape) for d in disps_t] == [d.shape for d in disps_j]
    assert [d.shape[1:3] for d in disps_j] == [(4, 8), (8, 16), (16, 32), (32, 64)]
    for a, b in zip(disps_t, disps_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for (r_t, t_t), (r_j, t_j) in zip(poses_t, poses_j):
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=1e-4, atol=1e-7)
    _, new_stats = params_to_jax(model)
    assert_trees_close(new_stats, stats_j, **TOL)


def test_eval_disparity(ref):
    params, stats, frames, _, eval_disps = ref
    model = _port(params, stats)
    got = model.eval_disparity(torch.from_numpy(frames[:, 1]))
    assert model.training
    for a, b in zip(got, eval_disps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_bridge_round_trip(ref):
    params, stats, *_ = ref
    p, s = params_to_jax(_port(params, stats))
    assert_trees_close(p, params, rtol=0, atol=0)
    assert_trees_close(s, stats, rtol=0, atol=0)


def test_pose_tz_init_and_seeded_init():
    a = Model.create(pose_tz_init=-0.3, seed=5, device="cpu")
    b = Model.create(pose_tz_init=-0.3, seed=5, device="cpu")
    assert float(a.pose_decoder.p3.bias.detach()[5]) == pytest.approx(-30.0)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("depth", [34, 50])
def test_deeper_encoders_build_with_jax_structure(depth):
    """ResNet-34/50 carry the same parameter tree as the JAX encoders."""
    jm = JModel.create(depth=depth, in_channels=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    p, s = params_to_jax(Model.create(depth=depth, in_channels=3, device="cpu"))
    shape_leaves = lambda t: {
        jax.tree_util.keystr(k): tuple(v.shape)
        for k, v in jax.tree_util.tree_flatten_with_path(t)[0]
    }
    assert shape_leaves(p) == shape_leaves(shapes[0])
    assert shape_leaves(s) == shape_leaves(shapes[1])
