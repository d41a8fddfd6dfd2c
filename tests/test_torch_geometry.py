"""monodepth2_torch.ops.geometry against monodepth2_tpu.ops.geometry: the same
numpy-seeded float32 inputs through both, forward values and the gradients
of a random linear read-out (tolerance: float32 rounding, 1e-5 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth2_tpu.ops import geometry as G
from monodepth2_torch.ops import geometry as T

RTOL, ATOL = 1e-5, 1e-6


def _f32(rng, *shape, low=-1.0, high=1.0):
    return rng.uniform(low, high, size=shape).astype(np.float32)


def _check(jax_fn, torch_fn, inputs, seed=0, rtol=RTOL, atol=ATOL):
    """Compare outputs and d<out, W>/d inputs for a float32 function."""
    out_j = jax_fn(*[jnp.asarray(x) for x in inputs])
    w = np.random.default_rng(seed + 100).normal(size=out_j.shape).astype(np.float32)

    def readout(*xs):
        return jnp.sum(jax_fn(*xs) * jnp.asarray(w))

    grads_j = jax.grad(readout, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs]
    )
    xs_t = [torch.tensor(x, requires_grad=True) for x in inputs]
    out_t = torch_fn(*xs_t)
    torch.sum(out_t * torch.from_numpy(w)).backward()
    assert out_j.dtype == jnp.float32
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=rtol, atol=atol)
    for x_t, g_j in zip(xs_t, grads_j):
        g_t = x_t.grad if x_t.grad is not None else torch.zeros_like(x_t)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=rtol, atol=atol)


def test_safe_sqrt_zero_subgradient():
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    T.safe_sqrt(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.25]
    _check(G.safe_sqrt, T.safe_sqrt, [np.asarray([0.0, 0.5, 2.0], np.float32)])


def test_hat_and_so3_exp_map():
    rng = np.random.default_rng(0)
    rvec = _f32(rng, 5, 3)
    _check(G.hat, T.hat, [rvec])
    _check(G.so3_exp_map, T.so3_exp_map, [rvec])


def test_so3_exp_map_at_zero_rotation():
    """θ = 0 takes the clamped branch; the gradient stays finite and equal."""
    rvec = np.zeros((2, 3), np.float32)
    _check(G.so3_exp_map, T.so3_exp_map, [rvec])


@pytest.mark.parametrize("invert", [False, True])
def test_compose_transform(invert):
    rng = np.random.default_rng(1)
    rvec, tvec = _f32(rng, 3, 3), _f32(rng, 3, 3, 1)
    for k in (0, 1):
        _check(
            lambda r, t: G.compose_transform(r, t, invert)[k],
            lambda r, t: T.compose_transform(r, t, invert)[k],
            [rvec, tvec],
        )


def test_pixel_grid():
    np.testing.assert_array_equal(
        T.pixel_grid(7, 5).numpy(), np.asarray(G.pixel_grid(7, 5, jnp.float32))
    )


def test_invert_intrinsics():
    rng = np.random.default_rng(2)
    K = np.tile(np.asarray([[50.0, 0.3, 32.0], [0, 48.0, 16.0], [0, 0, 1.0]], np.float32), (3, 1, 1))
    K = (K + _f32(rng, 3, 3, 3, low=-0.5, high=0.5) * np.asarray([[1, 1, 1], [0, 1, 1], [0, 0, 0]])).astype(np.float32)
    _check(G.invert_intrinsics, T.invert_intrinsics, [K], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("per_item_K", [False, True])
def test_backproject_project(per_item_K):
    rng = np.random.default_rng(3)
    n, w, h = 2, 8, 6
    K = np.asarray([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1.0]], np.float32)
    if per_item_K:
        K = np.stack([K, K * np.asarray([[1.1], [0.9], [1.0]], np.float32)])
    invK = np.linalg.inv(K.astype(np.float64)).astype(np.float32)
    grid = np.array(G.pixel_grid(w, h, jnp.float32))
    depth = _f32(rng, n, h * w, low=1.0, high=5.0)
    R = np.asarray(G.so3_exp_map(jnp.asarray(_f32(rng, n, 3, low=-0.1, high=0.1))))
    t = _f32(rng, n, 3, 1, low=-0.2, high=0.2)

    _check(
        lambda d, ik: G.backproject(d, ik, jnp.asarray(grid)),
        lambda d, ik: T.backproject(d, ik, torch.from_numpy(grid)),
        [depth, invK],
    )
    points = np.asarray(G.backproject(jnp.asarray(depth), jnp.asarray(invK), jnp.asarray(grid)))
    _check(
        lambda p, k, r, tt: G.project(p, k, r, tt, w, h),
        lambda p, k, r, tt: T.project(p, k, r, tt, w, h),
        [points, K, R, t],
        rtol=1e-4,
        atol=1e-5,
    )


def test_disparity_to_depth():
    rng = np.random.default_rng(4)
    disp = _f32(rng, 2, 4, 5, 1, low=0.01, high=0.99)
    _check(
        lambda d: G.disparity_to_depth(d, 0.1, 100.0),
        lambda d: T.disparity_to_depth(d, 0.1, 100.0),
        [disp],
    )


def _project_case(per_item_K, dtype=np.float32, n=3, w=8, h=6, seed=5):
    """project's inputs at a tiny size, with one point behind the camera and
    one with c_z near 0 in each item; and a cotangent g (N,HW,2)."""
    rng = np.random.default_rng(seed)
    K = np.asarray([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1.0]])
    if per_item_K:
        K = K * rng.uniform(0.8, 1.2, size=(n, 3, 1)) * np.asarray([[1.0], [1.0], [0.0]]) + np.asarray(
            [[0, 0, 0], [0, 0, 0], [0, 0, 1.0]]
        )
    R = np.asarray(G.so3_exp_map(jnp.asarray(rng.uniform(-0.1, 0.1, size=(n, 3)).astype(np.float32))))
    t = rng.uniform(-0.2, 0.2, size=(n, 3, 1))
    points = rng.uniform(-2.0, 2.0, size=(n, h * w, 3))
    points[..., 2] = rng.uniform(1.0, 5.0, size=(n, h * w))
    points[:, 0, 2] = -3.0  # behind the camera
    # c_z = (R p + t)_z = 0.05: solve for p_z
    points[:, 1, 2] = (0.05 - t[:, 2, 0] - R[:, 2, 0] * points[:, 1, 0] - R[:, 2, 1] * points[:, 1, 1]) / R[:, 2, 2]
    g = rng.normal(size=(n, h * w, 2))
    return [x.astype(dtype) for x in (points, K, R, t, g)], (w, h)


@pytest.mark.parametrize("per_item_K", [False, True])
def test_project_function_matches_autograd(per_item_K):
    """The Function's plain forward equals project_plain, and its written-out
    backward equals autograd of project_plain, in float64 (1e-12)."""
    (points, K, R, t, g), (w, h) = _project_case(per_item_K, np.float64)
    xs = [torch.tensor(x, requires_grad=True) for x in (points, R, t)]
    K, g = torch.from_numpy(K), torch.from_numpy(g)
    ref = T.project_plain(xs[0], K, xs[1], xs[2], w, h)
    grads_ref = torch.autograd.grad(ref, xs, g)
    out = T._Project.apply(xs[0], K, xs[1], xs[2], w, h, 1e-7)
    grads = torch.autograd.grad(out, xs, g)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
    for got, want in zip(grads, grads_ref):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.equal(T.project(xs[0], K, xs[1], xs[2], w, h), ref)  # the CPU path is the plain one
    assert [k.launches for k in T.KERNELS] == [0, 0]  # no launch on the CPU


@pytest.mark.parametrize("per_item_K", [False, True])
def test_project_bwd_matches_jax_vjp(per_item_K):
    """d_points, dR and dt of the written-out backward, and of the Function,
    against jax.vjp of the JAX package's project (float32, 1e-4 relative as
    test_backproject_project)."""
    (points, K, R, t, g), (w, h) = _project_case(per_item_K)
    _, vjp = jax.vjp(lambda p, r, tt: G.project(p, jnp.asarray(K), r, tt, w, h), *map(jnp.asarray, (points, R, t)))
    want = vjp(jnp.asarray(g))
    args = [torch.from_numpy(x) for x in (points, K, R, t, g)]
    plain = T.project_bwd_plain(*args, w, h)
    xs = [a.clone().requires_grad_() for a in (args[0], args[2], args[3])]
    function = torch.autograd.grad(T._Project.apply(xs[0], args[1], xs[1], xs[2], w, h, 1e-7), xs, args[4])
    for got in (plain, function):
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), rtol=1e-4, atol=1e-5)


def test_project_function_refuses_a_gradient_for_K():
    (points, K, R, t, _), (w, h) = _project_case(False)
    args = [torch.from_numpy(x) for x in (points, K, R, t)]
    with pytest.raises(ValueError, match="K"):
        T._Project.apply(args[0], args[1].requires_grad_(), args[2], args[3], w, h, 1e-7)
