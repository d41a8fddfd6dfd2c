"""monodepth2_torch's grid sample against the JAX package's: the plain
version against `_grid_sample_gather` on interior points, and the op against
`grid_sample_pallas(precise=True, interpret=True)` with exact-border and
out-of-range points, which pins the Pallas border rule of the coordinate
gradient. Tolerances are those of tests/test_pallas_kernel.py: forward 1e-6
abs, coordinate gradient 1e-4 abs / 1e-5 rel, image gradient 1e-5 abs."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth2_tpu.ops.grid_sample import _grid_sample_gather
from monodepth2_tpu.ops.pallas import grid_sample_pallas

# the module, not the function of the same name that ops/__init__ exports
GS = importlib.import_module("monodepth2_torch.ops.grid_sample")


def _case(seed, n, h, w, c, p, lo, hi):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(n, h, w, c)).astype(np.float32)
    uv = rng.uniform(lo, hi, size=(n, p, 2)).astype(np.float32)
    g = rng.normal(size=(n, p, c)).astype(np.float32)
    return img, uv, g


def _border_case(seed=5, n=2, h=12, w=20, c=1):
    """Interior points plus every kind of border point: exactly on each edge
    and corner, and beyond it."""
    img, uv, g = _case(seed, n, h, w, c, 40, -0.9, 0.9)
    edges = np.asarray(
        [[-1, 0.3], [1, -0.2], [0.1, -1], [-0.4, 1], [-1, -1], [1, 1],
         [-1.3, 0.2], [1.2, 0.5], [0.3, -1.5], [0.6, 1.1], [-2, 3], [1, 1.4]],
        np.float32,
    )
    uv[:, : len(edges)] = edges
    return img, uv, g


def _jax_vjp(fn, img, uv, g):
    out, vjp = jax.vjp(fn, jnp.asarray(img), jnp.asarray(uv))
    d_img, d_uv = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(d_img), np.asarray(d_uv)


def _torch_vjp(img, uv, g, image_grad=True):
    img_t = torch.tensor(img, requires_grad=image_grad)
    uv_t = torch.tensor(uv, requires_grad=True)
    out = GS.grid_sample(img_t, uv_t)
    out.backward(torch.from_numpy(g))
    d_img = img_t.grad.numpy() if image_grad else None
    return out.detach().numpy(), d_img, uv_t.grad.numpy()


@pytest.mark.parametrize("c", [1, 3])
def test_plain_matches_gather_interior(c):
    img, uv, g = _case(0, 2, 10, 14, c, 60, -0.95, 0.95)
    out_j, dimg_j, duv_j = _jax_vjp(_grid_sample_gather, img, uv, g)
    np.testing.assert_allclose(
        GS.grid_sample_fwd_plain(torch.from_numpy(img), torch.from_numpy(uv)).numpy(),
        out_j, atol=1e-6,
    )
    out_t, dimg_t, duv_t = _torch_vjp(img, uv, g)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    np.testing.assert_allclose(duv_t, duv_j, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dimg_t, dimg_j, atol=1e-5)


@pytest.mark.parametrize("c", [1, 3])
def test_matches_pallas_with_border_points(c):
    img, uv, g = _border_case(c=c)
    pallas = lambda i, u: grid_sample_pallas(i, u, precise=True, interpret=True)
    out_j, dimg_j, duv_j = _jax_vjp(pallas, img, uv, g)
    out_t, dimg_t, duv_t = _torch_vjp(img, uv, g)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    np.testing.assert_allclose(duv_t, duv_j, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dimg_t, dimg_j, atol=1e-5)


def test_matches_pallas_column_banded_full_grid():
    """A full H×W grid wider than 128 columns takes the Pallas column-band
    kernels (K1b, K2b, K3b with its fold of overlapping windows), the
    training default."""
    h, w = 8, 160
    img, _, g = _case(6, 1, h, w, 1, h * w, -1, 1)
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    shift = np.random.default_rng(7).uniform(-0.02, 0.02, size=(h * w, 2))
    uv = (np.stack([xs, ys], -1).reshape(1, h * w, 2) + shift).astype(np.float32)
    uv[0, 0] = (-1.0, -1.0)
    pallas = lambda i, u: grid_sample_pallas(i, u, precise=True, interpret=True)
    out_j, dimg_j, duv_j = _jax_vjp(pallas, img, uv, g)
    out_t, dimg_t, duv_t = _torch_vjp(img, uv, g)
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    np.testing.assert_allclose(duv_t, duv_j, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(dimg_t, dimg_j, atol=1e-5)


def test_border_rule_pins_pallas_not_gather():
    """u = -1 (column 0): Pallas counts the sample as inside and gives the
    full one-sided slope; the gather path's clip tie gives half of it."""
    img, _, _ = _case(8, 1, 6, 9, 1, 1, 0, 1)
    uv = np.asarray([[[-1.0, 0.1]]], np.float32)
    g = np.ones((1, 1, 1), np.float32)
    _, _, duv_pallas = _jax_vjp(
        lambda i, u: grid_sample_pallas(i, u, precise=True, interpret=True), img, uv, g
    )
    _, _, duv_gather = _jax_vjp(_grid_sample_gather, img, uv, g)
    _, _, duv_t = _torch_vjp(img, uv, g, image_grad=False)
    assert abs(duv_t[0, 0, 0]) > 0
    np.testing.assert_allclose(duv_t[0, 0, 0], duv_pallas[0, 0, 0], rtol=1e-5)
    np.testing.assert_allclose(duv_t[0, 0, 0], 2 * duv_gather[0, 0, 0], rtol=1e-5)


def test_wrappers_on_cpu_use_plain_and_count_no_launch():
    img, uv, g = _border_case(c=2)
    img_t, uv_t, g_t = map(torch.from_numpy, (img, uv, g))
    before = [k.launches for k in GS.KERNELS]
    torch.testing.assert_close(
        GS.grid_sample_fwd(img_t, uv_t), GS.grid_sample_fwd_plain(img_t, uv_t), rtol=0, atol=0
    )
    torch.testing.assert_close(
        GS.grid_sample_bwd_uv(img_t, uv_t, g_t),
        GS.grid_sample_bwd_uv_plain(img_t, uv_t, g_t),
        rtol=0, atol=0,
    )
    torch.testing.assert_close(
        GS.grid_sample_bwd_img(img_t, uv_t, g_t),
        GS.grid_sample_bwd_img_plain(img_t, uv_t, g_t),
        rtol=0, atol=0,
    )
    assert len(GS.KERNELS) == 3
    assert [k.launches for k in GS.KERNELS] == before


def test_gather_method_is_plain_and_onehot_is_refused():
    img, uv, _ = _border_case()
    img_t, uv_t = torch.from_numpy(img), torch.from_numpy(uv)
    torch.testing.assert_close(
        GS.grid_sample(img_t, uv_t, method="gather"), GS.grid_sample(img_t, uv_t), rtol=0, atol=0
    )
    with pytest.raises(ValueError):
        GS.grid_sample(img_t, uv_t, method="onehot")
