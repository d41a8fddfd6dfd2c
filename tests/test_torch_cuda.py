"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA device: every test here is marked `gpu` and skips without one
(the kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import importlib

import pytest
import torch

from monodepth2_torch.tools import kernel_ab, warp_kernel_bench

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
