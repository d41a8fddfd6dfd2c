"""The hand-written CUDA kernels on the card, against their plain versions.

Needs a CUDA device: every test here is marked `gpu` and skips without one
(the kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q
"""

import importlib

import pytest
import torch

GS = importlib.import_module("monodepth2_torch.ops.grid_sample")

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, n, h, w, c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand((n, h, w, c), generator=gen)
    uv = torch.rand((n, h * w, 2), generator=gen) * 2.4 - 1.2
    uv[:, :8] = torch.tensor([[-1, 0.3], [1, -0.2], [0.1, -1], [-0.4, 1], [-1, -1], [1, 1], [-1.5, 0], [0, 2]])
    g = torch.randn((n, h * w, c), generator=gen)
    return img.to(dev), uv.to(dev), g.to(dev)


@pytest.mark.parametrize("shape", [(2, 12, 20, 1), (2, 12, 20, 3), (32, 128, 416, 1)])
def test_kernels_match_plain(dev, shape):
    img, uv, g = _case(dev, *shape)
    before = [k.launches for k in GS.KERNELS]
    torch.testing.assert_close(GS.grid_sample_fwd(img, uv), GS.grid_sample_fwd_plain(img, uv), rtol=0, atol=1e-6)
    torch.testing.assert_close(
        GS.grid_sample_bwd_uv(img, uv, g), GS.grid_sample_bwd_uv_plain(img, uv, g), rtol=1e-5, atol=1e-4
    )
    torch.cuda.synchronize()
    assert [k.launches for k in GS.KERNELS] == [n + 1 for n in before]


def test_autograd_through_kernels_matches_plain(dev):
    img, uv, g = _case(dev, 2, 16, 24, 1)
    grads = []
    for method in (None, "gather"):
        u = uv.clone().requires_grad_()
        GS.grid_sample(img, u, method=method).backward(g)
        grads.append(u.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-4)


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


def test_image_gradient_raises_naming_k3(dev):
    img, uv, _ = _case(dev, 2, 8, 8, 1)
    with pytest.raises(NotImplementedError, match="K3"):
        GS.grid_sample(img.requires_grad_(), uv)
