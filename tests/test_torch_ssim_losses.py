"""monodepth2_torch's layers, SSIM and losses against the JAX package's on the
same numpy-seeded float32 inputs (NHWC at the public functions, as there).
Tolerance: float32 rounding of short reductions, 1e-5 abs / 1e-5 rel unless
stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monodepth2_tpu.nn import core as JC
from monodepth2_tpu.ops import losses as JL
from monodepth2_tpu.ops.geometry import compose_transform as j_compose
from monodepth2_tpu.ops.geometry import pixel_grid as j_grid
from monodepth2_tpu.ops.ssim import ssim as j_ssim
from monodepth2_torch.bridge import params_from_jax
from monodepth2_torch.nn import core as TC
from monodepth2_torch.ops import losses as TL
from monodepth2_torch.ops.geometry import compose_transform as t_compose
from monodepth2_torch.ops.geometry import pixel_grid as t_grid
from monodepth2_torch.ops.ssim import ssim as t_ssim

TOL = dict(rtol=1e-5, atol=1e-5)


def _imgs(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("shape,pad", [((2, 6, 10, 3), 1), ((1, 1, 2, 2), 1), ((1, 2, 3, 1), 4)])
def test_reflect_pad(shape, pad):
    """Also maps no larger than the pad (the 64×32 bottleneck is 1×2)."""
    x = _imgs(0, *shape)
    np.testing.assert_array_equal(
        _nhwc(TC.reflect_pad(_nchw(x), pad)), np.asarray(JC.reflect_pad(jnp.asarray(x), pad))
    )


def test_mean_pool_max_pool_upsample():
    x = _imgs(0, 2, 6, 10, 3)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(_nhwc(TC.mean_pool(_nchw(x))), np.asarray(JC.mean_pool(xj)), **TOL)
    np.testing.assert_array_equal(
        _nhwc(TC.max_pool(_nchw(x) - 2.0, 3, 2, 1)),
        np.asarray(JC.max_pool(xj - 2.0, window=3, stride=2, padding=1)),
    )
    for kw in (dict(scale=2), dict(size=(16, 24))):
        np.testing.assert_allclose(
            _nhwc(TC.upsample_bilinear(_nchw(x), **kw)), np.asarray(JC.upsample_bilinear(xj, **kw)), **TOL
        )


@pytest.mark.parametrize("padding", [1, "reflect"])
def test_conv_from_bridged_weights(padding):
    layer = JC.Conv(3, 5, 3, 1, padding, act=jax.nn.elu)
    params, _ = layer.init(jax.random.PRNGKey(0))
    params["b"] = jnp.linspace(-0.1, 0.1, 5, dtype=jnp.float32)
    conv = TC.Conv(3, 5, 3, 1, padding, act=torch.nn.functional.elu)
    conv.load_state_dict(params_from_jax(params, {}))
    x = _imgs(1, 2, 7, 9, 3)
    y_j, _ = layer(params, {}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(conv(_nchw(x))), np.asarray(y_j), **TOL)


def test_conv_init_is_glorot_uniform_zero_bias():
    conv = TC.Conv(16, 32, 3)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    limit = np.sqrt(6.0 / (9 * 16 + 9 * 32))
    assert float(conv.weight.detach().abs().max()) <= limit
    assert float(conv.weight.detach().abs().max()) > 0.9 * limit
    assert float(conv.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_output_and_new_stats(train):
    layer = JC.BatchNorm(4)
    rng = np.random.default_rng(2)
    params = {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32), "bias": rng.normal(size=4).astype(np.float32)}
    stats = {"mean": rng.normal(size=4).astype(np.float32), "var": rng.uniform(0.5, 2, 4).astype(np.float32)}
    bn = TC.BatchNorm(4)
    bn.load_state_dict(params_from_jax(params, stats))
    bn.train(train)
    x = _imgs(3, 3, 5, 6, 4) * 3.0
    y_j, s_j = layer(params, stats, jnp.asarray(x), train=train)
    np.testing.assert_allclose(_nhwc(bn(_nchw(x))), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s_j["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s_j["var"]), **TOL)


def test_ssim_and_photometric_loss_with_grads():
    x, y = _imgs(4, 2, 8, 12, 3), _imgs(5, 2, 8, 12, 3)
    np.testing.assert_allclose(
        t_ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(j_ssim(jnp.asarray(x), jnp.asarray(y))),
        **TOL,
    )
    g_j = jax.grad(lambda a: jnp.sum(JL.photometric_loss(a, jnp.asarray(y)) ** 2))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    loss = TL.photometric_loss(xt, torch.from_numpy(y))
    np.testing.assert_allclose(
        loss.detach().numpy(), np.asarray(JL.photometric_loss(jnp.asarray(x), jnp.asarray(y))), **TOL
    )
    torch.sum(loss**2).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-6)


def test_prediction_automasking_apply_automask():
    frames = _imgs(6, 2, 3, 8, 12, 1)
    target = frames[:, 1]
    preds = [_imgs(7, 2, 8, 12, 1), _imgs(8, 2, 8, 12, 1)]
    pred_j = JL.prediction_loss([jnp.asarray(p) for p in preds], jnp.asarray(target))
    pred_t = TL.prediction_loss([torch.from_numpy(p) for p in preds], torch.from_numpy(target))
    np.testing.assert_allclose(pred_t.numpy(), np.asarray(pred_j), **TOL)
    auto_j = JL.automasking_loss(jnp.asarray(frames), jnp.asarray(target), (0, 2))
    auto_t = TL.automasking_loss(torch.from_numpy(frames), torch.from_numpy(target), (0, 2))
    np.testing.assert_allclose(auto_t.numpy(), np.asarray(auto_j), **TOL)
    np.testing.assert_allclose(
        TL.apply_automask(auto_t, pred_t).numpy(), np.asarray(JL.apply_automask(auto_j, pred_j)), **TOL
    )


def test_smooth_loss():
    disp, img = _imgs(9, 2, 8, 12), _imgs(10, 2, 8, 12, 3)
    np.testing.assert_allclose(
        float(TL.smooth_loss(torch.from_numpy(disp), torch.from_numpy(img))),
        float(JL.smooth_loss(jnp.asarray(disp), jnp.asarray(img))),
        rtol=1e-5,
    )


def test_warp_images_with_pose_grads():
    n, h, w = 2, 8, 12
    rng = np.random.default_rng(11)
    disp = rng.uniform(0.2, 0.8, size=(n, h, w, 1)).astype(np.float32)
    frames = _imgs(12, n, 3, h, w, 1)
    rvecs = rng.uniform(-0.02, 0.02, size=(2, n, 3)).astype(np.float32)
    tvecs = rng.uniform(-0.05, 0.05, size=(2, n, 3, 1)).astype(np.float32)
    K = np.asarray([[10.0, 0, w / 2], [0, 10.0, h / 2], [0, 0, 1.0]], np.float32)
    invK = np.linalg.inv(K.astype(np.float64)).astype(np.float32)

    def jax_loss(d, r, t):
        poses = [j_compose(r[i], t[i], invert=(i == 0)) for i in range(2)]
        warped = JL.warp_images(
            d, jnp.asarray(frames), poses, jnp.asarray(K), jnp.asarray(invK),
            j_grid(w, h, jnp.float32), (0, 2), 0.1, 100.0, method="gather",
        )
        return jnp.sum(JL.prediction_loss(warped, jnp.asarray(frames[:, 1]))), warped

    (l_j, warped_j), grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(disp), jnp.asarray(rvecs), jnp.asarray(tvecs)
    )
    d_t, r_t, t_t = (torch.tensor(a, requires_grad=True) for a in (disp, rvecs, tvecs))
    poses = [t_compose(r_t[i], t_t[i], invert=(i == 0)) for i in range(2)]
    warped_t = TL.warp_images(
        d_t, torch.from_numpy(frames), poses, torch.from_numpy(K), torch.from_numpy(invK),
        t_grid(w, h), (0, 2), 0.1, 100.0,
    )
    l_t = torch.sum(TL.prediction_loss(warped_t, torch.from_numpy(frames[:, 1])))
    l_t.backward()
    for a, b in zip(warped_t, warped_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-5)
    # gradients: relative to the largest entry (interior samples only here,
    # where the gather and Pallas rules agree)
    for got, ref in zip((d_t.grad, r_t.grad, t_t.grad), grads_j):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())
