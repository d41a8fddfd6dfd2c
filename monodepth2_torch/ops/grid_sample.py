"""Bilinear grid sampling with border padding.

Port of monodepth2_tpu/ops/grid_sample.py and of the Pallas kernel module
monodepth2_tpu/ops/pallas/grid_sample_kernel.py. Same API: NHWC image,
uv (N,P,2) in (-1,1) with align-corners normalization, out (N,P,C);
out-of-range samples clamp to the border.

Three hand-written CUDA kernels (ops/cuda/grid_sample.cu) carry the op on
the card, each behind a wrapper that counts its launches, with its plain
PyTorch version beside it:

  grid_sample_fwd      K1: replaces _fwd_kernel / _fwd_kernel_colband
  grid_sample_bwd_uv   K2: replaces _bwd_duv_kernel / _bwd_duv_kernel_colband
  grid_sample_bwd_img  K3: replaces _bwd_dimg_kernel / _bwd_dimg_kernel_colband

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back. The backward launches
K3 only when the image requires grad: source frames are data in training, so
a training step launches K1 and K2 only.

The coordinate gradient follows the Pallas border rule, which training on the
TPU used: a sample exactly on the border counts as inside (`inside_u`,
grid_sample_kernel.py:70-71, 149-151), so at u = -1 d_u gets the full
one-sided slope (the JAX gather path's clip tie gives half of it, and
torch.nn.functional.grid_sample gives 0).

`_GridSample` is the port of the Pallas glue (`_prep`, the `_sample`
custom_vjp and `grid_sample_pallas`, :456-604). The rest of that glue is
TPU-only and has nothing to port: the column-major point reorder, the padding
to Q-point chunks, the window geometry (`_padded_width`, `_make_windows`,
`_window_info`, :259-293), the `lax.cond` fallback to unbanded kernels and
the bf16 `precise=False` mode. The kernels here are exact in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

# ---------------------------------------------------------------- plain versions


def _coords(h: int, w: int, uv: Tensor):
    """Normalized uv (N,P,2) -> clamped tap indices (N,P), weights (N,P,1)
    and inside masks (N,P), as `_coords` (grid_sample_kernel.py:65-80)."""
    u = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    v = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    inside_u = (u >= 0.0) & (u <= w - 1)
    inside_v = (v >= 0.0) & (v <= h - 1)
    u = u.clamp(0.0, w - 1)
    v = v.clamp(0.0, h - 1)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    wx = (u - x0)[..., None]
    wy = (v - y0)[..., None]
    x0i = x0.long().clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    return x0i, x1i, y0i, y1i, wx, wy, inside_u, inside_v


def _tap_index(w: int, c: int, yi: Tensor, xi: Tensor) -> Tensor:
    return (yi * w + xi)[..., None].expand(-1, -1, c)


def _taps(image: Tensor, x0i, x1i, y0i, y1i):
    n, h, w, c = image.shape
    flat = image.reshape(n, h * w, c)
    return tuple(
        torch.gather(flat, 1, _tap_index(w, c, yi, xi))
        for yi, xi in ((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i))
    )


def grid_sample_fwd_plain(image: Tensor, uv: Tensor) -> Tensor:
    """Plain version of K1: the 4-tap gather of `_grid_sample_gather`
    (monodepth2_tpu/ops/grid_sample.py:62-80). (N,H,W,C), (N,P,2) -> (N,P,C)."""
    _, h, w, _ = image.shape
    x0i, x1i, y0i, y1i, wx, wy, _, _ = _coords(h, w, uv)
    p00, p01, p10, p11 = _taps(image, x0i, x1i, y0i, y1i)
    top = p00 * (1.0 - wx) + p01 * wx
    bot = p10 * (1.0 - wx) + p11 * wx
    return top * (1.0 - wy) + bot * wy


def grid_sample_bwd_uv_plain(image: Tensor, uv: Tensor, g: Tensor) -> Tensor:
    """Plain version of K2: the coordinate VJP with the Pallas border rule.
    g (N,P,C) -> duv (N,P,2)."""
    _, h, w, _ = image.shape
    x0i, x1i, y0i, y1i, wx, wy, inside_u, inside_v = _coords(h, w, uv)
    p00, p01, p10, p11 = _taps(image, x0i, x1i, y0i, y1i)
    top = p00 * (1.0 - wx) + p01 * wx
    bot = p10 * (1.0 - wx) + p11 * wx
    du = torch.sum(g * ((p01 - p00) * (1.0 - wy) + (p11 - p10) * wy), dim=-1)
    dv = torch.sum(g * (bot - top), dim=-1)
    du = torch.where(inside_u, du, 0.0) * ((w - 1) * 0.5)
    dv = torch.where(inside_v, dv, 0.0) * ((h - 1) * 0.5)
    return torch.stack([du, dv], dim=-1)


def grid_sample_bwd_img_plain(image: Tensor, uv: Tensor, g: Tensor) -> Tensor:
    """Plain version of K3, the image VJP: scatter-add of the 4 weighted taps.
    g (N,P,C) -> d_image (N,H,W,C)."""
    n, h, w, c = image.shape
    x0i, x1i, y0i, y1i, wx, wy, _, _ = _coords(h, w, uv)
    flat = torch.zeros((n, h * w, c), dtype=g.dtype, device=g.device)
    for yi, xi, weight in (
        (y0i, x0i, (1.0 - wx) * (1.0 - wy)),
        (y0i, x1i, wx * (1.0 - wy)),
        (y1i, x0i, (1.0 - wx) * wy),
        (y1i, x1i, wx * wy),
    ):
        flat.scatter_add_(1, _tap_index(w, c, yi, xi), g * weight)
    return flat.reshape(n, h, w, c)


# ---------------------------------------------------------------- kernel wrappers


def _check_cuda(name: str, image: Tensor, *others: Tensor) -> None:
    for t in (image, *others):
        if t.device != image.device:
            raise ValueError(f"{name}: all tensors must be on {image.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    if image.dim() != 4:
        raise ValueError(f"{name}: image must be (N,H,W,C), got {tuple(image.shape)}")
    n, h, w, c = image.shape
    uv = others[0]
    if uv.dim() != 3 or uv.shape[0] != n or uv.shape[2] != 2:
        raise ValueError(f"{name}: uv must be ({n},P,2), got {tuple(uv.shape)}")
    if max(n * h * w * c, n * uv.shape[1] * max(c, 2)) >= 2**31:
        raise ValueError(f"{name}: sizes exceed the kernel's int32 arguments")


class _Kernel:
    """A kernel's wrapper: `launches` counts the kernel launches it made."""

    name = ""

    def __init__(self):
        self.launches = 0

    def _launch(self, fn, *args) -> None:
        from .cuda import _lib

        lib = _lib.load()
        device = args[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            ptrs = [t.data_ptr() for t in args if isinstance(t, Tensor)]
            sizes = [a for a in args if not isinstance(a, Tensor)]
            code = getattr(lib, fn)(*ptrs, *sizes, stream)
        _lib.check(lib, code, fn)
        self.launches += 1


class GridSampleFwd(_Kernel):
    """K1 wrapper: (N,H,W,C) image, (N,P,2) uv -> (N,P,C)."""

    name = "grid_sample_fwd"

    def __call__(self, image: Tensor, uv: Tensor) -> Tensor:
        if not image.is_cuda:
            return grid_sample_fwd_plain(image, uv)
        _check_cuda(self.name, image, uv)
        n, h, w, c = image.shape
        p = uv.shape[1]
        out = torch.empty((n, p, c), dtype=torch.float32, device=image.device)
        if out.numel():
            self._launch(self.name, image, uv, out, n, h, w, c, p)
        return out


class GridSampleBwdUV(_Kernel):
    """K2 wrapper: image, uv and the output cotangent g (N,P,C) -> duv (N,P,2)."""

    name = "grid_sample_bwd_uv"

    def __call__(self, image: Tensor, uv: Tensor, g: Tensor) -> Tensor:
        if not image.is_cuda:
            return grid_sample_bwd_uv_plain(image, uv, g)
        _check_cuda(self.name, image, uv, g)
        n, h, w, c = image.shape
        p = uv.shape[1]
        if g.shape != (n, p, c):
            raise ValueError(f"{self.name}: g must be {(n, p, c)}, got {tuple(g.shape)}")
        duv = torch.empty((n, p, 2), dtype=torch.float32, device=image.device)
        if duv.numel():
            self._launch(self.name, image, uv, g, duv, n, h, w, c, p)
        return duv


class GridSampleBwdImg(_Kernel):
    """K3 wrapper: image (read for its shape only), uv and g (N,P,C) ->
    d_image (N,H,W,C). Zeroes the fp32 output on the launch's stream; the
    kernel adds into it with atomics, so the sum's last bits vary between
    runs."""

    name = "grid_sample_bwd_img"

    def __call__(self, image: Tensor, uv: Tensor, g: Tensor) -> Tensor:
        if not image.is_cuda:
            return grid_sample_bwd_img_plain(image, uv, g)
        _check_cuda(self.name, image, uv, g)
        n, h, w, c = image.shape
        p = uv.shape[1]
        if g.shape != (n, p, c):
            raise ValueError(f"{self.name}: g must be {(n, p, c)}, got {tuple(g.shape)}")
        # the fill runs on the current stream of image.device, where _launch
        # enqueues the kernel after it
        dimg = torch.zeros((n, h, w, c), dtype=torch.float32, device=image.device)
        if n * p * c:
            self._launch(self.name, uv, g, dimg, n, h, w, c, p)
        return dimg


grid_sample_fwd = GridSampleFwd()
grid_sample_bwd_uv = GridSampleBwdUV()
grid_sample_bwd_img = GridSampleBwdImg()
KERNELS = (grid_sample_fwd, grid_sample_bwd_uv, grid_sample_bwd_img)

# ---------------------------------------------------------------- the op


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, uv, plain: bool):
        image = image.contiguous()
        uv = uv.contiguous()
        ctx.save_for_backward(image, uv)
        ctx.plain = plain
        return grid_sample_fwd_plain(image, uv) if plain else grid_sample_fwd(image, uv)

    @staticmethod
    def backward(ctx, g):
        image, uv = ctx.saved_tensors
        g = g.contiguous()
        d_image = d_uv = None
        if ctx.needs_input_grad[0]:
            bwd = grid_sample_bwd_img_plain if ctx.plain else grid_sample_bwd_img
            d_image = bwd(image, uv, g)
        if ctx.needs_input_grad[1]:
            bwd = grid_sample_bwd_uv_plain if ctx.plain else grid_sample_bwd_uv
            d_uv = bwd(image, uv, g)
        return d_image, d_uv, None


def grid_sample(image: Tensor, uv: Tensor, method: Optional[str] = None) -> Tensor:
    """Sample NHWC `image` at normalized coords `uv` (N,P,2) in (-1,1).

    Returns (N,P,C); uv[..., 0] is x (width axis), uv[..., 1] is y.
    method: None or "pallas" — the hand-written kernels on a CUDA tensor, their
    plain versions on a CPU tensor ("pallas" is the name JAX configs give the
    hand-written kernel); "gather" — the plain version on any device.
    """
    if method not in (None, "pallas", "gather"):
        raise ValueError(
            f"unknown grid_sample method {method!r} (the one-hot formulation is TPU-only)"
        )
    return _GridSample.apply(image, uv, method == "gather")
