"""Core layers, port of monodepth2_tpu/nn/core.py.

The JAX package keeps NHWC tensors, HWIO weights and params/stats pytrees;
here the layers are nn.Modules that run NCHW with OIHW weights, and
BatchNorm's running statistics are module buffers updated in place by a
training-mode forward. `bridge.py` converts between the two.

Free functions that the losses call on images (`reflect_pad`, `mean_pool`,
`upsample_bilinear`, `max_pool`) take NCHW tensors like the layers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _reflect_index(n: int, pad: int, device) -> Tensor:
    """numpy's "reflect" indices for padding a length-n axis by `pad`: period
    2(n-1), and the one element repeated when n == 1."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = torch.remainder(i, 2 * (n - 1))
    return torch.where(i < n, i, 2 * (n - 1) - i)


def reflect_pad(x: Tensor, pad: int) -> Tensor:
    """Reflect-pad H and W of an NCHW tensor (core.py:35-40), as jnp.pad's
    "reflect" does — also where a map is no larger than the pad, which
    F.pad refuses (a 1-pixel-high bottleneck at 64×32 input)."""
    if pad == 0:
        return x
    h, w = x.shape[-2:]
    if pad < h and pad < w:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    x = x.index_select(-2, _reflect_index(h, pad, x.device))
    return x.index_select(-1, _reflect_index(w, pad, x.device))


class Conv(nn.Module):
    """2-D convolution (core.py:54-110).

    padding: int p -> zero pad p on each side; "reflect" -> reflect-pad
    (kernel-1)//2 then a VALID conv. Weights are Glorot-uniform and the bias
    zero (Flux's default, core.py:73-85), drawn from `generator`.
    """

    def __init__(
        self,
        in_ch: int,
        out_ch: int,
        kernel: Union[int, Tuple[int, int]] = 3,
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, str] = 0,
        use_bias: bool = True,
        act: Optional[Callable[[Tensor], Tensor]] = None,
    ):
        super().__init__()
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = padding
        self.act = act
        kh, kw = self.kernel
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_ch, in_ch, kh, kw = self.weight.shape
        limit = math.sqrt(6.0 / (kh * kw * in_ch + kh * kw * out_ch))
        w = torch.rand(self.weight.shape, generator=generator) * (2 * limit) - limit
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        if self.padding == "reflect":
            x = reflect_pad(x, (self.kernel[0] - 1) // 2)
            padding = 0
        else:
            padding = _pair(self.padding)
        y = F.conv2d(x, self.weight, self.bias, self.stride, padding)
        return self.act(y) if self.act is not None else y


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over N,H,W (core.py:114-158): eps 1e-5, momentum 0.1; the
    running variance takes the unbiased batch variance, normalization the
    biased one — torch's own rule. The running stats are buffers that a
    training-mode forward updates in place."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(ch, eps=eps, momentum=momentum)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()


def max_pool(x: Tensor, window: int = 2, stride: int = 2, padding: int = 0) -> Tensor:
    """Max pool over H,W of NCHW; padding counts as −inf (core.py:184-195)."""
    return F.max_pool2d(x, window, stride, padding)


def mean_pool(x: Tensor, window: int = 3, stride: int = 1) -> Tensor:
    """VALID mean pool over H,W of NCHW (core.py:198-212)."""
    return F.avg_pool2d(x, window, stride)


def upsample_bilinear(
    x: Tensor, scale: Optional[int] = None, size: Optional[Tuple[int, int]] = None
) -> Tensor:
    """Bilinear upsample of NCHW with align_corners=True (core.py:215-247)."""
    h, w = x.shape[-2:]
    if size is None:
        size = (h * scale, w * scale)
    if tuple(size) == (h, w):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialize the submodules of `module` from `generator`: each one
    whose class defines `reset_parameters(generator)`, children before their
    parents, so a parent's own rule (PoseDecoder's tz_init bias) lands last."""
    for m in reversed(list(module.modules())[1:]):
        if "reset_parameters" in type(m).__dict__:
            m.reset_parameters(generator)
