"""Core layers, port of monodepth2_tpu/nn/core.py.

The JAX package keeps NHWC tensors, HWIO weights and params/stats pytrees;
here the layers are nn.Modules that run NCHW with OIHW weights, and
BatchNorm's running statistics are module buffers updated in place by a
training-mode forward. `bridge.py` converts between the two.

Free functions that the losses call on images (`reflect_pad`, `mean_pool`,
`upsample_bilinear`, `max_pool`) take NCHW tensors like the layers.
"""

from __future__ import annotations

import contextlib
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


def _bf16(v: float) -> float:
    """v rounded to bfloat16, as a Python float."""
    return torch.tensor(v, dtype=torch.bfloat16).item()


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, global_sum: Callable[[Tensor], Tensor]):
    """Inside, every training-mode forward of a BatchNorm in `model`
    normalizes by the moments of the global batch and updates its running
    statistics from them: `global_sum(t)` sums t over the ranks,
    differentiably, so that the backward couples the ranks as the
    single-device step on the global batch does. Data-parallel steps
    (parallel/dp.py, GSPMD semantics) hold it across the forward and the
    backward, whose rematerialized forward (TrainConfig.remat) takes the
    same moments."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in layers:
        m.global_sum = global_sum
    try:
        yield
    finally:
        for m in layers:
            m.global_sum = None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over N,H,W (core.py:114-158): eps 1e-5, momentum 0.1; the
    running variance takes the unbiased batch variance, normalization the
    biased one — torch's own rule. The running stats are fp32 buffers that a
    training-mode forward updates in place.

    A bf16 input (the network under autocast, compute_dtype "bfloat16")
    updates them as the JAX package's jitted step does. There the stats are
    cast to bf16 before the model (training/loss.py:77), so in
    `(1 - m) * stats + m * moment` (core.py:146-147) the carried stat is
    rounded to bf16 and scaled by 1 − m rounded to bf16 (0.8984375), the
    batch moments come out of the bf16 mean and variance rounded to bf16
    (the variance times n/(n−1) rounded to bf16), and XLA takes the products
    and the sum in fp32 (a product of two bf16 values is exact in fp32).
    Other inputs keep torch's fp32 update.

    `frozen_stats` set: a training-mode forward normalizes as above and
    leaves the running stats and the batch count as they are. The recompute
    of a rematerialized forward (TrainConfig.remat) runs so, or it would
    update them a second time in the step.

    `global_sum` set (`global_batch_stats`, a data-parallel step): a
    training-mode forward takes the moments of the global batch instead
    (`_global_forward`); unset, nothing changes."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(ch, eps=eps, momentum=momentum)
        self.frozen_stats = False
        self.global_sum: Optional[Callable[[Tensor], Tensor]] = None

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()

    def forward(self, x: Tensor) -> Tensor:
        if self.training and self.global_sum is not None:
            return self._global_forward(x, self.global_sum)
        if not (self.training and x.dtype == torch.bfloat16 and self.running_mean.dtype == torch.float32):
            if self.training and self.frozen_stats:
                # the same call on copies of the stats: the same kernels, so
                # the recompute gives the first pass's values
                return F.batch_norm(
                    x, self.running_mean.clone(), self.running_var.clone(), self.weight, self.bias,
                    True, self.momentum, self.eps,
                )
            return super().forward(x)
        # normalize by the batch moments; the running update follows
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if not self.frozen_stats:
            self._bf16_running_update(x.detach())
        return y

    def _global_forward(self, x: Tensor, global_sum: Callable[[Tensor], Tensor]) -> Tensor:
        """Normalize by the global batch's moments: per channel the count and
        the sum summed over the ranks give the mean, then the sum of squared
        deviations from it gives the biased variance (two passes, as
        jnp.var, stable in fp32). A bf16 input is summed and normalized in
        fp32, as F.batch_norm does, and the output cast back. The running
        statistics take the global moments and the global count's n/(n-1):
        a bf16 input's rounded as `_bf16_running_update` rounds the local
        ones, others in the input's precision (core.py:139-147)."""
        c = x.shape[1]
        acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
        shape = (1, c, 1, 1)
        with torch.autocast(device_type=x.device.type, enabled=False):
            xa = x.to(acc)
            totals = global_sum(torch.cat([xa.sum(dim=(0, 2, 3)), xa.new_full((1,), xa.numel() // c)]))
            n = totals[c]
            mean = totals[:c] / n
            d = xa - mean.view(shape)
            var = global_sum((d * d).sum(dim=(0, 2, 3))) / n
            y = d * torch.rsqrt(var + self.eps).view(shape) * self.weight.view(shape) + self.bias.view(shape)
        if not self.frozen_stats:
            self._global_running_update(mean.detach(), var.detach(), n.detach(), x.dtype == torch.bfloat16)
        return y.to(x.dtype)

    @torch.no_grad()
    def _global_running_update(self, mean: Tensor, var: Tensor, n: Tensor, bf16: bool) -> None:
        m = self.momentum
        unbias = n / torch.clamp(n - 1, min=1)
        stats = torch.stack((self.running_mean, self.running_var))
        if bf16 and self.running_mean.dtype == torch.float32:
            # the rounding of _bf16_running_update, on the global moments
            moments = torch.stack((mean, var)).to(torch.bfloat16).float()
            moments[1].mul_(unbias.to(torch.bfloat16).float())
            stats = stats.to(torch.bfloat16).float().mul_(_bf16(1 - m)).add_(moments, alpha=m)
        else:
            moments = torch.stack((mean, var * unbias)).to(stats.dtype)
            stats = (1 - m) * stats + m * moments
        torch._foreach_copy_([self.running_mean, self.running_var], [stats[0], stats[1]])
        self.num_batches_tracked.add_(1)

    @torch.no_grad()
    def _bf16_running_update(self, x: Tensor) -> None:
        # both stats in one (2, C) tensor: a handful of kernels a layer, not
        # twice as many (an eager step is bound by its launches)
        m = self.momentum
        n = x.numel() // x.shape[1]
        with torch.autocast(device_type=x.device.type, enabled=False):
            # fp32 sums of the bf16 input, each moment rounded to bf16 once
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        moments = torch.stack((mean, var)).to(torch.bfloat16)
        unbias = _bf16(n / max(n - 1, 1))
        if unbias != 1.0:  # n < 256: the factor is not 1 in bf16
            moments = moments.float()
            moments[1].mul_(unbias)
        stats = torch.stack((self.running_mean, self.running_var))
        stats = stats.to(torch.bfloat16).float().mul_(_bf16(1 - m)).add_(moments, alpha=m)
        torch._foreach_copy_([self.running_mean, self.running_var], [stats[0], stats[1]])
        self.num_batches_tracked.add_(1)


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
