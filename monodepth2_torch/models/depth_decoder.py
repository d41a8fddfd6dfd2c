"""U-Net depth decoder with per-scale sigmoid disparity heads, port of
monodepth2_tpu/models/depth_decoder.py (reference src/depth_decoder.jl).
Runs NCHW; returns one disparity (N,1,h,w) per scale level, coarse → fine."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.core import Conv, upsample_bilinear

DECODER_CHANNELS = (256, 128, 64, 32, 16)


class BranchBlock(nn.Module):
    """conv-ELU → 2× bilinear up → concat skip → conv-ELU
    (depth_decoder.py:28-53)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.c1 = Conv(in_ch, out_ch, 3, 1, "reflect", act=F.elu)
        self.c2 = Conv(out_ch + skip_ch, out_ch, 3, 1, "reflect", act=F.elu)

    def forward(self, x: Tensor, skip: Optional[Tensor] = None) -> Tensor:
        y = upsample_bilinear(self.c1(x), scale=2)
        if skip is not None:
            y = torch.cat([y, skip], dim=1)
        return self.c2(y)


class DepthDecoder(nn.Module):
    """encoder_channels: per-stage channels fine → coarse; scale_levels ⊆ 1..5
    pick which up-stages emit a disparity head (depth_decoder.py:56-113)."""

    def __init__(
        self,
        encoder_channels: Tuple[int, ...] = (64, 64, 128, 256, 512),
        scale_levels: Sequence[int] = (2, 3, 4, 5),
    ):
        super().__init__()
        sl = tuple(scale_levels)
        if len(sl) > 5 or min(sl) < 1 or max(sl) > 5:
            raise ValueError("scale_levels must have ≤5 entries with values in [1, 5]")
        if tuple(sorted(sl)) != sl:
            raise ValueError("scale_levels must be sorted ascending")
        self.scale_levels = sl
        enc = tuple(reversed(encoder_channels))  # coarse → fine
        in_channels = (enc[0],) + DECODER_CHANNELS[:-1]
        skip_channels = enc[1:] + (0,)
        for i in range(max(sl)):
            self.add_module(
                f"block{i + 1}",
                BranchBlock(in_channels[i], skip_channels[i], DECODER_CHANNELS[i]),
            )
        for level in sl:
            self.add_module(
                f"head{level}",
                Conv(DECODER_CHANNELS[level - 1], 1, 3, 1, "reflect", act=torch.sigmoid),
            )

    def forward(self, features: Sequence[Tensor]) -> list:
        """features: 5 encoder stages fine → coarse (N,C,h,w)."""
        x = features[-1]
        skips = list(features[:-1])[::-1]
        disparities = []
        for i in range(max(self.scale_levels)):
            skip = skips[i] if i < len(skips) else None
            x = getattr(self, f"block{i + 1}")(x, skip)
            if i + 1 in self.scale_levels:
                disparities.append(getattr(self, f"head{i + 1}")(x))
        return disparities
