"""Axis-angle pose decoder, port of monodepth2_tpu/models/pose_decoder.py
(reference src/pose_decoder.jl): 1×1 squeeze → 256 per input map, concat,
two 3×3 conv-ReLU 256 stages, 1×1 conv → 6, spatial mean ×1e-2."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.core import Conv


class PoseDecoder(nn.Module):
    """tz_init sets the head's z-translation bias so the predicted
    (earlier → later) transform starts at tz = tz_init (pose_decoder.py:43-53);
    the bias is tz_init / 1e-2 to undo the output scaling."""

    def __init__(self, in_channels: int = 512, n_input_features: int = 2, tz_init: float = 0.0):
        super().__init__()
        self.tz_init = tz_init
        self.squeeze = Conv(in_channels, 256, 1, 1, 0, act=F.relu)
        self.p1 = Conv(n_input_features * 256, 256, 3, 1, 1, act=F.relu)
        self.p2 = Conv(256, 256, 3, 1, 1, act=F.relu)
        self.p3 = Conv(256, 6, 1, 1, 0)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The tz_init bias; nn.core.reset_parameters calls this after p3's
        own init."""
        if self.tz_init:
            self.p3.bias[5] = self.tz_init / 1e-2

    def forward(self, features: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
        """features: 2 maps (N,C,h,w) ordered (earlier frame, later frame).
        Returns rvec (N,3), tvec (N,3,1)."""
        squeezed = torch.cat([self.squeeze(f) for f in features], dim=1)
        y = self.p3(self.p2(self.p1(squeezed)))
        pose = torch.mean(y, dim=(2, 3)) * 1e-2  # (N,6)
        return pose[:, :3], pose[:, 3:, None]
