"""ResNet-18/34/50 encoder with multi-scale stage outputs, port of
monodepth2_tpu/models/resnet.py. Runs NCHW; submodule names follow the JAX
params tree (stem_conv, stem_bn, layer{s}_{b}.conv1, ...) so that bridge.py
maps one onto the other by name."""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import Tensor, nn

from ..nn.core import BatchNorm, Conv, max_pool

STAGE_CHANNELS = {
    18: (64, 64, 128, 256, 512),
    34: (64, 64, 128, 256, 512),
    50: (64, 256, 512, 1024, 2048),
}
STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
}


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU → conv3x3-BN, residual add, ReLU (resnet.py:39-85)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3, stride, 1, use_bias=False)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, 1, use_bias=False)
        self.bn2 = BatchNorm(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.proj = Conv(in_ch, out_ch, 1, stride, 0, use_bias=False)
            self.proj_bn = BatchNorm(out_ch)
        else:
            self.proj = None

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        sc = self.proj_bn(self.proj(x)) if self.proj is not None else x
        return F.relu(y + sc)


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (strided) → 1×1 expand ×4, residual add, ReLU
    (resnet.py:88-142)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        mid = out_ch // 4
        self.conv1 = Conv(in_ch, mid, 1, 1, 0, use_bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv(mid, mid, 3, stride, 1, use_bias=False)
        self.bn2 = BatchNorm(mid)
        self.conv3 = Conv(mid, out_ch, 1, 1, 0, use_bias=False)
        self.bn3 = BatchNorm(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.proj = Conv(in_ch, out_ch, 1, stride, 0, use_bias=False)
            self.proj_bn = BatchNorm(out_ch)
        else:
            self.proj = None

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = self.proj_bn(self.proj(x)) if self.proj is not None else x
        return F.relu(y + sc)


class ResNetEncoder(nn.Module):
    """ResNet backbone; forward returns the 5 stage outputs at strides
    2, 4, 8, 16, 32 (resnet.py:145-207). x (N,C,H,W)."""

    def __init__(self, depth: int = 18, in_channels: int = 1):
        super().__init__()
        self.depth = depth
        self.stages: Tuple[int, ...] = STAGE_CHANNELS[depth]
        self.stem_conv = Conv(in_channels, 64, 7, 2, 3, use_bias=False)
        self.stem_bn = BatchNorm(64)
        block_cls = Bottleneck if depth >= 50 else BasicBlock
        in_ch = self.stages[0]
        self.block_names = []
        for si, (out_ch, n) in enumerate(zip(self.stages[1:], STAGE_BLOCKS[depth])):
            names = []
            for b in range(n):
                stride = 2 if si > 0 and b == 0 else 1
                name = f"layer{si + 1}_{b}"
                self.add_module(name, block_cls(in_ch, out_ch, stride))
                names.append(name)
                in_ch = out_ch
            self.block_names.append(names)

    def forward(self, x: Tensor):
        y = F.relu(self.stem_bn(self.stem_conv(x)))
        features = [y]
        y = max_pool(y, window=3, stride=2, padding=1)
        for names in self.block_names:
            for name in names:
                y = getattr(self, name)(y)
            features.append(y)
        return tuple(features)
