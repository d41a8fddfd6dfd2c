"""Plain float32 reference of the network: ResNet-18 encoder, U-Net depth
decoder with sigmoid disparity heads, axis-angle pose decoder.

Written from the Monodepth2 architecture (Godard et al., arXiv:1806.01260,
§3 and the supplement's table) as the program under test implements it:
NCHW, a 7×7 stride-2 stem with BatchNorm and ReLU, a 3×3 stride-2 max pool,
four stages of two basic blocks (64, 64, 128, 256, 512 channels at strides
2-32); the decoder's five stages of conv-ELU, 2× bilinear upsampling
(align_corners), concatenation with the skip, conv-ELU, with reflect-padded
3×3 convolutions and a sigmoid 3×3 head at each scale level; the pose
decoder squeezes the last feature map of each frame of a pair to 256
channels (1×1, ReLU), concatenates, runs two 3×3 ReLU convolutions and a
1×1 to 6 channels, averages over space and scales by 1e-2 into (rvec, tvec).

Parameter and buffer names are those of the program's state dict, so one
set of weights, made by the benchmark, loads into both. Nothing here
imports the program. Every convolution can compute in float8, the control
of the comparison (`set_fp8`): its input, weight and (activated) output
rounded through e4m3 with one scale a tensor, and the gradients flowing
back through them through e5m2, accumulating in float32, as a bf16 network
keeps its activations and their gradients in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: Tensor, dtype: torch.dtype, top: float) -> Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Round through float8 with one scale a tensor (its largest magnitude
    maps to the format's largest): e4m3 forward, e5m2 for the gradient, as
    float8 training keeps them."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fake_fp8(x: Tensor) -> Tensor:
    return _Fp8.apply(x)


class Conv(nn.Module):
    """A 2-D convolution, zero- or reflect-padded, with an optional
    activation."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad=0, bias: bool = True, act=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.pad, self.act = stride, pad, act
        self.fp8 = False

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        if self.pad == "reflect":
            p = (self.weight.shape[-1] - 1) // 2
            x = F.pad(x, (p, p, p, p), mode="reflect")
            padding = 0
        else:
            padding = self.pad
        y = F.conv2d(x, w, self.bias, self.stride, padding)
        y = self.act(y) if self.act is not None else y
        return fake_fp8(y) if self.fp8 else y


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)
        self.conv2 = Conv(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)
        self.proj = None
        if stride != 1 or cin != cout:
            self.proj = Conv(cin, cout, 1, stride, 0, bias=False)
            self.proj_bn = nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x: Tensor) -> Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        skip = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + skip)


STAGES = (64, 64, 128, 256, 512)


class Encoder(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.stem_conv = Conv(in_channels, 64, 7, 2, 3, bias=False)
        self.stem_bn = nn.BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.names = []
        cin = 64
        for s, cout in enumerate(STAGES[1:]):
            for b in range(2):
                name = f"layer{s + 1}_{b}"
                self.add_module(name, BasicBlock(cin, cout, 2 if s > 0 and b == 0 else 1))
                self.names.append(name)
                cin = cout

    def forward(self, x: Tensor):
        y = F.relu(self.stem_bn(self.stem_conv(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i, name in enumerate(self.names):
            y = getattr(self, name)(y)
            if i % 2 == 1:
                feats.append(y)
        return feats


DECODER = (256, 128, 64, 32, 16)


def up2(x: Tensor) -> Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class Branch(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.c1 = Conv(cin, cout, 3, 1, "reflect", act=F.elu)
        self.c2 = Conv(cout + cskip, cout, 3, 1, "reflect", act=F.elu)

    def forward(self, x: Tensor, skip) -> Tensor:
        y = up2(self.c1(x))
        if skip is not None:
            y = torch.cat([y, skip], dim=1)
        return self.c2(y)


class DepthDecoder(nn.Module):
    def __init__(self, scale_levels=(2, 3, 4, 5)):
        super().__init__()
        self.levels = tuple(scale_levels)
        enc = STAGES[::-1]
        cins = (enc[0],) + DECODER[:-1]
        skips = enc[1:] + (0,)
        for i in range(max(self.levels)):
            self.add_module(f"block{i + 1}", Branch(cins[i], skips[i], DECODER[i]))
        for level in self.levels:
            self.add_module(f"head{level}", Conv(DECODER[level - 1], 1, 3, 1, "reflect", act=torch.sigmoid))

    def forward(self, feats):
        x = feats[-1]
        skips = feats[:-1][::-1]
        out = []
        for i in range(max(self.levels)):
            x = getattr(self, f"block{i + 1}")(x, skips[i] if i < len(skips) else None)
            if i + 1 in self.levels:
                out.append(getattr(self, f"head{i + 1}")(x))
        return out


class PoseDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.squeeze = Conv(512, 256, 1, act=F.relu)
        self.p1 = Conv(512, 256, 3, 1, 1, act=F.relu)
        self.p2 = Conv(256, 256, 3, 1, 1, act=F.relu)
        self.p3 = Conv(256, 6, 1)

    def forward(self, earlier: Tensor, later: Tensor):
        y = torch.cat([self.squeeze(earlier), self.squeeze(later)], dim=1)
        pose = self.p3(self.p2(self.p1(y))).mean(dim=(2, 3)) * 1e-2
        return pose[:, :3], pose[:, 3:, None]


class Model(nn.Module):
    """frames (N, 3, H, W, C), target frame 1 -> (disparities coarse →
    fine, each (N, h, w, 1); for the sources 0 and 2, (rvec (N,3), tvec
    (N,3,1)) of the (earlier → later) pair)."""

    def __init__(self, in_channels: int = 1, scale_levels=(2, 3, 4, 5)):
        super().__init__()
        self.encoder = Encoder(in_channels)
        self.depth_decoder = DepthDecoder(scale_levels)
        self.pose_decoder = PoseDecoder()

    def set_fp8(self, on: bool) -> "Model":
        for m in self.modules():
            if isinstance(m, Conv):
                m.fp8 = on
        return self

    def forward(self, frames: Tensor):
        n, l, h, w, c = frames.shape
        feats = self.encoder(frames.reshape(n * l, h, w, c).permute(0, 3, 1, 2))
        feats = [f.reshape(n, l, *f.shape[1:]) for f in feats]
        disps = self.depth_decoder([f[:, 1] for f in feats])
        last = feats[-1]
        poses = [self.pose_decoder(last[:, 0], last[:, 1]), self.pose_decoder(last[:, 1], last[:, 2])]
        return [d.permute(0, 2, 3, 1) for d in disps], poses
