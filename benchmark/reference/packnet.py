"""Plain float32 reference of PackNet-SfM's networks: the PackNet01 depth
network (version 1A) and its PoseNet, and the counts of the cell's work.

Written from Guizilini et al., "3D Packing for Self-Supervised Monocular
Depth Estimation" (CVPR 2020, arXiv:1905.02693) and its code
(https://github.com/TRI-ML/packnet-sfm: `networks/depth/PackNet01.py`,
`networks/layers/packnet/layers01.py`, `networks/pose/PoseNet.py`), as the
program under test trains them:

- Conv2D(i, o, k): zero-pad k//2, conv (bias), GroupNorm(16), ELU.
- ResidualConv(i, o): ELU(GroupNorm(16)(Conv2D(o,o,3)(Conv2D(i,o,3)(x)) +
  conv1x1(x))); a block is one (i, o) and n-1 (o, o).
- packing: (B,C,H,W) -> view (B,C,H/2,2,W/2,2), permute (0,1,3,5,2,4),
  (B,4C,H/2,W/2). Pack(c, k): packing, a 3-D convolution (1 -> 8, 3×3×3,
  pad 1) over the packed channels as depth, (B,32c,H/2,W/2), Conv2D(32c ->
  c, k). Unpack(i, o): Conv2D(i -> o/2, 3), the 3-D convolution,
  (B,4o,h,w), depth-to-space by 2.
- InvDepth(c): zero-pad 1, conv (c -> 1, 3), sigmoid: s. The decoder feeds
  back s / 0.5 upsampled 2× nearest.
- Encoder 64 (5×5), 64 (7×7), then packs (kernels 5,3,3,3,3) between blocks
  of 2, 2, 3, 3 at 64, 128, 256, 512; decoder 1A (concatenation), heads
  at 1/8 … 1; returns s4 … s1.
- PoseNet: seven stride-2 convs (16,32,64,128,256,256,256; kernels
  7,5,3,3,3,3,3; pad (k-1)//2) each with GroupNorm(16) and ReLU, a 1×1 conv
  to 6, the spatial mean, × 0.01, run on each (earlier, later) pair of
  frames (2C channels) and read as (axis-angle rvec, tvec).

The departures from the source are the program's (`monodepth2_torch/models/
packnet.py`): this repository's loss (`reference/train.py`) with its border
warp and disparity-to-depth mapping, and the pose network's pairs. Names
are those of the program's state dict. Nothing here imports the program.
Every convolution, 2-D and 3-D, can compute in float8 (`set_fp8`), the
comparison's control, as `reference/model.py`'s do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.utils.flop_counter import FlopCounterMode

from . import train as ref_train
from .model import fake_fp8

EPS = 1e-5  # GroupNorm's


class Conv(nn.Module):
    """A 2-D (k×k) or 3-D (k×k×k) convolution with bias, zero-padded by
    `pad`, stride `stride`, with an optional activation."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, pad: int = 0, dims: int = 2, act=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(k,) * dims))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.pad, self.act = stride, pad, act
        self.fp8 = False

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        conv = F.conv3d if w.dim() == 5 else F.conv2d
        y = conv(x, w, self.bias, self.stride, self.pad)
        y = self.act(y) if self.act is not None else y
        return fake_fp8(y) if self.fp8 else y


class GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        return F.group_norm(x, 16, self.weight, self.bias, EPS)


class Conv2D(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv(cin, cout, k, 1, k // 2)
        self.norm = GroupNorm(cout)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.norm(self.conv(x)))


class ResidualConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2D(cin, cout, 3)
        self.conv2 = Conv2D(cout, cout, 3)
        self.conv3 = Conv(cin, cout, 1)
        self.norm = GroupNorm(cout)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.norm(self.conv2(self.conv1(x)) + self.conv3(x)))


def packing(x: Tensor) -> Tensor:
    b, c, h, w = x.shape
    x = x.contiguous().view(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 1, 3, 5, 2, 4).contiguous().view(b, 4 * c, h // 2, w // 2)


def volume(x: Tensor, conv3d: Conv) -> Tensor:
    """The 3-D convolution over the channels as depth: (B,C,h,w) -> (B,8C,h,w)."""
    y = conv3d(x.unsqueeze(1))
    b, d, c, h, w = y.shape
    return y.reshape(b, d * c, h, w)


class Pack(nn.Module):
    def __init__(self, c: int, k: int):
        super().__init__()
        self.conv3d = Conv(1, 8, 3, 1, 1, dims=3)
        self.conv = Conv2D(32 * c, c, k)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(volume(packing(x), self.conv3d))


class Unpack(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2D(cin, cout // 2, 3)
        self.conv3d = Conv(1, 8, 3, 1, 1, dims=3)

    def forward(self, x: Tensor) -> Tensor:
        return F.pixel_shuffle(volume(self.conv(x), self.conv3d), 2)


def up(s: Tensor) -> Tensor:
    return F.interpolate(s / 0.5, scale_factor=2, mode="nearest")


class PackNet01(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.pre_calc = Conv2D(in_channels, 64, 5)
        self.conv1 = Conv2D(64, 64, 7)
        widths, blocks = (64, 64, 128, 256, 512), (2, 2, 3, 3)
        for i, k in enumerate((5, 3, 3, 3, 3)):
            self.add_module(f"pack{i + 1}", Pack(widths[i], k))
            if i < 4:
                cin, cout = widths[i], widths[i + 1]
                self.add_module(f"conv{i + 2}", nn.Sequential(
                    ResidualConv(cin, cout), *(ResidualConv(cout, cout) for _ in range(blocks[i] - 1))))
        self.unpack5, self.iconv5 = Unpack(512, 512), Conv2D(768, 512, 3)
        self.unpack4, self.iconv4 = Unpack(512, 256), Conv2D(384, 256, 3)
        self.unpack3, self.iconv3 = Unpack(256, 128), Conv2D(193, 128, 3)
        self.unpack2, self.iconv2 = Unpack(128, 64), Conv2D(129, 64, 3)
        self.unpack1, self.iconv1 = Unpack(64, 64), Conv2D(129, 64, 3)
        for level, c in ((4, 256), (3, 128), (2, 64), (1, 64)):
            self.add_module(f"disp{level}", Conv(c, 1, 3, 1, 1, act=torch.sigmoid))

    def forward(self, image: Tensor) -> list:
        x = self.pre_calc(image)
        x1 = self.conv1(x)
        x1p = self.pack1(x1)
        x2p = self.pack2(self.conv2(x1p))
        x3p = self.pack3(self.conv3(x2p))
        x4p = self.pack4(self.conv4(x3p))
        x5p = self.pack5(self.conv5(x4p))
        i5 = self.iconv5(torch.cat([self.unpack5(x5p), x4p], 1))
        i4 = self.iconv4(torch.cat([self.unpack4(i5), x3p], 1))
        s4 = self.disp4(i4)
        i3 = self.iconv3(torch.cat([self.unpack3(i4), x2p, up(s4)], 1))
        s3 = self.disp3(i3)
        i2 = self.iconv2(torch.cat([self.unpack2(i3), x1p, up(s3)], 1))
        s2 = self.disp2(i2)
        i1 = self.iconv1(torch.cat([self.unpack1(i2), x, up(s2)], 1))
        return [s4, s3, s2, self.disp1(i1)]


class PoseNet(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        cin = in_channels
        for i, (cout, k) in enumerate(zip((16, 32, 64, 128, 256, 256, 256), (7, 5, 3, 3, 3, 3, 3))):
            self.add_module(f"conv{i + 1}", Conv(cin, cout, k, 2, (k - 1) // 2))
            self.add_module(f"norm{i + 1}", GroupNorm(cout))
            cin = cout
        self.pose_pred = Conv(256, 6, 1)

    def forward(self, pair: Tensor) -> tuple:
        y = pair
        for i in range(7):
            y = F.relu(getattr(self, f"norm{i + 1}")(getattr(self, f"conv{i + 1}")(y)))
        pose = self.pose_pred(y).mean(dim=(2, 3)) * 0.01
        return pose[:, :3], pose[:, 3:, None]


class Model(nn.Module):
    """frames (N, 3, H, W, C), target frame 1 -> (disparities coarse →
    fine, each (N, h, w, 1); for the sources 0 and 2, (rvec (N,3), tvec
    (N,3,1)) of the (earlier → later) pair)."""

    def __init__(self, in_channels: int = 3, scale_levels=(2, 3, 4, 5)):
        super().__init__()
        if tuple(scale_levels) != (2, 3, 4, 5):
            raise ValueError(f"PackNet01 predicts at scale levels 2-5, not {tuple(scale_levels)}")
        self.depth_net = PackNet01(in_channels)
        self.pose_net = PoseNet(2 * in_channels)

    def set_fp8(self, on: bool) -> "Model":
        for m in self.modules():
            if isinstance(m, Conv):
                m.fp8 = on
        return self

    def forward(self, frames: Tensor):
        x = frames.permute(0, 1, 4, 2, 3)
        disps = self.depth_net(x[:, 1])
        poses = [self.pose_net(torch.cat([x[:, 0], x[:, 1]], 1)), self.pose_net(torch.cat([x[:, 1], x[:, 2]], 1))]
        return [d.permute(0, 2, 3, 1) for d in disps], poses


@torch.no_grad()
def fill_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Every convolution's weight, 2-D and 3-D, Glorot-uniform (fan in + fan
    out over the kernel's taps) from one draw for the whole model, biases
    zero; GroupNorm scale 1, shift 0."""
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    flat = torch.rand(sum(m.weight.numel() for m in convs), generator=gen, device=convs[0].weight.device) * 2 - 1
    at = 0
    for m in convs:
        cout, cin, *taps = m.weight.shape
        limit = math.sqrt(6.0 / (math.prod(taps) * (cin + cout)))
        m.weight.copy_(flat[at:at + m.weight.numel()].view_as(m.weight) * limit)
        at += m.weight.numel()
        m.bias.zero_()
    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def step_flops(config: dict) -> int:
    """Matrix-product and convolution FLOPs of one training step (the loss of
    `reference/train.py` and its backward) at the configuration's shapes,
    counted by FlopCounterMode on the meta device."""
    width, height = config["target_size"]
    device = torch.device("meta")
    model = Model(config["in_channels"], tuple(config["scale_levels"])).to(device)
    frames = torch.empty((config["batch_size"], 3, height, width, config["in_channels"]), device=device)
    with FlopCounterMode(display=False) as counter:
        ref_train.loss(model, frames, torch.eye(3, device=device), config, 0).backward()
    return counter.get_total_flops()


def pack3d_volumes(config: dict) -> list:
    """The input volume (elements) of each 3-D convolution of one step's
    depth network: the five packs' packed inputs and the five unpacks'
    2-D convolution outputs, times the batch."""
    width, height = config["target_size"]
    n = config["batch_size"]
    packs = [(c, 2 ** i) for i, c in enumerate((64, 64, 128, 256, 512))]  # (channels, stride of the input)
    unpacks = [(cout // 2, 2 ** (i + 1)) for i, cout in enumerate((64, 64, 128, 256, 512))]
    return ([n * 4 * c * (height // s // 2) * (width // s // 2) for c, s in packs]
            + [n * c * (height // s) * (width // s) for c, s in unpacks])


def pack3d_bytes(config: dict, forward_only: bool = False) -> int:
    """bf16 bytes the 3-D convolutions of one step must move: for each, its
    input volume V read and its 8V output written once (forward), the 8V
    output gradient read and the V input gradient written (data gradient),
    and V and 8V read (weight gradient): 27 V elements of 2 bytes, or 9 V
    for the forwards alone."""
    passes = 9 if forward_only else 27
    return sum(passes * 2 * v for v in pack3d_volumes(config))
