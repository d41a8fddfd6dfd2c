"""PackNet-SfM's networks: the PackNet01 depth network (version 1A) and its
PoseNet, trained under this port's loss.

Guizilini et al., "3D Packing for Self-Supervised Monocular Depth
Estimation", CVPR 2020 (arXiv:1905.02693); code at
https://github.com/TRI-ML/packnet-sfm, `packnet_sfm/networks/depth/
PackNet01.py`, `networks/layers/packnet/layers01.py` and
`networks/pose/PoseNet.py`. NCHW inside; the model's interface is
`Model`'s: frames (N, L, H, W, C) in, disparities (N, h, w, 1) coarse →
fine and (rvec, tvec) per source out.

The depth network replaces strided convolutions and upsampling with
packing and unpacking. `Pack`: space-to-depth (`F.pixel_unshuffle`, the
source's view/permute), a 3-D convolution over the packed channels as a
depth axis (1 → 8 features, 3×3×3), then a 2-D convolution back to the
layer's width. `Unpack`: a 2-D convolution to a quarter of the output's
width over 8, the 3-D convolution, then depth-to-space
(`F.pixel_shuffle`). Every other 2-D convolution is `Conv2D`: zero-padded,
biased, GroupNorm(16) and ELU. Each scale's head is a sigmoid `inv_depth`;
its output s is what this port trains as the disparity, and the network
feeds s / 0.5 (the source's inverse depth) back into the decoder, upsampled
nearest.

Departures from the source, each kept so that the port's loss runs
unchanged (training/loss.py):
- the loss is this port's: border warp, no automasking, and the sigmoid s
  turned into depth by `disparity_to_depth` over [min_depth, max_depth];
  PackNet-SfM pads with zeros, automasks, and takes depth = 0.5 / s;
- the PoseNet runs once over both (earlier, later) pairs, stacked along
  the batch (2C input channels), and each pair's 6 outputs are read as the
  port's (axis-angle rvec, tvec); the source makes one call on the target
  and both references (3C channels) and reads (t, Euler angles);
- dropout is off, as is the source's default.

Weights: Glorot-uniform convolutions (2-D and 3-D, the source's
`xavier_uniform_`), zero biases, GroupNorm at 1/0, drawn by
`nn.core.reset_parameters`.

The host spans `depth_net`, `depth_net.pack`, `depth_net.unpack` and
`pose_net` (utils.profiler.span, no CUDA events) mark the forward, so that
an eager profile attributes each kernel to its layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..device import resolve_device
from ..nn.core import Conv, reset_parameters
from ..utils.profiler import span

GROUPS = 16  # GroupNorm's groups after every 2-D convolution
DEPTH_FEATURES = 8  # the 3-D convolution's output features (the source's d)
INV_DEPTH_SCALE = 0.5  # the source's InvDepth min_depth: inverse depth = s / 0.5

# PackNet01's widths, blocks and kernels (the source's defaults)
NI, N1, N2, N3, N4, N5 = 64, 64, 64, 128, 256, 512
NUM_BLOCKS = (2, 2, 3, 3)
PACK_KERNELS = (5, 3, 3, 3, 3)
UNPACK_KERNEL = ICONV_KERNEL = 3

POSE_CHANNELS = (16, 32, 64, 128, 256, 256, 256)
POSE_KERNELS = (7, 5, 3, 3, 3, 3, 3)


class Conv2D(nn.Module):
    """zero-pad k//2, conv (stride 1, bias), GroupNorm(16), ELU."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = Conv(cin, cout, k, 1, k // 2)
        self.norm = nn.GroupNorm(GROUPS, cout)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.norm(self.conv(x)))


class ResidualConv(nn.Module):
    """ELU(GroupNorm(Conv2D(o,o,3)(Conv2D(i,o,3)(x)) + conv1x1(x)))."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2D(cin, cout, 3)
        self.conv2 = Conv2D(cout, cout, 3)
        self.conv3 = Conv(cin, cout, 1)
        self.norm = nn.GroupNorm(GROUPS, cout)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.norm(self.conv2(self.conv1(x)) + self.conv3(x)))


def residual_block(cin: int, cout: int, blocks: int) -> nn.Sequential:
    return nn.Sequential(ResidualConv(cin, cout), *(ResidualConv(cout, cout) for _ in range(blocks - 1)))


def _conv3d(x: Tensor, conv3d: nn.Conv3d) -> Tensor:
    """(B, C, h, w) -> (B, 8C, h, w): the 3-D convolution over C as depth."""
    y = conv3d(x.unsqueeze(1))
    b, d, c, h, w = y.shape
    return y.reshape(b, d * c, h, w)


class Pack(nn.Module):
    """(B, C, H, W) -> (B, C, H/2, W/2): packing, the 3-D convolution, and
    Conv2D(32C → C, k)."""

    def __init__(self, channels: int, k: int):
        super().__init__()
        self.conv3d = nn.Conv3d(1, DEPTH_FEATURES, 3, padding=1)
        self.conv = Conv2D(4 * DEPTH_FEATURES * channels, channels, k)

    def forward(self, x: Tensor) -> Tensor:
        with span("depth_net.pack"):
            return self.conv(_conv3d(F.pixel_unshuffle(x, 2), self.conv3d))


class Unpack(nn.Module):
    """(B, i, h, w) -> (B, o, 2h, 2w): Conv2D(i → 4o/8, 3), the 3-D
    convolution, depth-to-space."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2D(cin, 4 * cout // DEPTH_FEATURES, UNPACK_KERNEL)
        self.conv3d = nn.Conv3d(1, DEPTH_FEATURES, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        with span("depth_net.unpack"):
            return F.pixel_shuffle(_conv3d(self.conv(x), self.conv3d), 2)


def inv_depth(channels: int) -> Conv:
    """The source's InvDepth: zero-pad 1, conv (c → 1, 3×3), sigmoid; its
    output s lies in (0, 1)."""
    return Conv(channels, 1, 3, 1, 1, act=torch.sigmoid)


def _up(s: Tensor) -> Tensor:
    """The source's inverse depth s / 0.5, upsampled 2× nearest."""
    return F.interpolate(s / INV_DEPTH_SCALE, scale_factor=2, mode="nearest")


class PackNet01(nn.Module):
    """images (N, C, H, W) -> [s4, s3, s2, s1], each (N, 1, h, w), coarse →
    fine at 1/8, 1/4, 1/2 and 1 of the input (scale levels 2-5)."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.pre_calc = Conv2D(in_channels, NI, 5)
        self.conv1 = Conv2D(NI, N1, 7)
        self.pack1 = Pack(N1, PACK_KERNELS[0])
        self.conv2 = residual_block(N1, N2, NUM_BLOCKS[0])
        self.pack2 = Pack(N2, PACK_KERNELS[1])
        self.conv3 = residual_block(N2, N3, NUM_BLOCKS[1])
        self.pack3 = Pack(N3, PACK_KERNELS[2])
        self.conv4 = residual_block(N3, N4, NUM_BLOCKS[2])
        self.pack4 = Pack(N4, PACK_KERNELS[3])
        self.conv5 = residual_block(N4, N5, NUM_BLOCKS[3])
        self.pack5 = Pack(N5, PACK_KERNELS[4])

        self.unpack5 = Unpack(N5, N5)
        self.iconv5 = Conv2D(N5 + N4, N5, ICONV_KERNEL)
        self.unpack4 = Unpack(N5, N4)
        self.iconv4 = Conv2D(N4 + N3, N4, ICONV_KERNEL)
        self.disp4 = inv_depth(N4)
        self.unpack3 = Unpack(N4, N3)
        self.iconv3 = Conv2D(N3 + N2 + 1, N3, ICONV_KERNEL)
        self.disp3 = inv_depth(N3)
        self.unpack2 = Unpack(N3, N2)
        self.iconv2 = Conv2D(N2 + N1 + 1, N2, ICONV_KERNEL)
        self.disp2 = inv_depth(N2)
        self.unpack1 = Unpack(N2, N1)
        self.iconv1 = Conv2D(N1 + NI + 1, N1, ICONV_KERNEL)
        self.disp1 = inv_depth(N1)

    def forward(self, image: Tensor) -> list:
        with span("depth_net"):
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
            i3 = self.iconv3(torch.cat([self.unpack3(i4), x2p, _up(s4)], 1))
            s3 = self.disp3(i3)
            i2 = self.iconv2(torch.cat([self.unpack2(i3), x1p, _up(s3)], 1))
            s2 = self.disp2(i2)
            i1 = self.iconv1(torch.cat([self.unpack1(i2), x, _up(s2)], 1))
            s1 = self.disp1(i1)
        return [s4, s3, s2, s1]


class PoseNet(nn.Module):
    """(earlier, later) image pairs (M, 2C, H, W) -> (M, 6): seven stride-2
    convolutions, each with GroupNorm(16) and ReLU, a 1×1 convolution to 6,
    the spatial mean, × 0.01."""

    def __init__(self, in_channels: int = 6):
        super().__init__()
        cin = in_channels
        for i, (cout, k) in enumerate(zip(POSE_CHANNELS, POSE_KERNELS)):
            self.add_module(f"conv{i + 1}", Conv(cin, cout, k, 2, (k - 1) // 2))
            self.add_module(f"norm{i + 1}", nn.GroupNorm(GROUPS, cout))
            cin = cout
        self.pose_pred = Conv(cin, 6, 1)

    def forward(self, pairs: Tensor) -> Tensor:
        with span("pose_net"):
            y = pairs
            for i in range(len(POSE_CHANNELS)):
                y = F.relu(getattr(self, f"norm{i + 1}")(getattr(self, f"conv{i + 1}")(y)))
            return self.pose_pred(y).mean(dim=(2, 3)) * 0.01


class PackNetModel(nn.Module):
    """PackNet01 and PoseNet behind `Model`'s interface."""

    architecture = "packnet01"
    SCALE_LEVELS = (2, 3, 4, 5)

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.depth_net = PackNet01(in_channels)
        self.pose_net = PoseNet(2 * in_channels)

    @staticmethod
    def create(in_channels: int = 3, scale_levels: Sequence[int] = SCALE_LEVELS, seed: int = 0,
               device: str | torch.device = "cuda") -> "PackNetModel":
        """Build the model with weights drawn from `seed`, on `device`. The
        network has four heads, at scale levels 2-5."""
        if tuple(scale_levels) != PackNetModel.SCALE_LEVELS:
            raise ValueError(f"PackNet01 predicts at scale levels {PackNetModel.SCALE_LEVELS}, not {tuple(scale_levels)}")
        device = resolve_device(device)
        model = PackNetModel(in_channels)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Re-draw every weight from `generator`."""
        reset_parameters(self, generator)

    def depth_network(self) -> nn.Module:
        """The depth network alone: images (N, C, H, W) -> disparities
        coarse → fine, each (N, 1, h, w)."""
        return self.depth_net

    def forward(self, frames: Tensor, source_ids: Sequence[int] = (0, 2), target_id: int = 1):
        """frames (N,L,H,W,C) -> (disparities coarse → fine, each (N,h,w,1);
        poses per source, each (rvec (N,3), tvec (N,3,1)) of the (earlier →
        later) pair)."""
        x = frames.permute(0, 1, 4, 2, 3).contiguous()
        disparities = self.depth_net(x[:, target_id])
        pairs = [(x[:, sid], x[:, target_id]) if sid < target_id else (x[:, target_id], x[:, sid])
                 for sid in source_ids]
        pose = self.pose_net(torch.cat([torch.cat(pair, 1) for pair in pairs], 0))
        poses = [(p[:, :3], p[:, 3:, None]) for p in pose.chunk(len(pairs))]
        return [d.permute(0, 2, 3, 1) for d in disparities], poses

    @torch.no_grad()
    def eval_disparity(self, x: Tensor) -> list:
        """Single-image disparity inference in eval mode: x (N,H,W,C) ->
        disparities coarse → fine, each (N,h,w,1)."""
        was_training = self.training
        self.eval()
        try:
            disparities = self.depth_net(x.permute(0, 3, 1, 2))
        finally:
            self.train(was_training)
        return [d.permute(0, 2, 3, 1) for d in disparities]
