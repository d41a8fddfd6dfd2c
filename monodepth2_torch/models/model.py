"""Combined depth + pose model, port of monodepth2_tpu/models/model.py
(reference src/model.jl).

The public interface keeps the JAX layouts: frames (N, L, H, W, C) in,
disparities (N, h, w, 1) out. Inside, the 3-frame axis folds into the batch so
the encoder runs once over all frames (model.py:72-78), in NCHW; the depth
decoder sees the target frame's features only, and the pose decoder runs per
source on feature pairs ordered (earlier, later) (model.py:85-95).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import Tensor, nn

from ..device import resolve_device
from ..nn.core import reset_parameters
from .depth_decoder import DepthDecoder
from .pose_decoder import PoseDecoder
from .resnet import ResNetEncoder


class Model(nn.Module):
    def __init__(self, encoder: ResNetEncoder, depth_decoder: DepthDecoder, pose_decoder: PoseDecoder):
        super().__init__()
        self.encoder = encoder
        self.depth_decoder = depth_decoder
        self.pose_decoder = pose_decoder

    @staticmethod
    def create(
        depth: int = 18,
        in_channels: int = 1,
        scale_levels: Sequence[int] = (2, 3, 4, 5),
        pose_tz_init: float = 0.0,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> "Model":
        """Build the model with weights drawn from `seed`, on `device`."""
        device = resolve_device(device)
        encoder = ResNetEncoder(depth=depth, in_channels=in_channels)
        model = Model(
            encoder,
            DepthDecoder(encoder.stages, scale_levels),
            PoseDecoder(encoder.stages[-1], tz_init=pose_tz_init),
        )
        model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Re-draw every weight from `generator` and reset the BN statistics."""
        reset_parameters(self, generator)

    def forward(self, frames: Tensor, source_ids: Sequence[int] = (0, 2), target_id: int = 1):
        """frames (N,L,H,W,C) -> (disparities coarse → fine, each (N,h,w,1);
        poses per source, each (rvec (N,3), tvec (N,3,1))). In training mode
        the forward updates the BN running statistics in place."""
        n, l, h, w, c = frames.shape
        flat = frames.reshape(n * l, h, w, c).permute(0, 3, 1, 2)
        feats = [f.reshape(n, l, *f.shape[1:]) for f in self.encoder(flat)]
        disparities = self.depth_decoder([f[:, target_id] for f in feats])
        last = feats[-1]
        poses = []
        for sid in source_ids:
            if sid < target_id:
                pair = (last[:, sid], last[:, target_id])
            else:
                pair = (last[:, target_id], last[:, sid])
            poses.append(self.pose_decoder(pair))
        return [d.permute(0, 2, 3, 1) for d in disparities], poses

    @torch.no_grad()
    def eval_disparity(self, x: Tensor) -> list:
        """Single-image disparity inference in eval mode: x (N,H,W,C) ->
        disparities coarse → fine, each (N,h,w,1) (model.py:100)."""
        was_training = self.training
        self.eval()
        try:
            disparities = self.depth_decoder(self.encoder(x.permute(0, 3, 1, 2)))
        finally:
            self.train(was_training)
        return [d.permute(0, 2, 3, 1) for d in disparities]
