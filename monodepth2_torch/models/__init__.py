"""Models, port of monodepth2_tpu/models: ResNet stage encoder, U-Net depth
decoder, pose decoder and the combined Model; and PackNet-SfM's networks
(packnet.py), which the JAX package does not have. `create_model` builds the
one a TrainConfig names."""

from __future__ import annotations

import torch

from .depth_decoder import DepthDecoder
from .model import Model
from .packnet import PackNetModel
from .pose_decoder import PoseDecoder
from .resnet import ResNetEncoder

__all__ = ["ResNetEncoder", "DepthDecoder", "PoseDecoder", "Model", "PackNetModel", "create_model"]


def create_model(cfg, seed: int = 0, device: str | torch.device = "cuda") -> torch.nn.Module:
    """The network of `cfg.architecture` (a TrainConfig), with weights drawn
    from `seed`, on `device`."""
    if cfg.architecture == "packnet01":
        return PackNetModel.create(in_channels=cfg.in_channels, scale_levels=cfg.scale_levels, seed=seed,
                                   device=device)
    return Model.create(depth=cfg.encoder_depth, in_channels=cfg.in_channels, scale_levels=cfg.scale_levels,
                        pose_tz_init=cfg.pose_tz_init, seed=seed, device=device)
