"""Models, port of monodepth2_tpu/models: ResNet stage encoder, U-Net depth
decoder, pose decoder and the combined Model."""

from .depth_decoder import DepthDecoder
from .model import Model
from .pose_decoder import PoseDecoder
from .resnet import ResNetEncoder

__all__ = ["ResNetEncoder", "DepthDecoder", "PoseDecoder", "Model"]
