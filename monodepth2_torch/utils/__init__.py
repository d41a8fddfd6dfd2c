"""Observability utilities, port of monodepth2_tpu/utils: step timing, the
profiler trace hook, the PNG output of disparities and warped frames, and
the depth-accuracy metrics."""

from .metrics import depth_metrics
from .profiler import StepTimer, trace
from .viz import save_disparity, save_warped

__all__ = ["depth_metrics", "StepTimer", "trace", "save_disparity", "save_warped"]
