"""Observability utilities, port of monodepth2_tpu/utils: step timing, the
profiler trace hook and the PNG output of disparities and warped frames.
Depth metrics come in a later slice of the port."""

from .profiler import StepTimer, trace
from .viz import save_disparity, save_warped

__all__ = ["StepTimer", "trace", "save_disparity", "save_warped"]
