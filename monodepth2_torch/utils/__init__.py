"""Observability utilities, port of monodepth2_tpu/utils: step timing and
the profiler trace hook. Depth metrics and visualization come in a later
slice of the port."""

from .profiler import StepTimer, trace

__all__ = ["StepTimer", "trace"]
