"""The grid sample's coordinate VJP's achieved bandwidth: the bytes the operation
must move at the cell's warp shape (`costs.grid_sample_bytes`), over the
mean device time of a launch of `grid_sample_bwd_uv_kernel` in the traced
segment, in GB/s. Not a roofline share: inside the step the kernel finds
its inputs in the L2 cache, so it can pass the HBM's 3,350 GB/s. A
program that renames or fuses the kernel leaves it unread."""

from benchmark import costs

KERNEL = "grid_sample_bwd_uv_kernel"


def read(r):
    if r.trace is None:
        return None
    times = r.trace.durations(KERNEL)
    if not times:
        return None
    return costs.grid_sample_bytes(*costs.warp_shape(r.config))["bwd_uv"] / (sum(times) / len(times)) / 1e9
