"""The 3-D convolutions' forwards' achieved bandwidth, in a cell of kind
`train_arch` whose network packs (PackNet): the bf16 bytes those forwards
must move at the cell's shapes (each input volume read once and its 8×
output written once, `pack3d_bytes(config, forward_only=True)` of the
architecture's reference) over the device time a step of cuDNN's
three-dimensional implicit-GEMM forward kernel, in GB/s. The data and
weight gradients of these convolutions run in kernels that the 2-D
convolutions launch too, so no name singles them out and they are not
read (PERF.md). A program that runs the forwards in another kernel leaves
it unread."""

from benchmark.kinds import train_arch

KERNEL = "implicit_convolveNd_sgemm<__nv_bfloat16, 3,"


def read(r):
    if r.trace is None or not r.trace_steps or "architecture" not in r.config:
        return None
    ref = train_arch.reference_module(r.config)
    times = r.trace.durations(KERNEL)
    if not times or not hasattr(ref, "pack3d_bytes"):
        return None
    return ref.pack3d_bytes(r.config, forward_only=True) / (sum(times) / r.trace_steps) / 1e9
