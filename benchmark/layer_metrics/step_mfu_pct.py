"""The whole train step's share of the H100's dense bf16 peak: the FLOPs of
one step, counted on the benchmark's reference at the cell's shapes
(`costs.step_flops`), over the measured window's time a step."""

from benchmark import costs


def read(r):
    if not r.steps or r.window_s <= 0:
        return None
    return 100.0 * costs.step_flops(r.config) / (r.window_s / r.steps) / costs.BF16_FLOPS
