"""The whole train step's share of the H100's dense bf16 peak for a cell of
kind `train_arch`: the FLOPs of one step, counted on the reference of the
cell's architecture at its shapes (`step_flops` of
`benchmark/reference/<module>.py`, kinds/train_arch.REFERENCES), over the
measured window's time a step."""

from benchmark import costs
from benchmark.kinds import train_arch


def read(r):
    if not r.steps or r.window_s <= 0 or "architecture" not in r.config:
        return None
    flops = train_arch.reference_module(r.config).step_flops(r.config)
    return 100.0 * flops / (r.window_s / r.steps) / costs.BF16_FLOPS
