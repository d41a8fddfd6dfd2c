"""Device milliseconds a train step between the CUDA events that the
program records on its stream at the start and end of each `step.call`
span, in the traced segment, over its steps."""

from benchmark import recorder


def read(r):
    snap = recorder.snapshot(r)
    d = snap["device"].get("step.call") if snap else None
    return recorder.per_step_ms(r, d["total_s"] if d else None)
