"""Device-busy milliseconds a train step: the union of the card's activity
in the traced segment over the steps it ran."""


def read(r):
    if r.trace is None or not r.trace_steps or r.trace.busy_s <= 0:
        return None
    return r.trace.busy_s / r.trace_steps * 1e3
