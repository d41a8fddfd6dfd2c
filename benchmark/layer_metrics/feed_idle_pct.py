"""Share of the traced segment in which the card sat idle while the host
was inside one of the feed's spans: the idle gaps that the trace names
after a `loader.*` or `feed.*` span (the innermost host event over a gap's
middle, so an operator that the profiler records inside such a span would
take the gap's name instead). Read where the program recorded its feed
spans; 0 there means the feed left the card no gap."""

from benchmark import recorder


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or recorder.seconds(recorder.snapshot(r), "loader.get") is None:
        return None
    idle = sum(s for name, s in r.trace.idle_by_host.items() if name.startswith(("loader.", "feed.")))
    return 100.0 * idle / r.trace.window_s
