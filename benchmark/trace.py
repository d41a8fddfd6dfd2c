"""The traced segment of a `--trace 1` run: torch.profiler over the host's
operators and the card's activity, reduced to what the per-layer metrics
and the result's `breakdown` read.

The segment is marked on the host by the user range WINDOW; its length is
that range's. Busy time is the union of the intervals in which any device
activity (kernel, copy, fill) ran, clipped to the segment. An idle gap is
an interval of the segment with no device activity; it is named after the
innermost host event that covers its middle (a harness span such as
`bench.input_wait`, an operator, a CUDA runtime call), or "no host event";
gaps under 10 µs, between kernels queued ahead, are summed under one name.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"
LONG_GAP_US = 10.0  # shorter gaps lie between kernels that the host queued earlier


def _union(intervals, lo: float, hi: float) -> list:
    out = []
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


@dataclass
class DeviceTrace:
    """Times in seconds. `kernels` maps each device activity's name to its
    durations."""

    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)

    def durations(self, name: str) -> list:
        """Durations of the device activities whose name contains `name`."""
        return [d for k, ds in self.kernels.items() if name in k for d in ds]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, sum(ds)) for k, ds in self.kernels.items()), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], s] for k, s in ops], "idle_gaps": [[k[:160], s] for k, s in gaps]}


def _host_label(host: list, starts: list, t: float, look_back: int = 4000) -> str:
    """The name of the shortest host event, among the `look_back` latest
    to start by `t`, that covers `t`."""
    i = bisect.bisect_right(starts, t)
    covering = [h for h in host[max(0, i - look_back):i] if h[1] >= t]
    return min(covering, key=lambda h: h[1] - h[0])[2] if covering else "no host event"


def reduce(prof) -> DeviceTrace:
    """The segment of a finished profile (see the module's docstring)."""
    device, host, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, e.name))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} range")
    lo, hi = window
    busy = _union([(s, t) for s, t, _ in device], lo, hi)
    kernels = defaultdict(list)
    for s, t, name in device:
        if s >= lo and t <= hi:
            kernels[name].append((t - s) * 1e-6)
    idle = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host.sort()
    starts = [h[0] for h in host]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < LONG_GAP_US:
            idle["device gaps under 10 us"] += max(b - a, 0) * 1e-6
            continue
        idle[_host_label(host, starts, (a + b) / 2)] += (b - a) * 1e-6
    return DeviceTrace((hi - lo) * 1e-6, sum(t - s for s, t in busy) * 1e-6, dict(kernels), dict(idle))


@contextlib.contextmanager
def profiled():
    """Profile the host's operators and the card's activity; yields the
    profiler, whose events are read after the block by `reduce`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
