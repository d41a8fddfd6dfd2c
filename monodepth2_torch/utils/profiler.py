"""Step timing / throughput and the torch.profiler trace hook, port of
monodepth2_tpu/utils/profiler.py.

`StepTimer` is framework-free and copied as it is. `trace` is the
torch.profiler counterpart of the jax.profiler context. `jit_trace_count`
(the retrace tripwire of a jitted step) has nothing to port: PyTorch runs
eagerly and compiles no traces.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional, Union

import torch

L2_FLUSH_BYTES = 128 * 2**20  # well over the H100's 50 MB L2


class StepTimer:
    """Rolling-window step timer; images/sec via batch size."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        if not self.times:
            return float("nan")
        return sum(self.times) / len(self.times)

    def images_per_sec(self, batch_size: int) -> float:
        s = self.mean_step_s
        return batch_size / s if s > 0 else float("nan")


def time_ms(
    fn: Callable[[], object],
    device: torch.device,
    iters: int,
    warmup: int = 3,
    flush_l2: Union[bool, str] = False,
) -> float:
    """Milliseconds of the card's time for one fn() call, after `warmup`
    calls.

    flush_l2 True: the cold case, what a call finds when other
    work ran before it. The median over `iters` calls, each timed alone with
    CUDA events after a 128 MB write has evicted the L2 and a 128 MB read
    (a sum into a preallocated scalar) has then evicted the write's dirty
    lines, so the L2 the call finds is clean and the call writes back to
    device memory nothing but its own bytes. "dirty": the same without the
    read, the yardstick used before, where the call starts by writing back
    up to 50 MB of the flush buffer as it fills the L2 (up to ~15 µs at
    3.35 TB/s). False: the warm case, the median over 3 windows of the mean
    of `iters` back-to-back calls (inputs still in L2 from the call before).

    Before each start event the stream runs a device-side sleep that
    outlasts the host's enqueue of the timed calls, so they are all queued
    when the event fires and the host's time per call (which for a wrapper
    written in Python can exceed its kernel's) is not counted; the median
    drops the calls that a stall of the shared host delayed all the same. On
    the CPU: the mean host-clock time of `iters` calls; there is no L2 to
    flush.
    """
    if flush_l2 not in (False, True, "dirty"):
        raise ValueError(f"flush_l2 must be False, True or 'dirty', got {flush_l2!r}")
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)

    def sleep_covering(calls: int) -> None:
        # twice the host's enqueue time of `calls` calls, counted at 2 GHz
        # (the H100's top clock is 1.98 GHz: a slower clock sleeps longer)
        torch.cuda._sleep(int(2 * calls * enqueue_s * 2e9) + 100_000)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    if flush_l2:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        clean = flush_l2 is True
        if clean:
            scrub = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
            sink = torch.empty((), dtype=torch.float32, device=device)
        for _ in range(iters):
            flush.zero_()
            if clean:
                torch.sum(scrub, dim=0, out=sink)
            sleep_covering(1)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(3):
            sleep_covering(iters)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def wall_ms(fn: Callable[[], object], device: torch.device, iters: int, warmup: int = 2, windows: int = 2) -> list:
    """What a caller waits for fn(), host time included: for each of
    `windows` windows, the mean milliseconds of `iters` back-to-back calls,
    after `warmup` calls, from a drained card to a drained card. Timed with
    CUDA events on a card (on an idle card the start event fires as it is
    enqueued) and with the host clock on the CPU. Callers report the best
    window: a stall of the shared host only ever slows one."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(windows):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            out.append((time.perf_counter() - t0) / iters * 1e3)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, host: bool = True):
    """Profile the card, when there is one, and with `host` the host's
    operators and their input shapes, and yield the `torch.profiler.profile`
    object (its events, `key_averages()`). Recording host operators costs host time on every
    operator, enough to leave an eager step's card idle longer; a measure of
    the card's idle share turns `host` off. On exit, if `log_dir` is given,
    write the Chrome trace (Perfetto, chrome://tracing) to log_dir/trace.json."""
    activities = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if not activities:
        raise ValueError("trace(host=False) without a CUDA device has nothing to record")
    with torch.profiler.profile(activities=activities, record_shapes=host) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
