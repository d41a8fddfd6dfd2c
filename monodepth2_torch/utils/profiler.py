"""Step timing / throughput, the torch.profiler trace hook and the
program's own spans and counters, port of monodepth2_tpu/utils/profiler.py.

`StepTimer` is framework-free and copied as it is. `trace` is the
torch.profiler counterpart of the jax.profiler context. `jit_trace_count`
(the retrace tripwire of a jitted step) has nothing to port: PyTorch runs
eagerly and compiles no traces.

The recorder (`span`, `count`, `snapshot`, `reset`, switched by `record`)
keeps the spans and counters that the training feed and the scanned step
mark (PERF.md, "Tracing"). It records while it is switched on and while a
torch.profiler session records in this process; otherwise `span` returns
one shared null context after a flag check, and `count` returns at once.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Callable, Optional, Union

import torch
import torch.autograd.profiler as _torch_profiler

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


class Recorder:
    """Spans and counters in memory. A span is (id, parent id or 0, name,
    thread name, start ns, end ns) on `time.perf_counter_ns()`; its parent
    is the span open on the same thread when it began (a thread-local
    stack, so a span must not stay open across a `yield`). `events` holds
    (name, start, end) CUDA event pairs of spans that time the card."""

    def __init__(self):
        self.on = False
        self.spans: list = []
        self.counters: dict = defaultdict(int)
        self.events: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def stack(self) -> list:
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.thread = [], threading.current_thread().name
        return local.stack


_RECORDER = Recorder()
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "id", "parent", "stack", "function", "start", "t0")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = self.stack = _RECORDER.stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_RECORDER._ids)
        stack.append(self.id)
        # each clock is read before the call that may wait for the GIL on
        # return (record_function's enter and exit), so that the two start
        # and the two end stamps lie microseconds apart
        self.t0 = time.perf_counter_ns()
        self.function = torch.profiler.record_function(self.name)
        self.function.__enter__()
        self.start = None
        if self.device is not None and self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _RECORDER.events.append((self.name, self.start, end))
        self.function.__exit__(*exc)
        self.stack.pop()
        _RECORDER.spans.append((self.id, self.parent, self.name, _RECORDER._local.thread, self.t0, t1))
        return False


def record(on: bool) -> None:
    """Switch the recorder on or off (off by default)."""
    _RECORDER.on = bool(on)


def recording() -> bool:
    """Whether spans and counters are kept now: the recorder is switched on,
    or a torch.profiler session records."""
    return _RECORDER.on or _torch_profiler._is_profiler_enabled


def span(name: str, device: Optional[torch.device] = None):
    """A context that records span `name` while `recording()`, and then
    also enters `torch.profiler.record_function(name)`, so that a profile
    of the thread that started the profiler holds it on the device trace's
    clock. With a CUDA `device`, CUDA events on its current stream at the
    start and end time the card's work between them (`snapshot`'s
    `device`). Off, it returns one shared null context."""
    if not (_RECORDER.on or _torch_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while `recording()`."""
    if not (_RECORDER.on or _torch_profiler._is_profiler_enabled):
        return
    with _RECORDER._lock:
        _RECORDER.counters[name] += n


def reset() -> None:
    """Forget every span, counter and event recorded so far."""
    with _RECORDER._lock:
        _RECORDER.spans, _RECORDER.events = [], []
        _RECORDER.counters = defaultdict(int)


def snapshot() -> dict:
    """What the recorder holds, by name: `spans` {name: {count, total_s,
    self_s}} (self time: the duration less what the span's children
    cover), `counters` {name: value}, and `device` {name: {count,
    total_s}}, the card's time between each CUDA event pair, read after
    the end event has completed."""
    spans, events = list(_RECORDER.spans), list(_RECORDER.events)
    children = defaultdict(int)
    for _, parent, _, _, t0, t1 in spans:
        if parent:
            children[parent] += t1 - t0
    by_name = {}
    for sid, _, name, _, t0, t1 in spans:
        s = by_name.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += (t1 - t0) * 1e-9
        s["self_s"] += (t1 - t0 - children.get(sid, 0)) * 1e-9
    device = {}
    for name, start, end in events:
        end.synchronize()
        d = device.setdefault(name, {"count": 0, "total_s": 0.0})
        d["count"] += 1
        d["total_s"] += start.elapsed_time(end) * 1e-3
    with _RECORDER._lock:
        counters = dict(_RECORDER.counters)
    return {"spans": by_name, "counters": counters, "device": device}


def _clock_offset_ns() -> int:
    """Unix time less `perf_counter_ns()`, now: the profiler stamps its
    events on the Unix clock, in µs after `baseTimeNanoseconds` in its
    Chrome trace."""
    p0 = time.perf_counter_ns()
    wall = time.time_ns()
    p1 = time.perf_counter_ns()
    return wall - (p0 + p1) // 2


def _add_spans(path: Path, spans: list, offset_ns: int) -> None:
    """Append `spans` to the Chrome trace at `path`, on its timeline, as
    complete events of category `program_span` under a process of their
    own, one thread track for each thread that recorded them."""
    with open(path) as f:
        data = json.load(f)
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = f"monodepth2_torch spans ({os.getpid()})"
    names = {sid: name for sid, _, name, _, _, _ in spans}
    data["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": thread,
         "ts": (t0 + offset_ns - base) / 1e3, "dur": (t1 - t0) / 1e3,
         "args": {"parent": names.get(parent)} if parent else {}}
        for _, parent, name, thread, t0, t1 in spans)
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, host: bool = True):
    """Profile the card, when there is one, and with `host` the host's
    operators and their input shapes, and yield the `torch.profiler.profile`
    object (its events, `key_averages()`). Recording host operators costs host time on every
    operator, enough to leave an eager step's card idle longer; a measure of
    the card's idle share turns `host` off. The recorder is switched on
    inside the block. On exit, if `log_dir` is given, write the Chrome trace
    (Perfetto, chrome://tracing) to log_dir/trace.json, with the spans that
    every thread recorded in the block (the loader's producer thread too,
    which the profiler does not record) on the profiler's timeline."""
    activities = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    if not activities:
        raise ValueError("trace(host=False) without a CUDA device has nothing to record")
    was_on = _RECORDER.on
    with torch.profiler.profile(activities=activities, record_shapes=host) as prof:
        offset_ns, start_ns = _clock_offset_ns(), time.perf_counter_ns()
        record(True)
        try:
            yield prof
        finally:
            record(was_on)
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        path = Path(log_dir) / "trace.json"
        prof.export_chrome_trace(str(path))
        _add_spans(path, [s for s in _RECORDER.spans if s[4] >= start_ns], offset_ns)
