"""The port's recorder (monodepth2_torch.utils.profiler: `span`, `count`,
`snapshot`, `reset`, `record`) and the spans and counters that the training
feed and the scanned step mark, on the CPU; fit's `img_per_sec` under a
patched clock; and, marked `gpu`, what only the card shows: an idle gap
named after a program span, the CUDA graph's captures and replays, the
bytes pinned. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""

import contextlib
import json
import statistics
import threading
import time
import types

import numpy as np
import pytest
import torch

from monodepth2_torch.data import DataLoader, SyntheticTriplets, device_prefetch
from monodepth2_torch.training import TrainConfig
from monodepth2_torch.training import loop as loop_module
from monodepth2_torch.training.loop import _group_batches
from monodepth2_torch.utils import profiler


@pytest.fixture(autouse=True)
def recorder():
    """A recorder switched off and emptied before and after each test."""
    profiler.record(False)
    profiler.reset()
    yield
    profiler.record(False)
    profiler.reset()


class Items:
    """n items (3, 4, 4, 1) float32, item i filled with i."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((3, 4, 4, 1), float(i), np.float32)


def feed(n_items=10, batch=2, group=2, device="cpu"):
    """fit's feed over `Items`: the loader, groups of `group`, device_prefetch."""
    loader = DataLoader(Items(n_items), batch, shuffle=False)
    return list(device_prefetch(_group_batches(iter(loader), group), size=2, device=device))


def test_off_records_nothing_and_returns_the_shared_null_context():
    assert not profiler.recording()
    first, second = profiler.span("loader.get"), profiler.span("step.call", torch.device("cpu"))
    assert first is second and isinstance(first, contextlib.nullcontext)
    with profiler.span("feed.stack"):
        profiler.count("loader.batches")
    feed()
    assert profiler.snapshot() == {"spans": {}, "counters": {}, "device": {}}


def test_cpu_feed_records_a_get_per_get_and_a_stack_per_group():
    profiler.record(True)
    groups = feed(n_items=10, batch=2, group=2)
    assert [g.shape[0] for g in groups] == [2, 2, 1]
    spans = profiler.snapshot()["spans"]
    # 5 batches and the end of the epoch, each one q.get()
    assert spans["loader.get"]["count"] == 6
    assert spans["feed.stack"]["count"] == 3
    assert "feed.pin" not in spans


def test_loader_batch_comes_from_the_producer_thread():
    profiler.record(True)
    feed(n_items=14, batch=2, group=3)
    snap = profiler.snapshot()
    assert snap["spans"]["loader.batch"]["count"] == snap["counters"]["loader.batches"] == 7
    threads = {name: {s[3] for s in profiler._RECORDER.spans if s[2] == name}
               for name in ("loader.get", "loader.batch")}
    assert threads["loader.get"] == {threading.current_thread().name}
    assert len(threads["loader.batch"]) == 1 and threads["loader.batch"] != threads["loader.get"]


def test_nothing_is_pinned_on_the_cpu():
    profiler.record(True)
    feed()
    snap = profiler.snapshot()
    assert snap["counters"].get("feed.bytes_pinned", 0) == 0
    assert "feed.pin" not in snap["spans"]


def test_self_time_is_the_duration_less_the_children():
    profiler.record(True)
    with profiler.span("outer"):
        time.sleep(0.01)
        with profiler.span("inner"):
            time.sleep(0.02)
        with profiler.span("inner"):
            time.sleep(0.005)

    def elsewhere():
        with profiler.span("elsewhere"):
            pass

    with profiler.span("outer"):
        other = threading.Thread(target=elsewhere)
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    spans = profiler.snapshot()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    assert outer["count"] == 2 and inner["count"] == 2
    assert inner["self_s"] == inner["total_s"] >= 0.025
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-8)
    assert 0.01 <= outer["self_s"] < outer["total_s"]
    # a span of another thread is no child of the span open on this one
    parents = {s[2]: s[1] for s in profiler._RECORDER.spans}
    assert parents["elsewhere"] == 0 and parents["outer"] == 0 and parents["inner"] != 0
    assert spans["elsewhere"]["count"] == 1


def test_step_call_counts_one_per_call_of_the_cpu_scanned_step():
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_scanned_train_step

    w, h = 64, 32
    cfg = TrainConfig(target_size=(w, h), batch_size=2, steps_per_call=2)
    K = np.asarray([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, w, h, device="cpu")
    state = create_train_state(Model.create(depth=18, in_channels=1, device="cpu"), cfg)
    scanned = make_scanned_train_step(ctx, cfg)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 2, 3, h, w, 1)).astype(np.float32))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scanned(state, frames)
        profiler.record(True)
        scanned(state, frames)
        scanned(state, frames[:1])
    finally:
        torch.set_num_threads(n)
    snap = profiler.snapshot()
    assert snap["spans"]["step.call"]["count"] == 2 and state.step == 5
    # eager steps on the CPU: no graph, no CUDA events
    assert snap["counters"] == {} and snap["device"] == {}


def test_reset_and_snapshot():
    profiler.record(True)
    with profiler.span("a"):
        pass
    profiler.count("c")
    profiler.count("c", 4)
    first = profiler.snapshot()
    assert first == profiler.snapshot()  # reading leaves the record as it is
    assert first["counters"] == {"c": 5}
    assert set(first["spans"]) == {"a"} and set(first["spans"]["a"]) == {"count", "total_s", "self_s"}
    profiler.reset()
    assert profiler.snapshot() == {"spans": {}, "counters": {}, "device": {}}
    assert profiler.recording()  # reset empties the record and leaves the switch
    profiler.record(False)
    profiler.count("c")
    assert profiler.snapshot()["counters"] == {}


def test_spans_record_while_torch_profiler_records():
    """With the switch off, a torch.profiler session turns the recorder on:
    the spans of the thread that started it show among its events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiler.recording()
        with profiler.span("feed.stack"):
            pass
    assert not profiler.recording()
    with profiler.span("feed.stack"):
        pass
    assert profiler.snapshot()["spans"]["feed.stack"]["count"] == 1
    assert [e.name for e in prof.events()].count("feed.stack") == 1


def _spans_in_trace_json(log_dir, device) -> dict:
    """fit's feed over 8 items inside `trace(log_dir)`: the program spans
    that trace.json holds, by name, held against the profiler's own events
    of the consumer thread's spans: the median gap between the two starts,
    and between the two ends, of a span under 1 ms (a median, since the OS
    may preempt this process between any two clock reads)."""
    with profiler.trace(str(log_dir)):
        assert profiler.recording()
        feed(n_items=8, batch=2, group=2, device=device)
    assert not profiler.recording()
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "program_span":
            by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["loader.get"]) == 5 and len(by_name["loader.batch"]) == 4
    assert {e["tid"] for e in by_name["loader.get"]}.isdisjoint({e["tid"] for e in by_name["loader.batch"]})
    starts, ends = [], []
    for name in ("loader.get", "feed.stack", "feed.pin"):
        theirs = sorted((e["ts"], e["dur"]) for e in events if e.get("cat") == "user_annotation" and e["name"] == name)
        mine = sorted((e["ts"], e["dur"]) for e in by_name.get(name, []))
        assert len(theirs) == len(mine)
        for (ts, dur), (my_ts, my_dur) in zip(theirs, mine):
            starts.append(abs(ts - my_ts))
            ends.append(abs(ts + dur - my_ts - my_dur))
    assert len(starts) >= 7 and statistics.median(starts) < 1000 and statistics.median(ends) < 1000, (starts, ends)
    return by_name


def test_trace_writes_the_spans_of_every_thread_on_the_profilers_clock(tmp_path):
    spans = _spans_in_trace_json(tmp_path, "cpu")
    assert len(spans["feed.stack"]) == 2 and "feed.pin" not in spans
    assert spans["feed.stack"][0]["args"] == {}


def test_fit_img_per_sec_is_images_between_log_points_over_the_time_between(tmp_path, monkeypatch):
    """log_every 2, steps_per_call 1, 6 steps of batch 2 under a clock that
    reads 10, 11, 13, 14 s: the loop's start and three log points, each
    read after the loss (which waits for the card)."""
    ticks = iter([10.0, 11.0, 13.0, 14.0])
    monkeypatch.setattr(loop_module, "time", types.SimpleNamespace(perf_counter=lambda: next(ticks), time=time.time))
    cfg = TrainConfig(target_size=(64, 32), batch_size=2, epochs=1, log_every=2, save_every=0,
                                  log_dir=str(tmp_path / "logs"), save_dir=str(tmp_path / "ckpts"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loop_module.fit(cfg, SyntheticTriplets(n=12, target_size=cfg.target_size), verbose=False, device="cpu",
                        max_steps=6)
    finally:
        torch.set_num_threads(n)
    rows = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["img_per_sec"]) for r in rows] == [(2, 4.0), (4, 2.0), (6, 4.0)]
    assert next(ticks, None) is None


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph, the pinned copies and device idle exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_an_idle_gap_inside_a_program_span_is_named_after_it(dev):
    from benchmark.trace import WINDOW, profiled, reduce

    x = torch.randn(1024, 1024, device=dev)
    torch.cuda.synchronize()
    with profiled() as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(3):
                x = x @ x / 1024
            torch.cuda.synchronize()
            with profiler.span("feed.stack"):
                time.sleep(0.05)
            for _ in range(3):
                x = x @ x / 1024
            torch.cuda.synchronize()
    trace = reduce(prof)
    assert trace.idle_by_host.get("feed.stack", 0) >= 0.04, trace.idle_by_host
    assert profiler.snapshot()["spans"]["feed.stack"]["count"] == 1


@pytest.mark.gpu
def test_the_graph_is_captured_once_and_replayed_every_later_step(dev):
    from monodepth2_torch.models import Model
    from monodepth2_torch.training import TrainConfig, TrainContext, create_train_state, make_scanned_train_step
    from monodepth2_torch.training.state import WARMUP_STEPS

    w, h = 64, 32
    cfg = TrainConfig(target_size=(w, h), batch_size=2, steps_per_call=4)
    K = np.asarray([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1.0]])
    ctx = TrainContext.create(K, w, h, device=dev)
    state = create_train_state(Model.create(depth=18, in_channels=1, device=dev), cfg)
    scanned = make_scanned_train_step(ctx, cfg)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(4, 2, 3, h, w, 1)).astype(np.float32)).to(dev)
    profiler.record(True)
    scanned(state, frames)
    first = profiler.snapshot()
    assert first["counters"] == {"step.captures": 1, "step.replays": 4 - WARMUP_STEPS}
    profiler.reset()
    for _ in range(3):
        scanned(state, frames)
    later = profiler.snapshot()
    assert later["counters"] == {"step.replays": 12}
    assert later["spans"]["step.call"]["count"] == later["device"]["step.call"]["count"] == 3
    assert later["device"]["step.call"]["total_s"] > 0


@pytest.mark.gpu
def test_the_bytes_pinned_are_the_groups_bytes(dev):
    profiler.record(True)
    groups = feed(n_items=10, batch=2, group=2, device=dev)
    assert all(g.is_cuda for g in groups)
    snap = profiler.snapshot()
    assert snap["counters"]["feed.bytes_pinned"] == sum(g.nbytes for g in groups) == 10 * 3 * 16 * 4
    assert snap["spans"]["feed.pin"]["count"] == 3


@pytest.mark.gpu
def test_trace_on_the_card_writes_the_spans_on_the_profilers_clock(dev, tmp_path):
    spans = _spans_in_trace_json(tmp_path, dev)
    assert len(spans["feed.pin"]) == 2
