"""The readers of the program's own spans, counters and CUDA events
(`benchmark/recorder.py` and seven files of `layer_metrics/`): each gives
its value on a made-up `Reading` and None without its input; a traced run
on the CPU reads the host ones from the running program; and the window
runs with the program's recorder off."""

import json

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.result import Reading
from benchmark.trace import DeviceTrace
from monodepth2_torch.utils import profiler

NEW = ("loader_wait_ms", "group_stack_ms", "pin_gbps", "loader_batch_ms", "step_host_ms", "step_call_device_ms",
       "feed_idle_pct")


@pytest.fixture(autouse=True)
def recorder():
    """The recorder off and empty, and one intra-op thread, for each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.record(False)
    profiler.reset()
    yield
    profiler.record(False)
    profiler.reset()
    torch.set_num_threads(n)


def made_up(program=None, trace=True):
    """A traced segment of 50 steps, 2 s long, with 0.3 s idle under the
    feed's spans and 0.1 s under other names."""
    r = Reading({}, window_s=20.0, steps=1000, spans={"input_wait": 1.0}, trace_steps=50)
    if trace:
        r.trace = DeviceTrace(2.0, 1.6, idle_by_host={"loader.get": 0.2, "feed.stack": 0.05, "feed.pin": 0.05,
                                                      "aten::copy_": 0.05, "bench.input_wait": 0.05})
    if program is not None:
        r.program = program
    return r


PROGRAM = {
    "spans": {"loader.get": {"count": 500, "total_s": 0.6, "self_s": 0.5},
              "loader.batch": {"count": 60, "total_s": 1.2, "self_s": 1.2},
              "feed.stack": {"count": 5, "total_s": 0.1, "self_s": 0.1},
              "feed.pin": {"count": 5, "total_s": 0.25, "self_s": 0.25},
              "step.call": {"count": 5, "total_s": 0.01, "self_s": 0.01}},
    "counters": {"loader.batches": 48, "feed.bytes_pinned": 2_500_000_000, "step.replays": 50},
    "device": {"step.call": {"count": 5, "total_s": 4.8}},
}
EXPECTED = {"loader_wait_ms": 10.0, "group_stack_ms": 2.0, "pin_gbps": 10.0, "loader_batch_ms": 25.0,
            "step_host_ms": 0.2, "step_call_device_ms": 96.0, "feed_idle_pct": 15.0}


@pytest.mark.parametrize("name", NEW)
def test_reader_gives_its_value_and_none_without_its_input(name):
    read = spec.layer_metric(name).read
    assert read(made_up(PROGRAM)) == pytest.approx(EXPECTED[name])
    # a program without the recorder, or one that recorded nothing
    assert read(made_up()) is None
    assert read(made_up({"spans": {}, "counters": {}, "device": {}})) is None
    # the part of the input this reader needs, taken away
    part = {"loader_wait_ms": ("spans", "loader.get"), "group_stack_ms": ("spans", "feed.stack"),
            "pin_gbps": ("counters", "feed.bytes_pinned"), "loader_batch_ms": ("counters", "loader.batches"),
            "step_host_ms": ("spans", "step.call"), "step_call_device_ms": ("device", "step.call"),
            "feed_idle_pct": ("spans", "loader.get")}[name]
    less = json.loads(json.dumps(PROGRAM))
    del less[part[0]][part[1]]
    assert read(made_up(less)) is None
    no_steps = made_up(PROGRAM)
    no_steps.trace_steps = 0
    if name not in ("pin_gbps", "loader_batch_ms", "feed_idle_pct"):
        assert read(no_steps) is None
    if name == "feed_idle_pct":
        assert read(made_up(PROGRAM, trace=False)) is None


def test_readers_read_the_running_programs_recorder():
    profiler.record(True)
    with profiler.span("loader.get"):
        pass
    with profiler.span("step.call"):
        pass
    profiler.count("loader.batches", 3)
    r = made_up()
    assert spec.layer_metric("loader_wait_ms").read(r) > 0
    assert spec.layer_metric("step_host_ms").read(r) > 0
    assert spec.layer_metric("loader_batch_ms").read(r) is None  # no loader.batch span
    assert spec.layer_metric("step_call_device_ms").read(r) is None  # no CUDA event on the CPU


def test_the_window_runs_with_the_recorder_off_and_the_traced_calls_with_it_on():
    from benchmark.kinds.train import Session
    from benchmark.tests.test_bench_run import train_cell

    cell = train_cell()
    session = Session(cell.config, cell.traffic, 2**31 + 3, torch.device("cpu"))
    session.setup()
    session.first_call()
    session.warm()
    seen = []
    step = session.step

    def watched(state, batch):
        seen.append(profiler.recording())
        return step(state, batch)

    session.step = watched
    try:
        reading = session.window(0.5)
        assert reading.steps > 0 and seen and not any(seen)
        assert profiler.snapshot() == {"spans": {}, "counters": {}, "device": {}}
        seen.clear()
        _, steps = session.traced(1)
        assert seen == [True]
        snap = profiler.snapshot()
        assert snap["spans"]["step.call"]["count"] == 1
        assert snap["spans"]["loader.get"]["count"] >= steps
        assert not profiler.recording()
    finally:
        session.release()


def test_a_traced_cpu_run_prints_the_host_readings():
    from benchmark.tests.test_bench_run import drive, train_cell

    cell = train_cell()
    # an epoch longer than what the feed holds ahead, so that the producer
    # makes batches inside the traced segment
    cell.traffic = {**cell.traffic, "sequence_frames": 200}
    cell.per_layer = [{"name": n, "unit": "x"} for n in NEW]
    out = drive(cell, trace=True)
    # no pinned copies and no CUDA events on the CPU
    assert set(out["metrics"]) == set(NEW) - {"pin_gbps", "step_call_device_ms"}
    assert all(np.isfinite(m["value"]) and m["value"] >= 0 for m in out["metrics"].values())
