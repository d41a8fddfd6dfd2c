"""Milliseconds the loader's producer thread took to make one batch (load
its items through the worker pool and `np.stack` them): the time in the
program's `loader.batch` spans over its counter `loader.batches`, in the
traced segment. The profiler does not record that thread; the program's
recorder does."""

from benchmark import recorder


def read(r):
    snap = recorder.snapshot(r)
    seconds = recorder.seconds(snap, "loader.batch")
    batches = snap["counters"].get("loader.batches") if snap else None
    if seconds is None or not batches:
        return None
    return seconds / batches * 1e3
