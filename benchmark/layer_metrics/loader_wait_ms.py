"""Host milliseconds a train step waited on the loader's queue: the self
time of the program's `loader.get` spans (`DataLoader.__iter__` around
`q.get()`, on the consumer thread) in the traced segment, over its steps.
A wait here means the loader's producer thread was behind."""

from benchmark import recorder


def read(r):
    return recorder.per_step_ms(r, recorder.seconds(recorder.snapshot(r), "loader.get", "self_s"))
