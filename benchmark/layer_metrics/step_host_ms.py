"""Host milliseconds a train step spent inside the scanned step's call:
the program's `step.call` spans (`make_scanned_train_step`'s call: copies
into the graph's inputs and the replays' launches) in the traced segment,
over its steps."""

from benchmark import recorder


def read(r):
    return recorder.per_step_ms(r, recorder.seconds(recorder.snapshot(r), "step.call"))
