"""Host milliseconds a train step spent stacking batches into groups of
`steps_per_call`: the program's `feed.stack` spans (`_group_batches`
around its `np.stack`) in the traced segment, over its steps."""

from benchmark import recorder


def read(r):
    return recorder.per_step_ms(r, recorder.seconds(recorder.snapshot(r), "feed.stack"))
