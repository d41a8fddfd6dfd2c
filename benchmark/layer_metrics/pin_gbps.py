"""The rate at which the feed pins host memory: the program's counter
`feed.bytes_pinned` over the time in its `feed.pin` spans
(`device_prefetch` around `pin_memory()`) in the traced segment, in GB/s.
Far under a memcpy's rate means pinned blocks are allocated anew."""

from benchmark import recorder


def read(r):
    snap = recorder.snapshot(r)
    seconds = recorder.seconds(snap, "feed.pin")
    pinned = snap["counters"].get("feed.bytes_pinned") if snap else None
    if not seconds or not pinned:
        return None
    return pinned / seconds / 1e9
