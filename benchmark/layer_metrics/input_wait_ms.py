"""Host milliseconds a train step waited for its batch: the host clock
around each `next()` on the feed (`device_prefetch` over the loader),
summed over the measured window, over the window's steps."""


def read(r):
    if not r.steps or "input_wait" not in r.spans:
        return None
    return r.spans["input_wait"] / r.steps * 1e3
