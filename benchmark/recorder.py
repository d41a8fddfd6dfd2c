"""What the program's own recorder (`monodepth2_torch.utils.profiler`:
spans, counters and CUDA event pairs) holds for the per-layer readers.

The recorder records while a torch.profiler session records, so in a
benchmark run it holds the traced segment alone: the window runs with no
profiler and the recorder off. A `Reading` that carries the recorder's
`snapshot()` as `program` is read first; otherwise the running program's
recorder. A program without a recorder, or one that recorded nothing,
gives None, and every reader of it then returns None."""

from __future__ import annotations

from typing import Optional


def snapshot(reading) -> Optional[dict]:
    program = getattr(reading, "program", None)
    if not program:
        try:
            from monodepth2_torch.utils import profiler
        except ImportError:
            return None
        read = getattr(profiler, "snapshot", None)
        program = read() if read is not None else None
    if not program or not (program.get("spans") or program.get("counters")):
        return None
    return program


def seconds(snap: Optional[dict], name: str, key: str = "total_s") -> Optional[float]:
    """Seconds in span `name` of a snapshot (its `total_s` or `self_s`), or
    None where the program recorded no such span."""
    s = snap["spans"].get(name) if snap else None
    return s[key] if s else None


def per_step_ms(reading, total_s: Optional[float]) -> Optional[float]:
    """`total_s` over the traced segment's steps, in milliseconds."""
    if total_s is None or not reading.trace_steps:
        return None
    return total_s / reading.trace_steps * 1e3
