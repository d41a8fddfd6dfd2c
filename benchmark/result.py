"""What a run hands back, and the line it prints.

A kind's `run` returns an `Outcome`: whether the timed path's output
passed the comparison with the reference (`checks`, each number beside its
limit), the work attempted and failed, the end-to-end readings, the
`Reading` from which the per-layer metrics are read, and the notes printed
on earlier lines (peak memory, clocks and power, the kind's notes).
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from .trace import DeviceTrace

FORBIDDEN = frozenset({"jax", "jaxlib", "optax", "flax", "monodepth2_tpu"})


@dataclass
class Reading:
    """What the per-layer readers read. Host-clock `spans` (seconds summed
    over the measured window) are keyed by name; `trace` is the traced
    segment, which holds `trace_steps` train steps."""

    config: dict
    window_s: float = 0.0
    steps: int = 0
    spans: dict = field(default_factory=dict)
    trace: Optional["DeviceTrace"] = None
    trace_steps: int = 0


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # name -> value
    reading: Reading
    checks: list  # of Check
    memory_peak_bytes: int
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def line(outcome: Outcome, metrics: dict, device: dict, breakdown: Optional[dict]) -> str:
    """The result's JSON line; `checks` is its last key."""
    out = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None, "limit": c.limit}
                     for c in outcome.checks}
    return json.dumps(out)


def check_lines(outcome: Outcome) -> list:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in outcome.checks]
