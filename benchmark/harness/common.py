"""What a driver hands back: the run's record, and small shared helpers."""

from __future__ import annotations

import random
from types import SimpleNamespace


class Record(SimpleNamespace):
    """A run's readings.  Every driver sets ``correct``, ``attempted``,
    ``failed``, ``device``, ``checks`` (name -> value and limit),
    ``setup_s``, ``window_s``, ``latencies_s`` (one per item completed
    in the window) and ``trace`` (a :class:`~.trace.Trace` or None); the
    rest is the driver's own, for the metric readers."""


def hist_totals(registry, name: str) -> tuple[float, int]:
    """(sum, count) over every child of a histogram family of the
    program's metrics registry (zeros when absent)."""
    total, count = 0.0, 0
    for family, kind, _, children in registry.collect():
        if family != name or kind != "histogram":
            continue
        for child in children:
            _, s, c = child.state()
            total += s
            count += c
    return total, count


def hist_delta(after: dict, before: dict, name: str) -> tuple[float, int]:
    s1, c1 = after.get(name, (0.0, 0))
    s0, c0 = before.get(name, (0.0, 0))
    return s1 - s0, c1 - c0


def seeded(seed: int, salt: str) -> random.Random:
    """A generator for one purpose of one run, from the run's seed."""
    return random.Random(f"{seed}:{salt}")


def percentile(values, q: float) -> float | None:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    the closest ranks; None without values."""
    data = sorted(values)
    if not data:
        return None
    pos = (len(data) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (pos - lo)


def check(value, limit) -> dict:
    """A number compared beside its limit (the run fails above it)."""
    return {"value": value, "limit": limit}
