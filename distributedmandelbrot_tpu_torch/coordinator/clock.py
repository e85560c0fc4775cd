"""Injectable clocks.

The reference times leases against a ``Stopwatch`` (``Distributer.cs:51-52``);
making the clock injectable turns every scheduler behavior — lease expiry,
redistribution, stale-result rejection — into pure logic testable over
virtual time.
"""

from __future__ import annotations

import time
from typing import Protocol


class Clock(Protocol):
    def now(self) -> float:
        """Monotonic seconds."""
        ...


class MonotonicClock:
    def now(self) -> float:
        return time.monotonic()


class ManualClock:
    """Test clock advanced explicitly."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("time only moves forward")
        self._now += seconds
