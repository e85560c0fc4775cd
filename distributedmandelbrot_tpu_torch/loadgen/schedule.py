"""Arrival schedules: phase specs, Poisson processes, Zipf tile choice.

A run is a list of :class:`Phase` segments played back to back.  Each
phase is a Poisson arrival process — ``steady`` and ``spike`` are
homogeneous (constant rate, sampled by exponential inter-arrival
inversion), ``ramp`` is inhomogeneous (linear rate sweep, sampled by
Lewis-Shedler thinning against the peak rate).  ``spike`` is just a
``steady`` with a scary name: keeping it a distinct kind makes the phase
labels on the latency histogram say what the operator meant.

Tile popularity is Zipfian: rank ``k`` of the level's ``level**2`` keys
is drawn with probability proportional to ``k**-s``, and a seeded
permutation maps ranks onto grid keys so the hot set is scattered across
the level instead of clustered at the origin (which would alias with any
spatial locality in the store layout).

Everything is driven by explicit seeds; the same spec + seed produces
the same schedule byte for byte, which the deterministic tests pin.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

import numpy as np

PHASE_KINDS = ("steady", "spike", "ramp")


@dataclass(frozen=True)
class Phase:
    """One schedule segment: ``kind`` at ``rate`` (to ``rate_end`` for
    ramps) arrivals/second for ``duration`` seconds."""

    kind: str
    rate: float
    duration: float
    rate_end: Optional[float] = None
    name: str = ""

    def __post_init__(self) -> None:
        if self.kind not in PHASE_KINDS:
            raise ValueError(f"unknown phase kind {self.kind!r}")
        if self.rate < 0 or self.duration <= 0:
            raise ValueError(f"bad phase {self.kind}:{self.rate}x"
                             f"{self.duration}")
        if self.kind == "ramp" and self.rate_end is None:
            raise ValueError("ramp phase needs an end rate (lo-hi)")

    def rate_at(self, t: float) -> float:
        """Instantaneous rate ``t`` seconds into the phase."""
        if self.kind != "ramp":
            return self.rate
        frac = min(max(t / self.duration, 0.0), 1.0)
        return self.rate + (self.rate_end - self.rate) * frac

    @property
    def peak_rate(self) -> float:
        return max(self.rate, self.rate_end or self.rate)

    @property
    def mean_rate(self) -> float:
        if self.kind == "ramp":
            return (self.rate + self.rate_end) / 2.0
        return self.rate


def parse_phases(spec: str) -> list[Phase]:
    """Parse ``"steady:200x5,spike:2000x2,ramp:200-2000x5"`` into phases.

    Grammar per segment: ``kind:rate[-rate_end]xduration`` — rate in
    arrivals/second, duration in seconds, ``rate_end`` only meaningful
    (and required) for ``ramp``.  Phase names are ``{kind}{index}`` so a
    spec with two spikes labels them apart on the histogram.
    """
    phases: list[Phase] = []
    for index, segment in enumerate(s for s in spec.split(",") if s.strip()):
        try:
            kind, rest = segment.strip().split(":", 1)
            rates, duration = rest.split("x", 1)
            lo, _, hi = rates.partition("-")
            phases.append(Phase(
                kind=kind.strip(), rate=float(lo),
                rate_end=float(hi) if hi else None,
                duration=float(duration), name=f"{kind.strip()}{index}"))
        except (ValueError, TypeError) as e:
            raise ValueError(
                f"bad phase segment {segment!r} (want kind:rate[-hi]xdur, "
                f"e.g. steady:200x5 or ramp:200-2000x5): {e}") from e
    if not phases:
        raise ValueError(f"phase spec {spec!r} parsed to no phases")
    return phases


def poisson_arrivals(phases: list[Phase], *,
                     seed: int = 0) -> list[tuple[float, str]]:
    """Sample one arrival process: sorted ``(time, phase_name)`` pairs.

    Times are absolute seconds from the start of the run; each phase
    occupies ``[sum(prev durations), +duration)``.  Constant-rate phases
    use inter-arrival inversion; ramps thin a peak-rate process down to
    the instantaneous rate, which keeps one stream of randomness per
    phase and is exact for any bounded rate function.
    """
    rng = random.Random(seed)
    arrivals: list[tuple[float, str]] = []
    start = 0.0
    for phase in phases:
        end = start + phase.duration
        peak = phase.peak_rate
        t = start
        while peak > 0:
            t += rng.expovariate(peak)
            if t >= end:
                break
            if phase.kind == "ramp" \
                    and rng.random() * peak > phase.rate_at(t - start):
                continue  # thinned: candidate beyond the current rate
            arrivals.append((t, phase.name or phase.kind))
        start = end
    return arrivals


class ZipfTiles:
    """Zipf(s) sampler over a level's ``level**2`` tile keys.

    ``sample()`` returns ``(level, index_real, index_imag)``; rank ``k``
    (1-based) has probability proportional to ``k**-s``, mapped through a
    seeded permutation of the keyspace.  ``s`` around 1 matches web-like
    popularity (a handful of tiles soak most of the traffic — exactly
    the regime the rendered-tile cache exists for).
    """

    def __init__(self, level: int, *, s: float = 1.1, seed: int = 0) -> None:
        if level < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        self.level = level
        self.s = s
        n = level * level
        weights = np.arange(1, n + 1, dtype=float) ** -float(s)
        self._cdf = np.cumsum(weights)
        self._cdf /= self._cdf[-1]
        self._rng = np.random.default_rng(seed)
        self._keys = self._rng.permutation(n)  # rank -> flat key index

    def sample(self) -> tuple[int, int, int]:
        rank = int(np.searchsorted(self._cdf, self._rng.random(),
                                   side="right"))
        flat = int(self._keys[min(rank, self._keys.size - 1)])
        return (self.level, flat // self.level, flat % self.level)

    def hottest(self, count: int) -> list[tuple[int, int, int]]:
        """The ``count`` most popular keys (rank order) — what a bench
        pre-seeds so the hot set serves from the store, not the farm."""
        out = []
        for flat in self._keys[:count]:
            flat = int(flat)
            out.append((self.level, flat // self.level, flat % self.level))
        return out


@dataclass(frozen=True)
class Request:
    """One scheduled query: issue at ``time`` (seconds from run start)."""

    time: float
    phase: str
    level: int
    index_real: int
    index_imag: int


def build_schedule(phases: list[Phase], sampler: ZipfTiles, *,
                   seed: int = 0) -> list[Request]:
    """Zip a Poisson arrival process with Zipf tile choices."""
    return [Request(t, name, *sampler.sample())
            for t, name in poisson_arrivals(phases, seed=seed)]


def offered_rate(schedule: list[Request]) -> float:
    """Mean offered load of a schedule (arrivals / spanned seconds)."""
    if not schedule:
        return 0.0
    span = schedule[-1].time - schedule[0].time
    if span <= 0:
        return float(len(schedule))
    return len(schedule) / span
