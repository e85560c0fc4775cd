"""In-process ring-buffer timeseries: Registry snapshots over time.

``/metrics`` and ``/varz`` are instantaneous — they cannot answer "is
goodput degrading?" without an external scrape database.  The sampler
closes that gap with the cheapest thing that works: a fixed-capacity
deque of Registry snapshots taken every ``period`` seconds, from which
rates (counter monotonic deltas), gauge traces, and histogram
percentile series are derived AT READ TIME.  Nothing is precomputed, so
a sample is just "copy the instrument values" — microseconds for the
~60 instruments a coordinator carries — and memory is strictly bounded
by ``capacity * instruments``.

The clock is injectable (``coordinator/clock.py`` ManualClock in tests:
call :meth:`TimeseriesSampler.sample` by hand, advance, sample again)
and the live mode is a plain asyncio task on the owning process's loop
(:meth:`run`), started by the coordinator beside its wire services.

Served as ``GET /timeseries?name=<series>&window=<seconds>`` on the
existing exporter (obs/exporter.py); the SLO layer (obs/slo.py) reads
the same history through :meth:`hist_points` / :meth:`counter_points`.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import Callable, NamedTuple, Optional, Sequence

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.metrics import (Registry,
                                                   quantile_from_counts)

DEFAULT_SAMPLE_PERIOD = 2.0
DEFAULT_HISTORY_WINDOW = 600.0

# Percentile series served by default (q in percent).
DEFAULT_QUANTILES = (50.0, 99.0)


class Sample(NamedTuple):
    """One consistent cut of the registry at sampler-clock time ``ts``.

    Keys are the ``/varz`` labeled spellings (``name`` or
    ``name{k=v,...}``); histogram values are ``(bucket_counts, sum,
    count)`` so percentiles and threshold counts can be re-derived for
    any window without having stored them."""

    ts: float
    counters: dict[str, int]
    gauges: dict[str, float]
    hists: dict[str, tuple[tuple[int, ...], float, int]]


def family_of(label: str) -> str:
    """``name{outcome=tier1_hit}`` -> ``name``."""
    return label.split("{", 1)[0]


def _labeled(name: str, label_key) -> str:
    if not label_key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in label_key) + "}"


class TimeseriesSampler:
    """Bounded history of Registry snapshots with derived series.

    Thread-safe: :meth:`sample` may run on any thread (the asyncio task
    in live mode, the test body under a ManualClock) while exporter
    requests read concurrently.  Capacity is fixed at construction from
    ``window / period`` — the deque, not a policy loop, enforces the
    memory bound.
    """

    def __init__(self, registry: Registry, *,
                 period: float = DEFAULT_SAMPLE_PERIOD,
                 window: float = DEFAULT_HISTORY_WINDOW,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if period <= 0:
            raise ValueError(f"sample period {period} must be > 0")
        if window < period:
            raise ValueError(f"history window {window} < period {period}")
        self.registry = registry
        self.period = float(period)
        self.window = float(window)
        self.clock = clock
        self.capacity = max(2, int(window / period) + 2)
        self._lock = threading.Lock()
        self._samples: deque[Sample] = deque(maxlen=self.capacity)
        self._bounds: dict[str, tuple[float, ...]] = {}

    # -- write side --------------------------------------------------------

    def sample(self) -> Sample:
        """Take one snapshot now; returns it (tests assert on the cut)."""
        t0 = time.monotonic()
        now = self.clock()
        counters: dict[str, int] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, tuple[tuple[int, ...], float, int]] = {}
        bounds: dict[str, tuple[float, ...]] = {}
        for name, kind, _help, children in self.registry.collect():
            for inst in children:
                label = _labeled(name, inst.labels)
                if kind == "counter":
                    counters[label] = inst.value
                elif kind == "gauge":
                    gauges[label] = inst.read()
                else:
                    h_counts, h_sum, h_count = inst.state()
                    hists[label] = (tuple(h_counts), h_sum, h_count)
                    bounds[name] = inst.bounds
        s = Sample(now, counters, gauges, hists)
        with self._lock:
            self._samples.append(s)
            self._bounds.update(bounds)
        self.registry.inc(obs_names.TS_SAMPLES)
        self.registry.set_gauge(obs_names.GAUGE_TS_SERIES,
                                len(counters) + len(gauges) + len(hists))
        self.registry.observe(obs_names.HIST_TS_SAMPLE_SECONDS,
                              time.monotonic() - t0)
        return s

    async def run(self) -> None:
        """Live mode: sample every ``period`` seconds until cancelled.
        A plain task on the owner's loop — ``sample()`` is microseconds
        of dict copying, far below the loop's scheduling noise."""
        while True:
            await asyncio.sleep(self.period)
            self.sample()

    # -- raw history -------------------------------------------------------

    def samples(self, *, window: Optional[float] = None,
                now: Optional[float] = None) -> list[Sample]:
        with self._lock:
            items = list(self._samples)
        if window is None:
            return items
        if now is None:
            now = self.clock()
        cutoff = now - window
        return [s for s in items if s.ts >= cutoff]

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def bounds_for(self, family: str) -> Optional[tuple[float, ...]]:
        with self._lock:
            return self._bounds.get(family)

    def names(self) -> list[str]:
        """Every series name with at least one stored point: both the
        labeled spellings and the bare family names they sum into."""
        with self._lock:
            items = list(self._samples)
        out: set[str] = set()
        for s in items:
            for label in s.counters:
                out.add(label)
                out.add(family_of(label))
            for label in s.gauges:
                out.add(label)
            for label in s.hists:
                out.add(label)
                out.add(family_of(label))
        return sorted(out)

    # -- derived series ----------------------------------------------------

    def counter_points(self, name: str, *, window: Optional[float] = None,
                       now: Optional[float] = None
                       ) -> list[tuple[float, int]]:
        """(ts, value) per sample; an exact labeled name matches itself,
        a bare family name sums every labeled child."""
        pts: list[tuple[float, int]] = []
        for s in self.samples(window=window, now=now):
            if name in s.counters:
                pts.append((s.ts, s.counters[name]))
                continue
            vals = [v for k, v in s.counters.items()
                    if family_of(k) == name]
            if vals:
                pts.append((s.ts, sum(vals)))
        return pts

    def gauge_points(self, name: str, *, window: Optional[float] = None,
                     now: Optional[float] = None
                     ) -> list[tuple[float, float]]:
        pts = []
        for s in self.samples(window=window, now=now):
            if name in s.gauges:
                pts.append((s.ts, s.gauges[name]))
        return pts

    def hist_points(self, name: str, *, window: Optional[float] = None,
                    now: Optional[float] = None
                    ) -> list[tuple[float, list[int], float, int]]:
        """(ts, merged bucket counts, sum, count) per sample, children of
        the family merged (shared bounds by Registry construction)."""
        out: list[tuple[float, list[int], float, int]] = []
        for s in self.samples(window=window, now=now):
            merged: Optional[list[int]] = None
            total = 0.0
            count = 0
            for k, (h_counts, h_sum, h_count) in s.hists.items():
                if k == name or family_of(k) == name:
                    if merged is None:
                        merged = list(h_counts)
                    else:
                        merged = [a + b for a, b in zip(merged, h_counts)]
                    total += h_sum
                    count += h_count
            if merged is not None:
                out.append((s.ts, merged, total, count))
        return out

    @staticmethod
    def rates_from_points(pts: Sequence[tuple[float, float]]
                          ) -> list[tuple[float, float]]:
        """Consecutive monotonic deltas -> per-second rates.  A negative
        delta (process restart reset the counter) clamps to 0 instead of
        plotting a giant negative spike."""
        out: list[tuple[float, float]] = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            dt = t1 - t0
            if dt <= 0:
                continue
            out.append((t1, max(0.0, (v1 - v0) / dt)))
        return out

    def rate(self, name: str, *, window: float = 60.0,
             now: Optional[float] = None) -> float:
        """Average per-second rate of a counter over the trailing window
        (first-to-last stored point inside it); 0.0 with <2 points."""
        pts = self.counter_points(name, window=window, now=now)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))

    def percentile_series(self, name: str, q: float, *,
                          window: Optional[float] = None,
                          now: Optional[float] = None
                          ) -> list[tuple[float, float]]:
        """Per-sample q-th percentile (0..100) of the family's *interval*
        observations (bucket-count deltas between consecutive samples);
        an idle interval carries the cumulative percentile forward so a
        quiet gateway plots its steady latency, not zeros."""
        bounds = self.bounds_for(name)
        pts = self.hist_points(name, window=window, now=now)
        if bounds is None or len(pts) < 1:
            return []
        out: list[tuple[float, float]] = []
        for (_, c0, _, n0), (t1, c1, _, n1) in zip(pts, pts[1:]):
            delta = [max(0, b - a) for a, b in zip(c0, c1)]
            if n1 > n0:
                out.append((t1, quantile_from_counts(bounds, delta,
                                                     q / 100.0)))
            else:
                out.append((t1, quantile_from_counts(bounds, c1,
                                                     q / 100.0)))
        return out

    def window_percentile(self, name: str, q: float, *,
                          window: Optional[float] = None,
                          now: Optional[float] = None) -> float:
        """One q-th percentile over every observation inside the window
        (delta of the first vs last stored cut; cumulative when the
        window covers the whole history)."""
        bounds = self.bounds_for(name)
        pts = self.hist_points(name, window=window, now=now)
        if bounds is None or not pts:
            return 0.0
        _, c_last, _, n_last = pts[-1]
        _, c_first, _, n_first = pts[0]
        if len(pts) >= 2 and n_last > n_first:
            delta = [max(0, b - a) for a, b in zip(c_first, c_last)]
            return quantile_from_counts(bounds, delta, q / 100.0)
        return quantile_from_counts(bounds, c_last, q / 100.0)

    # -- /timeseries payloads ----------------------------------------------

    def series_json(self, name: str, *, window: Optional[float] = None,
                    now: Optional[float] = None) -> Optional[dict]:
        """The ``/timeseries?name=`` document for one series, or None if
        the name has no stored points of any kind."""
        if now is None:
            now = self.clock()
        counter_pts = self.counter_points(name, window=window, now=now)
        if counter_pts:
            rates = self.rates_from_points(counter_pts)
            return {
                "name": name, "kind": "counter",
                "points": [[round(t, 3), v] for t, v in counter_pts],
                "rates": [[round(t, 3), round(r, 4)] for t, r in rates],
                "window_rate": round(
                    self.rate(name, window=window or self.window, now=now),
                    4),
            }
        gauge_pts = self.gauge_points(name, window=window, now=now)
        if gauge_pts:
            return {
                "name": name, "kind": "gauge",
                "points": [[round(t, 3), round(v, 6)]
                           for t, v in gauge_pts],
            }
        hist_pts = self.hist_points(name, window=window, now=now)
        if hist_pts:
            doc: dict = {
                "name": name, "kind": "histogram",
                "counts": [[round(t, 3), n] for t, _, _, n in hist_pts],
                "rates": [[round(t, 3), round(r, 4)] for t, r in
                          self.rates_from_points(
                              [(t, n) for t, _, _, n in hist_pts])],
                "percentiles": {},
            }
            for q in DEFAULT_QUANTILES:
                doc["percentiles"][f"p{int(q)}"] = [
                    [round(t, 3), round(v, 6)] for t, v in
                    self.percentile_series(name, q, window=window, now=now)]
                doc[f"window_p{int(q)}"] = round(
                    self.window_percentile(name, q, window=window, now=now),
                    6)
            return doc
        return None

    def to_json(self, name: Optional[str] = None, *,
                window: Optional[float] = None,
                now: Optional[float] = None) -> dict:
        """The full ``/timeseries`` response: one series when ``name``
        is given (``{"error": ...}`` for an unknown one), the catalogue
        otherwise."""
        if name:
            doc = self.series_json(name, window=window, now=now)
            if doc is None:
                return {"error": f"unknown series {name!r}",
                        "series": self.names()}
            return doc
        with self._lock:
            stored = len(self._samples)
        return {"series": self.names(), "samples": stored,
                "period_s": self.period, "window_s": self.window,
                "capacity": self.capacity}
