"""SLO burn rates over sampler history + worker straggler detection.

The serving story needs two standing questions answered continuously:

- **"Is the SLO burning?"** — answered Google-SRE style with
  multi-window burn rates.  An SLO is an objective over a ratio of good
  events (``objective=0.99`` means 1% error budget); the *burn rate* is
  how fast the budget is being spent (``error_rate / (1 - objective)``,
  so burn 1.0 exactly exhausts the budget over the SLO period and burn
  10 exhausts it 10x faster).  An alert fires only when BOTH a fast
  window (default 5 m: catches cliffs quickly) and a slow window
  (default 1 h: ignores blips) exceed the threshold, which is the
  standard trick for alerts that are simultaneously fast and unflappy.
  All windows are read from the :class:`~distributedmandelbrot_tpu_torch.obs
  .timeseries.TimeseriesSampler`'s stored history, so the math is pure
  and virtual-clock testable: feed a ManualClock sampler synthetic
  good/bad streams and the burn values are exact.

- **"Which worker is the straggler?"** — answered from the per-worker
  span statistics the coordinator already ingests (obs/spans.py): a
  worker whose compute seconds-per-tile or lease-to-upload wall time is
  a robust-statistics outlier against the farm median gets flagged
  (ROADMAP item 4's signal; the MPI reference shows rank-level load
  imbalance is exactly this workload's dominant scaling loss).

State machine per SLO: ``ok`` -> (fast AND slow over threshold)
``firing`` -> (fast recovered, slow still burning) ``hold`` -> (slow
recovered) ``ok``; re-entering ``firing`` from ``hold`` does not
re-count a fire unless the alert fully recovered first.
"""

from __future__ import annotations

import bisect
from typing import Callable, NamedTuple, Optional, Sequence

from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.timeseries import (TimeseriesSampler,
                                                      family_of)

# Ring events attached to a firing alert's status doc: enough trailing
# flight-recorder context to see what the process was doing when the
# burn crossed the threshold, without shipping the whole ring.
EVIDENCE_TAIL = 40

DEFAULT_FAST_WINDOW = 300.0
DEFAULT_SLOW_WINDOW = 3600.0
DEFAULT_BURN_THRESHOLD = 10.0

# Gateway request outcomes that count against availability.  Everything
# else (cache hits, computes, renders, first paints, redirects — the
# client got a correct answer or a correct pointer) is good.
BAD_OUTCOMES = frozenset({
    obs_names.OUTCOME_UNAVAILABLE,
    obs_names.OUTCOME_REJECTED,
    obs_names.OUTCOME_OVERLOADED,
    obs_names.OUTCOME_SESSION_THROTTLED,
})

STATE_OK = "ok"
STATE_FIRING = "firing"
STATE_HOLD = "hold"


class WindowBurn(NamedTuple):
    window_s: float
    good: int
    bad: int
    error_rate: float
    burn: float


def burn_rate(good: int, bad: int, objective: float) -> float:
    """How fast the error budget burns: 1.0 = exactly on budget."""
    total = good + bad
    if total <= 0:
        return 0.0
    budget = 1.0 - objective
    if budget <= 0:
        return float("inf") if bad else 0.0
    return (bad / total) / budget


def _outcome_of(label: str) -> Optional[str]:
    """``hist{outcome=computed}`` -> ``computed`` (None if unlabeled)."""
    if "{" not in label:
        return None
    body = label.split("{", 1)[1].rstrip("}")
    for part in body.split(","):
        k, _, v = part.partition("=")
        if k == "outcome":
            return v
    return None


class _BaseSLO:
    """Shared window plumbing + the fast/slow alert state machine."""

    def __init__(self, name: str, sampler: TimeseriesSampler, *,
                 objective: float = 0.99,
                 fast_window: float = DEFAULT_FAST_WINDOW,
                 slow_window: float = DEFAULT_SLOW_WINDOW,
                 burn_threshold: float = DEFAULT_BURN_THRESHOLD) -> None:
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective {objective} outside (0, 1)")
        self.name = name
        self.sampler = sampler
        self.objective = float(objective)
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.burn_threshold = float(burn_threshold)
        self.state = STATE_OK
        self.fired = 0
        self.recovered = 0

    # subclasses: (good, bad) event deltas inside the trailing window
    def _window_counts(self, window: float,
                       now: Optional[float]) -> tuple[int, int]:
        raise NotImplementedError

    def window_burn(self, window: float, *,
                    now: Optional[float] = None) -> WindowBurn:
        good, bad = self._window_counts(window, now)
        total = good + bad
        err = (bad / total) if total > 0 else 0.0
        return WindowBurn(window, good, bad, err,
                          burn_rate(good, bad, self.objective))

    def evaluate(self, *, now: Optional[float] = None) -> dict:
        """Advance the alert state machine one step and report it."""
        fast = self.window_burn(self.fast_window, now=now)
        slow = self.window_burn(self.slow_window, now=now)
        over_fast = fast.burn >= self.burn_threshold
        over_slow = slow.burn >= self.burn_threshold
        reg = self.sampler.registry
        evidence: Optional[list[dict]] = None
        if self.state == STATE_OK:
            if over_fast and over_slow:
                self.state = STATE_FIRING
                self.fired += 1
                reg.inc(obs_names.SLO_ALERTS_FIRED,
                        labels={"slo": self.name})
                evidence = self._on_fire(fast, slow)
        elif self.state == STATE_FIRING:
            if not over_slow:
                self.state = STATE_OK
                self.recovered += 1
                reg.inc(obs_names.SLO_ALERTS_RECOVERED,
                        labels={"slo": self.name})
                self._on_recover()
            elif not over_fast:
                self.state = STATE_HOLD
        else:  # hold: slow window still burning, fast recovered
            if not over_slow:
                self.state = STATE_OK
                self.recovered += 1
                reg.inc(obs_names.SLO_ALERTS_RECOVERED,
                        labels={"slo": self.name})
                self._on_recover()
            elif over_fast:
                self.state = STATE_FIRING
        for win, wb in (("fast", fast), ("slow", slow)):
            reg.set_gauge(obs_names.GAUGE_SLO_BURN, wb.burn,
                          labels={"slo": self.name, "window": win})
        out = {
            "name": self.name, "objective": self.objective,
            "state": self.state, "fired": self.fired,
            "recovered": self.recovered,
            "burn_threshold": self.burn_threshold,
            "fast": {"window_s": fast.window_s, "good": fast.good,
                     "bad": fast.bad,
                     "error_rate": round(fast.error_rate, 6),
                     "burn": round(fast.burn, 4)},
            "slow": {"window_s": slow.window_s, "good": slow.good,
                     "bad": slow.bad,
                     "error_rate": round(slow.error_rate, 6),
                     "burn": round(slow.burn, 4)},
        }
        if evidence is not None:
            out["evidence"] = evidence
        return out

    def _on_fire(self, fast: WindowBurn,
                 slow: WindowBurn) -> Optional[list[dict]]:
        """Fire transition: note the event, dump the black box (an SLO
        fire is a crash-grade moment for postmortems) and return the
        ring tail as alert evidence."""
        flight.note(obs_events.SLO_FIRE, slo=self.name,
                    fast_burn=round(fast.burn, 4),
                    slow_burn=round(slow.burn, 4))
        rec = flight.get()
        if rec is None:
            return None
        if rec.dump_dir is not None:
            try:
                rec.dump(reason=f"slo:{self.name}")
            except Exception:
                pass
        return rec.tail(EVIDENCE_TAIL)

    def _on_recover(self) -> None:
        flight.note(obs_events.SLO_RECOVER, slo=self.name)


class AvailabilitySLO(_BaseSLO):
    """Fraction of gateway requests that resolved to an answer, from
    the per-outcome children of the request histogram family."""

    def __init__(self, sampler: TimeseriesSampler, *,
                 name: str = "gateway_availability",
                 family: str = obs_names.HIST_GATEWAY_REQUEST_SECONDS,
                 bad_outcomes: frozenset[str] = BAD_OUTCOMES,
                 **kwargs) -> None:
        super().__init__(name, sampler, **kwargs)
        self.family = family
        self.bad_outcomes = bad_outcomes

    def _per_outcome(self, s) -> dict[str, int]:
        out: dict[str, int] = {}
        for label, (_counts, _sum, count) in s.hists.items():
            if family_of(label) != self.family:
                continue
            outcome = _outcome_of(label) or ""
            out[outcome] = out.get(outcome, 0) + count
        return out

    def _window_counts(self, window: float,
                       now: Optional[float]) -> tuple[int, int]:
        samples = self.sampler.samples(window=window, now=now)
        if len(samples) < 2:
            return 0, 0
        first = self._per_outcome(samples[0])
        last = self._per_outcome(samples[-1])
        good = bad = 0
        for outcome, n in last.items():
            delta = max(0, n - first.get(outcome, 0))
            if outcome in self.bad_outcomes:
                bad += delta
            else:
                good += delta
        return good, bad


class LatencySLO(_BaseSLO):
    """Fraction of requests at or under ``threshold_s``, from the
    histogram family's merged bucket-count deltas (threshold resolution
    is the bucket grid — pick a threshold on a bucket bound)."""

    def __init__(self, sampler: TimeseriesSampler, *,
                 threshold_s: float = 0.1024,
                 name: Optional[str] = None,
                 family: str = obs_names.HIST_GATEWAY_REQUEST_SECONDS,
                 **kwargs) -> None:
        super().__init__(name or f"gateway_latency_{threshold_s:g}s",
                         sampler, **kwargs)
        self.family = family
        self.threshold_s = float(threshold_s)

    def _window_counts(self, window: float,
                       now: Optional[float]) -> tuple[int, int]:
        pts = self.sampler.hist_points(self.family, window=window, now=now)
        bounds = self.sampler.bounds_for(self.family)
        if len(pts) < 2 or bounds is None:
            return 0, 0
        _, c_first, _, _ = pts[0]
        _, c_last, _, _ = pts[-1]
        delta = [max(0, b - a) for a, b in zip(c_first, c_last)]
        # Buckets are <= bound; nudge the threshold so a threshold set
        # exactly on a bound includes its bucket despite float noise.
        idx = bisect.bisect_right(bounds, self.threshold_s * (1 + 1e-9))
        good = sum(delta[:idx])
        bad = sum(delta[idx:])
        return good, bad


def standard_slos(sampler: TimeseriesSampler, *,
                  availability_objective: float = 0.99,
                  latency_objective: float = 0.95,
                  latency_threshold_s: float = 0.1024,
                  fast_window: float = DEFAULT_FAST_WINDOW,
                  slow_window: float = DEFAULT_SLOW_WINDOW,
                  burn_threshold: float = DEFAULT_BURN_THRESHOLD
                  ) -> list[_BaseSLO]:
    """The pair every gateway-bearing process runs: availability and
    p-latency over the request histogram.  0.1024 s sits exactly on a
    DEFAULT_BUCKETS bound (1e-4 * 2^10)."""
    common = dict(fast_window=fast_window, slow_window=slow_window,
                  burn_threshold=burn_threshold)
    return [
        AvailabilitySLO(sampler, objective=availability_objective,
                        **common),
        LatencySLO(sampler, objective=latency_objective,
                   threshold_s=latency_threshold_s, **common),
    ]


# -- straggler detection ----------------------------------------------------

def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def detect_stragglers(rows: Sequence[dict], *, factor: float = 2.0,
                      min_peers: int = 3, min_tiles: int = 2,
                      abs_floor_s: float = 0.05) -> dict[str, list[str]]:
    """Flag workers whose per-tile timings are outliers vs the farm.

    ``rows`` are per-worker dicts (``SpanStore.per_worker_stats`` /
    fleet-merged): ``{"worker": id, "tiles": n, "compute_s": total,
    "lease_to_persist_s": total}``.  A worker is a straggler on a
    signal when its per-tile value exceeds ``factor`` x the farm median
    AND the excess clears ``abs_floor_s`` (a 2x outlier among
    microsecond medians is noise, not a straggler).  Needs at least
    ``min_peers`` qualifying workers — a median of two is meaningless.

    Returns ``{worker_id: [reasons...]}`` for flagged workers only.
    """
    signals = (("compute_s", "slow_compute"),
               ("lease_to_persist_s", "lease_to_persist_skew"))
    flagged: dict[str, list[str]] = {}
    for field, reason in signals:
        per_tile: list[tuple[str, float]] = []
        for row in rows:
            tiles = row.get("tiles", 0)
            total = row.get(field)
            if tiles >= min_tiles and isinstance(total, (int, float)):
                per_tile.append((str(row.get("worker")),
                                 float(total) / tiles))
        if len(per_tile) < min_peers:
            continue
        med = _median([v for _, v in per_tile])
        for worker, v in per_tile:
            if v > factor * med and v - med > abs_floor_s:
                flagged.setdefault(worker, []).append(reason)
    return flagged
