"""Latency/outcome recording and the end-of-run storm report.

The recorder is a thin, lock-cheap shim over the observability registry:
one phase-labeled histogram for completed-request latency plus the
``loadgen_*`` outcome counters.  The registry's instruments already take
a single short lock per update, so the open-loop runner can record from
thousands of concurrent request tasks without a private accounting
layer; percentile math is the registry's
(:meth:`~distributedmandelbrot_tpu_torch.obs.metrics.Histogram.percentile`),
so the storm report and a scrape of ``/metrics`` agree by construction.

Outcome vocabulary (what the driver returns per request):

- ``ok`` — accepted, payload read in full (counts toward goodput);
- ``shed`` — explicit ``QUERY_OVERLOADED`` (admission control working);
- ``unavailable`` — ``QUERY_NOT_AVAILABLE`` / ``QUERY_REJECT``;
- ``error`` — transport failure, timeout, or protocol violation.

Latency is recorded for every *completed* exchange (ok and shed both —
a shed response's latency is the shed path's cost, and watching it stay
flat under overload is the point of the exercise), but the headline
percentiles in the report are goodput percentiles: ``ok`` only.
"""

from __future__ import annotations

import threading
from typing import Optional

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.metrics import Histogram, Registry

OUTCOME_OK = "ok"
OUTCOME_SHED = "shed"
OUTCOME_UNAVAILABLE = "unavailable"
OUTCOME_ERROR = "error"

_OUTCOME_COUNTERS = {
    OUTCOME_OK: obs_names.LOADGEN_COMPLETED,
    OUTCOME_SHED: obs_names.LOADGEN_SHED,
    OUTCOME_UNAVAILABLE: obs_names.LOADGEN_UNAVAILABLE,
    OUTCOME_ERROR: obs_names.LOADGEN_ERRORS,
}


class StormRecorder:
    """Registry-backed request accounting for one load-generation run."""

    def __init__(self, registry: Optional[Registry] = None) -> None:
        self.registry = registry if registry is not None else Registry()

    # -- write side (hot path) --------------------------------------------

    def issued(self) -> None:
        """An arrival left the schedule (open loop: counted at issue
        time, not completion)."""
        self.registry.inc(obs_names.LOADGEN_REQUESTS)

    def saturated(self) -> None:
        """The *client* hit its in-flight ceiling — the measurement is
        load-generator-bound, not server-bound, and the report flags it."""
        self.registry.inc(obs_names.LOADGEN_CLIENT_SATURATED)

    def record(self, phase: str, outcome: str, latency: float,
               nbytes: int = 0) -> None:
        self.registry.inc(_OUTCOME_COUNTERS.get(outcome,
                                                obs_names.LOADGEN_ERRORS))
        if nbytes:
            self.registry.inc(obs_names.LOADGEN_BYTES, nbytes)
        if outcome in (OUTCOME_OK, OUTCOME_SHED):
            self.registry.observe(
                obs_names.HIST_LOADGEN_LATENCY_SECONDS, latency,
                labels={"phase": phase, "outcome": outcome})

    # -- read side (report) -----------------------------------------------

    def _count(self, name: str) -> int:
        return self.registry.counter_value(name) or 0

    def _ok_percentile(self, q: float,
                       phase: Optional[str] = None) -> Optional[float]:
        """Merged percentile over ``ok`` children (optionally one phase)."""
        children = [
            inst for (name, labels), inst in self.registry._iter_instruments()
            if name == obs_names.HIST_LOADGEN_LATENCY_SECONDS
            and isinstance(inst, Histogram)
            and ("outcome", OUTCOME_OK) in labels
            and (phase is None or ("phase", phase) in labels)]
        if not children:
            return None
        merged = Histogram(obs_names.HIST_LOADGEN_LATENCY_SECONDS, (),
                           threading.Lock(), children[0].bounds)
        for h in children:
            counts, total, count = h.state()
            for i, c in enumerate(counts):
                merged.counts[i] += c
            merged.sum += total
            merged.count += count
        return merged.percentile(q)

    def _phase_count(self, phase: str, outcome: str) -> int:
        """Completed-exchange count for one (phase, outcome) pair, read
        from the latency histogram's labeled children."""
        total = 0
        for (name, labels), inst in self.registry._iter_instruments():
            if name == obs_names.HIST_LOADGEN_LATENCY_SECONDS \
                    and isinstance(inst, Histogram) \
                    and ("outcome", outcome) in labels \
                    and ("phase", phase) in labels:
                total += inst.state()[2]
        return total

    def report(self, *, duration: float, offered: float,
               phases: Optional[list[str]] = None) -> dict:
        """The storm summary: percentiles, goodput vs offered, shedding.

        ``duration`` is the run's wall (or virtual) span in seconds,
        ``offered`` the schedule's mean arrival rate; ``phases`` adds a
        per-phase percentile block in schedule order.
        """
        issued = self._count(obs_names.LOADGEN_REQUESTS)
        completed = self._count(obs_names.LOADGEN_COMPLETED)
        shed = self._count(obs_names.LOADGEN_SHED)
        report = {
            "requests": issued,
            "completed": completed,
            "shed": shed,
            "unavailable": self._count(obs_names.LOADGEN_UNAVAILABLE),
            "errors": self._count(obs_names.LOADGEN_ERRORS),
            "client_saturated": self._count(
                obs_names.LOADGEN_CLIENT_SATURATED),
            "bytes": self._count(obs_names.LOADGEN_BYTES),
            "offered_rate": round(offered, 3),
            "goodput": round(completed / duration, 3) if duration > 0
            else 0.0,
            "shed_fraction": round(shed / issued, 4) if issued else 0.0,
            "p50": self._ok_percentile(50),
            "p99": self._ok_percentile(99),
            "p999": self._ok_percentile(99.9),
        }
        if phases:
            # Per-phase completed/shed counts make admission control
            # legible in one report: the spike phase sheds, the recovery
            # phase goes clean again.
            report["phases"] = {
                phase: {"completed": self._phase_count(phase, OUTCOME_OK),
                        "shed": self._phase_count(phase, OUTCOME_SHED),
                        "p50": self._ok_percentile(50, phase),
                        "p99": self._ok_percentile(99, phase),
                        "p999": self._ok_percentile(99.9, phase)}
                for phase in dict.fromkeys(phases)}
        return report
