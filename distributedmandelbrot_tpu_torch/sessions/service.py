"""Session service facade: what the gateway actually drives.

Bundles the table, the prefetch planner, and the refinement tracker
behind the handful of calls the gateway's session arm makes per query.
Capability grants fall out of construction: the prefetch bit is offered
iff a planner exists, the refine bit iff a tracker exists and a first
paint depth is configured — so a read-only replica naturally negotiates
refinement away while still granting prefetch.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.serve.cache import DecodedTileCache
from distributedmandelbrot_tpu_torch.sessions.prefetch import PrefetchPlanner
from distributedmandelbrot_tpu_torch.sessions.refine import RefinementTracker
from distributedmandelbrot_tpu_torch.sessions.table import (Key, SessionState,
                                                      SessionTable)
from distributedmandelbrot_tpu_torch.utils.metrics import Counters


class SessionService:
    def __init__(self, table: SessionTable, *,
                 planner: Optional[PrefetchPlanner] = None,
                 refiner: Optional[RefinementTracker] = None,
                 first_paint_max_iter: int = 0,
                 counters: Optional[Counters] = None) -> None:
        self.table = table
        self.planner = planner
        self.refiner = refiner
        self.first_paint_max_iter = first_paint_max_iter
        self.counters = counters if counters is not None else Counters()
        registry = self.counters.registry

        def _hit_ratio() -> float:
            hits = registry.counter_value(obs_names.PREFETCH_HITS) or 0
            misses = registry.counter_value(obs_names.PREFETCH_MISSES) or 0
            total = hits + misses
            return hits / total if total else 0.0

        registry.gauge(obs_names.GAUGE_PREFETCH_HIT_RATIO,
                       help="session queries landing on prefetched tiles",
                       fn=_hit_ratio)

    @property
    def caps(self) -> int:
        """Capability bits this gateway grants (requested ∩ these)."""
        caps = 0
        if self.planner is not None:
            caps |= proto.SESSION_CAP_PREFETCH
        if self.refiner is not None and self.first_paint_max_iter > 0:
            caps |= proto.SESSION_CAP_REFINE
        return caps

    # -- session lifecycle -------------------------------------------------

    def open(self, requested_flags: int) -> SessionState:
        return self.table.open(requested_flags & self.caps)

    def touch(self, session_id: int) -> Optional[SessionState]:
        return self.table.touch(session_id)

    # -- per-query path ----------------------------------------------------

    def note_query(self, state: SessionState, level: int, index_real: int,
                   index_imag: int) -> list[Key]:
        """Record the viewport observation, score the prefetch verdict
        for this tile, and return freshly planned prefetch keys (hand
        them to :meth:`prefetch` off the response path)."""
        prefetching = bool(state.caps & proto.SESSION_CAP_PREFETCH)
        if prefetching:
            if state.consume_prefetch((level, index_real, index_imag)):
                self.counters.inc(obs_names.PREFETCH_HITS)
            else:
                self.counters.inc(obs_names.PREFETCH_MISSES)
        state.observe(level, index_real, index_imag, self.table.now())
        if not prefetching or self.planner is None:
            return []
        return self.planner.plan(state)

    async def prefetch(self, keys: list[Key]) -> None:
        if self.planner is not None and keys:
            await self.planner.execute(keys)

    # -- progressive refinement --------------------------------------------

    def first_paint_iter(self, full_max_iter: Optional[int]) -> Optional[int]:
        """The cheap depth for a first paint, or ``None`` when refinement
        cannot apply (disabled, unknown level, or full depth already at
        or below the first-paint budget)."""
        if self.refiner is None or self.first_paint_max_iter <= 0:
            return None
        if full_max_iter is None \
                or full_max_iter <= self.first_paint_max_iter:
            return None
        return self.first_paint_max_iter

    def schedule_refine(self, w: Workload) -> bool:
        if self.refiner is None:
            return False
        return self.refiner.schedule(w)

    def on_chunk_saved(self, key: Key) -> None:
        if self.refiner is not None:
            self.refiner.on_saved(key)

    def varz(self) -> dict:
        out = self.table.varz()
        out["caps"] = self.caps
        out["prefetch"] = {
            "planned": self.counters.get(obs_names.PREFETCH_PLANNED),
            "warmed": self.counters.get(obs_names.PREFETCH_WARMED),
            "scheduled": self.counters.get(obs_names.PREFETCH_SCHEDULED),
            "hits": self.counters.get(obs_names.PREFETCH_HITS),
            "misses": self.counters.get(obs_names.PREFETCH_MISSES),
        }
        out["refine"] = {
            "first_paint_max_iter": self.first_paint_max_iter,
            "pending": self.refiner.pending if self.refiner else 0,
            "scheduled": self.counters.get(
                obs_names.SESSION_REFINES_SCHEDULED),
            "completed": self.counters.get(
                obs_names.SESSION_REFINES_COMPLETED),
        }
        return out


def build_session_service(
        cache: DecodedTileCache, *, scheduler=None,
        counters: Optional[Counters] = None,
        clock: Callable[[], float] = time.monotonic,
        session_capacity: int = 1024,
        session_ttl: Optional[float] = 300.0,
        session_rate: Optional[float] = None,
        session_burst: float = 32.0,
        prefetch_horizon: int = 3,
        first_paint_max_iter: int = 64) -> SessionService:
    """Wire a full service over one cache and (optionally) a scheduler.

    With no scheduler the service still tracks trajectories and warms
    the cache tiers, but offers neither compute-on-read prefetch nor
    refinement — read-only replicas negotiate those away.
    """
    from distributedmandelbrot_tpu_torch.sessions.predict import TrajectoryPredictor
    table = SessionTable(capacity=session_capacity, ttl=session_ttl,
                         session_rate=session_rate,
                         session_burst=session_burst,
                         clock=clock, counters=counters)
    planner = PrefetchPlanner(
        cache, predictor=TrajectoryPredictor(horizon=prefetch_horizon),
        scheduler=scheduler, counters=counters)
    refiner = RefinementTracker(scheduler, counters=counters) \
        if scheduler is not None else None
    return SessionService(table, planner=planner, refiner=refiner,
                          first_paint_max_iter=first_paint_max_iter,
                          counters=counters)
