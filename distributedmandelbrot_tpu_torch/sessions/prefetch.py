"""Prefetch planner: act on predicted tiles before the user asks.

Planning is synchronous and cheap (a residency peek per predicted key);
execution does the real work off the hot path — a store read promoting
the tile into the decoded LRU, falling through to
``scheduler.prioritize`` (compute-on-read at the frontier head) when the
planner has a scheduler and the store has never seen the tile.  A
read-only replica (no scheduler) still gets the cache-warming half,
which is the half that pays under flash-crowd reads.

Every planned key is *marked* against the session first, which is how
hits are scored later: a session query landing on a marked tile is a
prefetch hit, anything else a miss — the ratio gauge is the live
quality signal for the predictor.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.serve.cache import DecodedTileCache
from distributedmandelbrot_tpu_torch.sessions.predict import TrajectoryPredictor
from distributedmandelbrot_tpu_torch.sessions.table import Key, SessionState
from distributedmandelbrot_tpu_torch.utils.metrics import Counters


class PrefetchPlanner:
    def __init__(self, cache: DecodedTileCache, *,
                 predictor: Optional[TrajectoryPredictor] = None,
                 scheduler=None,
                 counters: Optional[Counters] = None) -> None:
        self.cache = cache
        self.predictor = predictor if predictor is not None \
            else TrajectoryPredictor()
        # Duck-typed coordinator.scheduler.TileScheduler (prioritize,
        # level_settings); None on read-only replicas.
        self.scheduler = scheduler
        self._level_max_iter: dict[int, int] = {}
        if scheduler is not None:
            self._level_max_iter = {s.level: s.max_iter
                                    for s in scheduler.level_settings}
        self.counters = counters if counters is not None else Counters()

    def plan(self, state: SessionState) -> list[Key]:
        """Predicted tiles in the run's range, marked against the
        session.  Marks record *prediction* — a later query on a marked
        tile is a hit whether or not warming was needed, so the ratio
        gauge stays a predictor-quality signal on a warm cache.  Keys
        already resident in tier 1 are still marked but not returned
        for execution (nothing to warm)."""
        picked: list[Key] = []
        planned = 0
        for key in self.predictor.predict(state.trajectory()):
            level, index_real, index_imag = key
            if not proto.query_in_range(level, index_real, index_imag):
                continue
            if not state.mark_prefetched(key):
                continue
            planned += 1
            if not self.cache.contains(key):
                picked.append(key)
        if planned:
            self.counters.inc(obs_names.PREFETCH_PLANNED, planned)
        return picked

    async def execute(self, keys: list[Key]) -> None:
        """Warm each planned tile; store misses fall through to
        compute-on-read when a scheduler is attached."""
        for key in keys:
            entry = await asyncio.to_thread(self.cache.load, key)
            if entry is not None:
                self.counters.inc(obs_names.PREFETCH_WARMED)
                continue
            if self.scheduler is None:
                continue
            level, index_real, index_imag = key
            max_iter = self._level_max_iter.get(level)
            if max_iter is None:
                continue
            if self.scheduler.prioritize(
                    Workload(level, max_iter, index_real, index_imag)):
                self.counters.inc(obs_names.PREFETCH_SCHEDULED)
