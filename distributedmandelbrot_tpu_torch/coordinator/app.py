"""The coordinator process: one event loop hosting both services.

Mirrors the reference's process topology — a single process running the
Distributer and DataServer concurrently over shared storage
(``Program.cs:127-150``) — as one asyncio loop instead of two blocking
threads.  Resume happens here: completed tiles are seeded from the on-disk
index before the distributer starts (``Distributer.cs:124,165-175``) —
via the durability checkpoint when one exists (suffix-only index replay
plus lease/frontier restore, coordinator/recovery.py), full index replay
otherwise.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional, Sequence

from distributedmandelbrot_tpu_torch.coordinator.clock import Clock
from distributedmandelbrot_tpu_torch.coordinator.dataserver import DataServer
from distributedmandelbrot_tpu_torch.coordinator.distributer import Distributer
from distributedmandelbrot_tpu_torch.coordinator.recovery import (RecoveryManager,
                                                            load_restore_state)
from distributedmandelbrot_tpu_torch.coordinator.scheduler import TileScheduler
from distributedmandelbrot_tpu_torch.core.workload import LevelSetting
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.exporter import MetricsExporter
from distributedmandelbrot_tpu_torch.obs.metrics import Registry
from distributedmandelbrot_tpu_torch.obs.slo import standard_slos
from distributedmandelbrot_tpu_torch.obs.spans import SpanStore
from distributedmandelbrot_tpu_torch.obs.timeseries import (
    DEFAULT_HISTORY_WINDOW, DEFAULT_SAMPLE_PERIOD, TimeseriesSampler)
from distributedmandelbrot_tpu_torch.obs.trace import TraceLog
from distributedmandelbrot_tpu_torch.serve.cache import DecodedTileCache
from distributedmandelbrot_tpu_torch.serve.gateway import TileGateway
from distributedmandelbrot_tpu_torch.serve.ondemand import OnDemandComputer
from distributedmandelbrot_tpu_torch.sessions import (SessionService,
                                                build_session_service)
from distributedmandelbrot_tpu_torch.storage.ownership import LevelClaims
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

logger = logging.getLogger("dmtpu.coordinator")


class Coordinator:
    def __init__(self, level_settings: Sequence[LevelSetting], *,
                 data_dir_parent: str = "",
                 host: str = "0.0.0.0",
                 distributer_port: int = proto.DEFAULT_DISTRIBUTER_PORT,
                 dataserver_port: int = proto.DEFAULT_DATASERVER_PORT,
                 lease_timeout: float = proto.DEFAULT_LEASE_TIMEOUT,
                 sweep_period: float = proto.DEFAULT_SWEEP_PERIOD,
                 read_timeout: Optional[float] = proto.DEFAULT_READ_TIMEOUT,
                 clock: Optional[Clock] = None,
                 fsync_index: bool = False,
                 stats_period: float = 0.0,
                 gateway_port: Optional[int] = None,
                 gateway_cache_tiles: int = 64,
                 gateway_max_queue_depth: int = 1024,
                 gateway_rate: Optional[float] = None,
                 gateway_burst: float = 256.0,
                 gateway_render_tiles: int = 64,
                 gateway_sessions: bool = True,
                 session_rate: Optional[float] = None,
                 session_burst: float = 32.0,
                 session_ttl: Optional[float] = 300.0,
                 session_capacity: int = 1024,
                 prefetch_horizon: int = 3,
                 first_paint_max_iter: int = 64,
                 ondemand_deadline: float = proto.DEFAULT_ONDEMAND_DEADLINE,
                 ondemand_poll_interval: float = 1.0,
                 exporter_port: Optional[int] = None,
                 sample_period: float = DEFAULT_SAMPLE_PERIOD,
                 history_window: float = DEFAULT_HISTORY_WINDOW,
                 accept_spans: bool = True,
                 accept_session: bool = True,
                 checkpoint_period: float = 0.0,
                 ring_slice=None) \
            -> None:
        # One registry + one trace ring + one span store feed every layer
        # of this process; the exporter (opt-in like the gateway:
        # exporter_port=None disables, 0 binds an ephemeral loopback
        # port) serves all three.
        self.registry = Registry()
        self.trace = TraceLog()
        self.spans = SpanStore()
        # ``ring_slice`` (control/ring.py RingSlice, duck-typed to keep
        # the import DAG acyclic) turns this process into one shard of a
        # sharded control plane: the scheduler's frontier is restricted
        # to the slice, the store's index log / checkpoint blob / level
        # claims are namespaced per shard inside the SHARED data dir,
        # and the distributer answers misrouted uploads with redirects.
        self.ring_slice = ring_slice
        namespace = "" if ring_slice is None else ring_slice.namespace
        # Black-box flight recorder: the coordinator names the process
        # (shard-N when sharded) and points the dump header at the span
        # store's per-worker clock offsets so postmortem (obs/
        # postmortem.py) can order this process's events against its
        # workers' causally.
        role = "coordinator" if ring_slice is None \
            else f"shard-{ring_slice.shard}"
        self.flight = flight.ensure(role, registry=self.registry)
        if self.flight is not None:
            if ring_slice is not None:
                self.flight.shard = ring_slice.shard
            self.flight.offsets_fn = self._flight_offsets
        self.store = ChunkStore(data_dir_parent, fsync_index=fsync_index,
                                registry=self.registry,
                                namespace=namespace)
        # Fail loudly if another live coordinator owns any of our levels
        # on this data dir (reference: the static claimed-levels set,
        # Distributer.cs:14,109-115 — file-based here because our
        # coordinators are separate processes).  Released in stop().
        # Shards claim under their namespace: peers legitimately share
        # every level, each owning a disjoint keyspace slice.
        self._level_claims = LevelClaims(
            self.store.data_dir, [s.level for s in level_settings],
            namespace=namespace)
        try:
            # Checkpoint-aware resume: the completed set comes from the
            # last checkpoint plus a replay of only the index entries past
            # its recorded offset; with no (usable) checkpoint this is the
            # classic full index replay.
            restore = load_restore_state(self.store, level_settings,
                                         registry=self.registry,
                                         namespace=namespace)
            if restore.completed:
                logger.info("resume: %d tiles already completed on disk",
                            len(restore.completed))
            self.counters = Counters(registry=self.registry)
            kwargs = {} if clock is None else {"clock": clock}
            self.scheduler = TileScheduler(
                level_settings, completed=restore.completed,
                lease_timeout=lease_timeout, registry=self.registry,
                trace=self.trace,
                owns=None if ring_slice is None else ring_slice.owns,
                **kwargs)
            # Adopt the checkpointed frontier cursor, retry queue, and
            # leases (with remaining TTLs) so in-flight workers from
            # before a restart can land their results against live leases.
            restore.apply(self.scheduler, registry=self.registry)
            # Live scheduler gauges, read at scrape time (plain ints under
            # the GIL — no locking needed for a monitoring read).
            self.registry.gauge(obs_names.GAUGE_FRONTIER_DEPTH,
                                help="tiles grantable right now",
                                fn=lambda: self.scheduler.frontier_depth)
            self.registry.gauge(obs_names.GAUGE_OUTSTANDING_LEASES,
                                help="unexpired leases",
                                fn=lambda: self.scheduler.outstanding_leases)
            self.registry.gauge(obs_names.GAUGE_COMPLETED_TILES,
                                help="completed tiles of the configured grid",
                                fn=lambda: self.scheduler.completed_count)
            self.distributer = Distributer(self.scheduler, self.store,
                                           host=host, port=distributer_port,
                                           sweep_period=sweep_period,
                                           read_timeout=read_timeout,
                                           counters=self.counters,
                                           trace=self.trace,
                                           spans=self.spans,
                                           accept_spans=accept_spans,
                                           accept_session=accept_session,
                                           ring_slice=ring_slice)
            self.dataserver = DataServer(self.store, host=host,
                                         port=dataserver_port,
                                         read_timeout=read_timeout,
                                         counters=self.counters,
                                         ring_slice=ring_slice)
            # The serving gateway is opt-in (gateway_port=None disables);
            # when enabled it shares the store, scheduler, and counters,
            # and hooks the distributer's save path for compute-on-read
            # arrival notification.
            self.gateway: Optional[TileGateway] = None
            self.sessions: Optional[SessionService] = None
            if gateway_port is not None:
                cache = DecodedTileCache(self.store,
                                         capacity=gateway_cache_tiles,
                                         counters=self.counters)
                ondemand = OnDemandComputer(
                    self.scheduler, cache, deadline=ondemand_deadline,
                    poll_interval=ondemand_poll_interval,
                    counters=self.counters)
                if gateway_sessions:
                    self.sessions = build_session_service(
                        cache, scheduler=self.scheduler,
                        counters=self.counters,
                        clock=self.scheduler.clock.now,
                        session_capacity=session_capacity,
                        session_ttl=session_ttl,
                        session_rate=session_rate,
                        session_burst=session_burst,
                        prefetch_horizon=prefetch_horizon,
                        first_paint_max_iter=first_paint_max_iter)
                self.gateway = TileGateway(
                    cache, ondemand=ondemand, host=host, port=gateway_port,
                    read_timeout=read_timeout,
                    max_queue_depth=gateway_max_queue_depth,
                    rate=gateway_rate, burst=gateway_burst,
                    render_cache_tiles=gateway_render_tiles,
                    counters=self.counters, trace=self.trace,
                    ring_slice=ring_slice, sessions=self.sessions)
                gateway = self.gateway

                def _on_chunk_saved(key: tuple[int, int, int]) -> None:
                    # A save may be a deeper-max_iter variant of a tile
                    # the cache tiers hold (progressive refinement, or
                    # simply a re-render at new settings): drop the
                    # stale entries and settle any pending refinement
                    # BEFORE waking on-demand waiters, so a woken read
                    # can only see the fresh bytes.
                    gateway.invalidate_saved(key)
                    ondemand.notify_saved(key)

                self.distributer.on_chunk_saved = _on_chunk_saved
            # Durability checkpoints: periodic when checkpoint_period > 0,
            # on-demand always (POST /checkpoint, final write on stop).
            self.recovery = RecoveryManager(
                self.store, self.scheduler,
                generation=restore.generation,
                period=checkpoint_period, registry=self.registry,
                pending_keys_fn=self.distributer.pending_save_keys,
                namespace=namespace)
            # Fleet observability: the ring-buffer sampler rides the
            # exporter (no exporter, nobody can read the history), and
            # gateway-bearing processes track the standard SLO pair on
            # it; the obs loop (start()) advances both.
            self.exporter: Optional[MetricsExporter] = None
            self.sampler: Optional[TimeseriesSampler] = None
            self.slos: list = []
            self._slo_status: list[dict] = []
            self._worker_stats_cache: tuple[float, Optional[dict]] = \
                (0.0, None)
            if exporter_port is not None:
                self.sampler = TimeseriesSampler(
                    self.registry, period=sample_period,
                    window=history_window)
                if gateway_port is not None:
                    self.slos = standard_slos(self.sampler)
                self.exporter = MetricsExporter(
                    self.registry, trace=self.trace,
                    spans=self.spans,
                    varz_extra=self._varz_extra,
                    checkpoint_cb=self.recovery.checkpoint,
                    sampler=self.sampler,
                    flight=self.flight,
                    host=host, port=exporter_port)
        except BaseException:
            # Construction failed after the claim: release it, or the
            # level stays locked by this live process forever.
            self._level_claims.release()
            raise
        self.stats_period = stats_period
        self._stats_task: Optional[asyncio.Task] = None
        self._obs_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        try:
            await self.distributer.start()
            await self.dataserver.start()
            if self.gateway is not None:
                await self.gateway.start()
            if self.exporter is not None:
                await self.exporter.start()
        except BaseException:
            # A failed startup (e.g. port already bound) will never reach
            # stop(): shut down whichever service DID start — a
            # half-started distributer would keep granting tiles for a
            # level someone else can now claim — then release the claim
            # (a leaked claim from a live pid would lock the level for
            # the life of this process).  release() sits in a finally:
            # the stops await, and a cancellation landing there must not
            # skip the release (CancelledError is not an Exception).
            try:
                await self.distributer.stop()
                await self.dataserver.stop()
                if self.gateway is not None:
                    await self.gateway.stop()
                if self.exporter is not None:
                    await self.exporter.stop()
            except Exception:
                logger.exception("cleanup after failed startup")
            finally:
                self._level_claims.release()
            raise
        await self.recovery.start()
        if self.stats_period > 0:
            self._stats_task = asyncio.create_task(self._stats_loop())
        if self.sampler is not None:
            self._obs_task = asyncio.create_task(self._obs_loop())

    async def stop(self) -> None:
        if self._obs_task is not None:
            self._obs_task.cancel()
            try:
                await self._obs_task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("obs sampling task had failed")
        if self._stats_task is not None:
            self._stats_task.cancel()
            try:
                await self._stats_task
            except asyncio.CancelledError:
                pass
            except Exception:
                # A previously-failed stats task must never prevent the
                # services below from shutting down.
                logger.exception("stats task had failed")
        try:
            # Exporter first (scrapes read live scheduler/cache state),
            # then gateway: its in-flight requests read through the store
            # and await distributer saves, so it should stop serving before
            # the services it depends on go away.
            if self.exporter is not None:
                await self.exporter.stop()
            if self.gateway is not None:
                await self.gateway.stop()
            await self.distributer.stop()
            await self.dataserver.stop()
            # Last: distributer.stop() gathered the in-flight save tasks,
            # so the parting checkpoint records every durable tile and the
            # next start replays a zero-length index suffix.
            await self.recovery.stop()
        finally:
            # Claims must release even when a service stop raises.
            self._level_claims.release()

    async def _stats_loop(self) -> None:
        """Periodic progress/throughput report (survey §5.1/§5.5 — the
        reference has no observability at all; operators watch this)."""
        last: dict[str, int] = {}
        while True:
            await asyncio.sleep(self.stats_period)
            try:
                snap = self.counters.snapshot()
                delta = {k: v - last.get(k, 0) for k, v in snap.items()
                         if v != last.get(k, 0)}
                last = snap
                logger.info(
                    "stats: %d/%d tiles complete, %d leased; totals %s; "
                    "last %.0fs %s",
                    self.scheduler.completed_count,
                    self.scheduler.total_tiles,
                    self.scheduler.outstanding_leases, snap,
                    self.stats_period, delta or "(idle)")
            except Exception:
                # Reporting must never kill itself (or shutdown, see stop).
                logger.exception("stats reporting failed")

    async def _obs_loop(self) -> None:
        """Drive the timeseries sampler and the SLO state machines at
        the sample period.  SLO evaluation happens HERE, not per /varz
        request: the state machine must advance on one clock, not at
        whatever rate scrapers poll."""
        assert self.sampler is not None
        while True:
            await asyncio.sleep(self.sampler.period)
            try:
                self.sampler.sample()
                if self.slos:
                    self._slo_status = [slo.evaluate()
                                        for slo in self.slos]
            except Exception:
                # Observability must never kill the services it watches.
                logger.exception("obs sampling failed")

    async def run_forever(self) -> None:
        await self.start()
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()

    @property
    def distributer_port(self) -> int:
        return self.distributer.port

    @property
    def dataserver_port(self) -> int:
        return self.dataserver.port

    @property
    def gateway_port(self) -> Optional[int]:
        return None if self.gateway is None else self.gateway.port

    @property
    def exporter_port(self) -> Optional[int]:
        return None if self.exporter is None else self.exporter.port

    def _flight_offsets(self) -> dict:
        """Per-worker NTP offsets for the flight-dump header, keyed by
        the hex worker id workers stamp into their own dumps."""
        out = {}
        for wid in self.spans.workers():
            est = self.spans.offset(wid)
            if est is not None:
                out[format(wid, "016x")] = {"offset": est.offset,
                                            "error": est.error}
        return out

    def _varz_extra(self) -> dict:
        """Scheduler frontier state for /varz (beyond the gauge family)."""
        extra = {
            "role": ("shard" if self.ring_slice is not None
                     else "coordinator"),
            "scheduler": {
                "frontier_depth": self.scheduler.frontier_depth,
                "outstanding_leases": self.scheduler.outstanding_leases,
                "completed": self.scheduler.completed_count,
                "total": self.scheduler.total_tiles,
            },
            "recovery": {
                "generation": self.recovery.generation,
                "checkpoint_period": self.recovery.period,
            },
        }
        workers = self._worker_stats_cached()
        if workers:
            extra["workers"] = workers
        if self._slo_status:
            extra["slo"] = self._slo_status
        if self.sessions is not None:
            extra["sessions"] = self.sessions.varz()
        if self.ring_slice is not None:
            extra["shard"] = {
                "shard": self.ring_slice.shard,
                "n_shards": self.ring_slice.n_shards,
                "ring_version": self.ring_slice.version,
                "owned_tiles": self.scheduler.owned_tiles,
            }
        return extra

    def _worker_stats_cached(self) -> dict:
        """Span-reported per-worker roll-up, persist seconds joined from
        the trace ring — what the fleet aggregator merges into its
        worker table (workers need no exporter to be visible).

        Cached for one sample period: the roll-up walks the full trace
        ring and span store (milliseconds on a loaded coordinator, on
        the event loop), and /varz is served per-scraper — a fleet of
        aggregators polling must not multiply that walk.  Worker rates
        are window deltas aggregator-side, so sample-period staleness
        is invisible there."""
        now = time.monotonic()
        ttl = self.sampler.period if self.sampler is not None else 2.0
        cached_at, cached = self._worker_stats_cache
        if cached is not None and now - cached_at < ttl:
            return cached
        persist_by_key = {tuple(s["key"]): s.get("persist_s", 0.0)
                          for s in self.trace.spans()
                          if s.get("complete")}
        workers = self.spans.per_worker_stats(persist_by_key)
        self._worker_stats_cache = (now, workers)
        return workers
