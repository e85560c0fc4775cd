"""GatewayFleet: N read replicas over one shared object store.

The horizontal-read experiment in miniature.  Each replica is a full
serve stack — :class:`~distributedmandelbrot_tpu_torch.storage.store.
ChunkStore` over an :class:`~distributedmandelbrot_tpu_torch.storage.backends.
ObjectStoreBackend`, decoded-tile cache, :class:`~distributedmandelbrot_
tpu.serve.gateway.TileGateway` — running its own asyncio loop on its own
thread, bound to an ephemeral loopback port.  All replicas hand their
backend the *same* object-store fake (``MemoryObjectStore`` or
``DirObjectStore``), so any replica serves any tile and adding a replica
adds serving capacity without data movement: the bench's >= 1.6x
1 -> 2 replica goodput criterion is measured against exactly this class.

No on-demand compute: a fleet is a *read* tier.  Misses answer
``QUERY_NOT_AVAILABLE``, which keeps the scaling measurement about the
read path instead of farm scheduling.

``sessions=True`` attaches a :class:`~distributedmandelbrot_tpu_torch.
sessions.SessionService` per replica (no scheduler, so capability
negotiation grants prefetch-by-cache-warming and refuses refinement):
the jax-free way to storm the session wire, measure prefetch hit
ratios, and exercise per-session fair admission.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional

from distributedmandelbrot_tpu_torch.serve.cache import DecodedTileCache
from distributedmandelbrot_tpu_torch.serve.gateway import TileGateway
from distributedmandelbrot_tpu_torch.sessions import build_session_service
from distributedmandelbrot_tpu_torch.storage.backends import (ObjectStore,
                                                        ObjectStoreBackend)
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils.metrics import Counters


class _Replica:
    """One threaded gateway over the shared key-value store."""

    def __init__(self, kv: ObjectStore, *, cache_tiles: int,
                 render_cache_tiles: int, max_queue_depth: int,
                 rate: Optional[float], burst: float,
                 read_timeout: Optional[float],
                 sessions: bool = False,
                 session_rate: Optional[float] = None,
                 session_burst: float = 32.0,
                 session_ttl: Optional[float] = 300.0,
                 prefetch_horizon: int = 3,
                 exporter: bool = False) -> None:
        self.counters = Counters()
        self.port: Optional[int] = None
        self.exporter_port: Optional[int] = None
        self._exporter = exporter
        self._kv = kv
        self._gateway_kwargs = dict(
            max_queue_depth=max_queue_depth, rate=rate, burst=burst,
            render_cache_tiles=render_cache_tiles,
            read_timeout=read_timeout)
        self._cache_tiles = cache_tiles
        self._sessions = sessions
        self._session_kwargs = dict(
            session_rate=session_rate, session_burst=session_burst,
            session_ttl=session_ttl, prefetch_horizon=prefetch_horizon)
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()
        self._ready.wait(timeout=30.0)
        if self._error is not None:
            raise RuntimeError("replica failed to start") from self._error
        if self.port is None:
            raise RuntimeError("replica did not come up within 30s")

    def stop(self) -> None:
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        self._thread.join(timeout=30.0)

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:  # surfaced by start()
            self._error = e
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        store = ChunkStore(backend=ObjectStoreBackend(self._kv),
                           registry=self.counters.registry)
        cache = DecodedTileCache(store, capacity=self._cache_tiles,
                                 counters=self.counters)
        service = None
        if self._sessions:
            # No scheduler on a read replica: the service negotiates
            # refinement away and prefetches by cache warming only.
            service = build_session_service(cache, scheduler=None,
                                            counters=self.counters,
                                            **self._session_kwargs)
        gateway = TileGateway(cache, host="127.0.0.1", port=0,
                              counters=self.counters, sessions=service,
                              **self._gateway_kwargs)
        exporter = None
        sampler_task = None
        if self._exporter:
            # A scrapable replica: /varz + /timeseries with role
            # "gateway" so the fleet aggregator (obs/fleet.py) gives it
            # a gateway row with windowed latency percentiles.
            from distributedmandelbrot_tpu_torch.obs.exporter import \
                MetricsExporter
            from distributedmandelbrot_tpu_torch.obs.timeseries import \
                TimeseriesSampler
            sampler = TimeseriesSampler(self.counters.registry)
            exporter = MetricsExporter(
                self.counters.registry, sampler=sampler,
                varz_extra=lambda: {"role": "gateway"},
                host="127.0.0.1", port=0)
            await exporter.start()
            self.exporter_port = exporter.port
            sampler_task = asyncio.ensure_future(sampler.run())
        await gateway.start()
        self.port = gateway.port
        self._ready.set()
        try:
            await self._stop_event.wait()
        finally:
            if sampler_task is not None:
                sampler_task.cancel()
            if exporter is not None:
                await exporter.stop()
            await gateway.stop()


class GatewayFleet:
    """N gateway replicas sharing one object store; context-manageable."""

    def __init__(self, kv: ObjectStore, *, replicas: int = 2,
                 cache_tiles: int = 64, render_cache_tiles: int = 64,
                 max_queue_depth: int = 1024,
                 rate: Optional[float] = None, burst: float = 256.0,
                 read_timeout: Optional[float] = 30.0,
                 sessions: bool = False,
                 session_rate: Optional[float] = None,
                 session_burst: float = 32.0,
                 session_ttl: Optional[float] = 300.0,
                 prefetch_horizon: int = 3,
                 exporter: bool = False) -> None:
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.kv = kv
        self._replicas = [
            _Replica(kv, cache_tiles=cache_tiles,
                     render_cache_tiles=render_cache_tiles,
                     max_queue_depth=max_queue_depth, rate=rate,
                     burst=burst, read_timeout=read_timeout,
                     sessions=sessions, session_rate=session_rate,
                     session_burst=session_burst, session_ttl=session_ttl,
                     prefetch_horizon=prefetch_horizon, exporter=exporter)
            for _ in range(replicas)]

    def start(self) -> "GatewayFleet":
        started = []
        try:
            for replica in self._replicas:
                replica.start()
                started.append(replica)
        except BaseException:
            for replica in started:
                replica.stop()
            raise
        return self

    def stop(self) -> None:
        for replica in self._replicas:
            replica.stop()

    def __enter__(self) -> "GatewayFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def addresses(self) -> list[tuple[str, int]]:
        return [("127.0.0.1", r.port) for r in self._replicas
                if r.port is not None]

    @property
    def exporter_ports(self) -> list[int]:
        """Bound metrics-exporter ports (``exporter=True`` launches
        only) — feed these to a FleetAggregator as gateway peers."""
        return [r.exporter_port for r in self._replicas
                if r.exporter_port is not None]

    def counter(self, name: str) -> int:
        """Sum of one named counter across every replica."""
        return sum(r.counters.get(name) for r in self._replicas)
