"""Asyncio tile-serving gateway: cache + coalesce + compute-on-read.

The read-side front door for heavy traffic.  Speaks two framings on one
port:

- **Legacy query** — the reference DataServer's 12-byte ``<III`` ``(level,
  index_real, index_imag)`` query, answered with a status byte and, on
  accept, a u32-length-prefixed codec payload.  Existing viewers work
  against the gateway unmodified.
- **Batched query** — a query whose first u32 is
  :data:`~distributedmandelbrot_tpu_torch.net.protocol.GATEWAY_BATCH_MAGIC`
  (an impossible level) is instead ``magic, count, count x 12-byte
  queries``; the reply is ``count`` single-query responses in request
  order.  Items resolve concurrently, so a batch of neighbours rides the
  coalescer and the store's readahead instead of serializing round trips.
- **Rendered query** — first u32 is
  :data:`~distributedmandelbrot_tpu_torch.net.protocol.GATEWAY_RENDER_MAGIC`,
  followed by the 14-byte ``RENDER_QUERY_TAIL``; the accept payload is a
  colormapped palette PNG (:mod:`.render`) instead of the escape-count
  codec body.  A viewer that only displays tiles downloads ~50-200 KB
  instead of 16 MiB, which is what makes million-viewer read fan-out a
  bandwidth problem the gateway can actually win.
- **Session query** — first u32 is
  :data:`~distributedmandelbrot_tpu_torch.net.protocol.GATEWAY_SESSION_MAGIC`,
  followed by the 22-byte ``SESSION_QUERY_TAIL`` (session id + viewport
  + colormap + capability flags); the reply leads with the 9-byte
  ``SESSION_REPLY`` (issued/echoed id, granted caps) before the standard
  status byte + rendered body.  Live only when a
  :class:`~distributedmandelbrot_tpu_torch.sessions.SessionService` is
  attached (duck-typed — the serve layer must not import the sessions
  package, which imports this module): the service tracks each session's
  viewport trajectory for predictive prefetch, serves first paints from
  a cheap low-``max_iter`` variant while the full depth refines in the
  background, and charges a per-session token budget *before* the global
  one so a flash crowd's hot session sheds onto itself, not everyone.

On top of the :class:`DataServer` semantics the gateway adds:

- a tier-1 decoded-tile LRU (:mod:`.cache`) over the store's payload LRU,
- single-flight coalescing (:mod:`.coalesce`) so a stampede on one tile
  costs one store read / one farm compute,
- compute-on-read (:mod:`.ondemand`): a miss for a tile the run is
  configured to render is injected at the scheduler's frontier head and
  the response waits (bounded by a deadline) for the worker upload,
- admission control: a token bucket on request rate plus a cap on
  concurrently serving queries; rejected work gets an explicit
  ``QUERY_OVERLOADED`` byte instead of an unbounded queue.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.trace import TraceLog
from distributedmandelbrot_tpu_torch.serve import render
from distributedmandelbrot_tpu_torch.serve.cache import (DecodedTileCache,
                                                   RenderedTileCache)
from distributedmandelbrot_tpu_torch.serve.coalesce import SingleFlight
from distributedmandelbrot_tpu_torch.serve.ondemand import OnDemandComputer
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

logger = logging.getLogger("dmtpu.gateway")

MAX_BATCH_QUERIES = 4096  # mirrors the distributer's MAX_BATCH bound


class TokenBucket:
    """Classic token bucket; ``rate=None`` (or <= 0) admits everything."""

    def __init__(self, rate: Optional[float], burst: float, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.rate = rate
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.rate is None or self.rate <= 0:
            return True
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False


class TileGateway:
    """The serving front door.  One instance per coordinator event loop.

    ``max_queue_depth`` caps queries in service at once (load shedding);
    ``rate``/``burst`` feed the token bucket.  Both default to permissive
    values — the embedded coordinator's tests dial them down.
    """

    def __init__(self, cache: DecodedTileCache, *,
                 ondemand: Optional[OnDemandComputer] = None,
                 host: str = "0.0.0.0",
                 port: int = proto.DEFAULT_GATEWAY_PORT,
                 read_timeout: Optional[float] = proto.DEFAULT_READ_TIMEOUT,
                 max_queue_depth: int = 1024,
                 rate: Optional[float] = None,
                 burst: float = 256.0,
                 render_cache_tiles: int = 64,
                 counters: Optional[Counters] = None,
                 trace: Optional[TraceLog] = None,
                 ring_slice=None,
                 sessions=None) -> None:
        self.cache = cache
        self.ondemand = ondemand
        # Duck-typed sessions.SessionService (open/touch/note_query/
        # prefetch/first_paint_iter/schedule_refine) — import cycle, see
        # the module docstring.  None answers the session framing with a
        # named reject counter and a dropped connection.
        self.sessions = sessions
        # Duck-typed control.ring.RingSlice (owns/owner_of/version) — the
        # serve layer must not import the control package (cycle).  When
        # set, queries for keys outside this shard's slice are answered
        # with QUERY_REDIRECT + the authoritative shard instead of a read
        # that could only miss.
        self.ring_slice = ring_slice
        self.host = host
        self.port = port
        self.read_timeout = read_timeout
        self.max_queue_depth = max_queue_depth
        self.counters = counters if counters is not None else Counters()
        self.registry = self.counters.registry
        self.trace = trace if trace is not None else TraceLog()
        self.bucket = TokenBucket(rate, burst)
        self.singleflight = SingleFlight(self.counters)
        self.render_cache = RenderedTileCache(capacity=render_cache_tiles,
                                              counters=self.counters)
        # Compute-on-read needs the depth the run renders each level at;
        # the scheduler's work definition is the source of truth.
        self._level_max_iter: dict[int, int] = {}
        if ondemand is not None:
            self._level_max_iter = {
                s.level: s.max_iter
                for s in ondemand.scheduler.level_settings}
        self._active = 0
        self._server: Optional[asyncio.Server] = None
        self._conn_tasks: set[asyncio.Task] = set()
        # Detached prefetch-warming tasks (fire-and-forget off the
        # response path); held so stop() can cancel them.
        self._bg_tasks: set[asyncio.Task] = set()

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("gateway listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # Connections may be parked in an on-demand wait (minutes); cancel
        # them rather than letting wait_closed() (3.12+: waits for all
        # handlers) stall shutdown for the deadline.
        for task in list(self._conn_tasks | self._bg_tasks):
            task.cancel()
        if self._conn_tasks or self._bg_tasks:
            await asyncio.gather(*self._conn_tasks, *self._bg_tasks,
                                 return_exceptions=True)
        flights = self.singleflight.cancel_inflight()
        if flights:
            await asyncio.gather(*flights, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    # -- connection handling ----------------------------------------------

    async def _read(self, coro):
        if self.read_timeout is None:
            return await coro
        return await asyncio.wait_for(coro, self.read_timeout)

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    first = await self._read(framing.read_u32(reader))
                except (ConnectionError, TimeoutError, asyncio.TimeoutError):
                    break  # clean EOF / idle close between queries
                if first == proto.GATEWAY_BATCH_MAGIC:
                    await self._serve_batch(reader, writer)
                elif first == proto.GATEWAY_RENDER_MAGIC:
                    await self._serve_render(reader, writer)
                elif first == proto.GATEWAY_SESSION_MAGIC:
                    await self._serve_session(reader, writer)
                else:
                    rest = await self._read(framing.read_exact(
                        reader, proto.QUERY_TAIL.size))
                    index_real, index_imag = proto.QUERY_TAIL.unpack(rest)
                    status, payload = await self._resolve_admitted(
                        first, index_real, index_imag)
                    self._write_response(writer, status, payload)
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        except framing.ProtocolError as e:
            # Malformed or hostile frame: drop the connection, leave a
            # trail, keep the accept loop alive.
            self.counters.inc(obs_names.GATEWAY_FRAMES_REJECTED)
            logger.error("dropping %s: %s", peer, e)
        except Exception:
            logger.exception("error serving %s", peer)
        finally:
            if task is not None:
                self._conn_tasks.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_batch(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        count = proto.validate_count(
            await self._read(framing.read_u32(reader)), MAX_BATCH_QUERIES,
            "batch count")
        if count == 0:
            raise framing.ProtocolError("empty batch")
        raw = await self._read(framing.read_exact(
            reader, count * proto.QUERY.size))
        queries = [proto.QUERY.unpack_from(raw, n * proto.QUERY.size)
                   for n in range(count)]
        self.counters.inc("gateway_batches")
        # Resolve concurrently — neighbours coalesce and overlap their
        # store reads — but reply strictly in request order.
        results = await asyncio.gather(
            *(self._resolve_admitted(*q) for q in queries))
        for status, payload in results:
            self._write_response(writer, status, payload)

    async def _serve_render(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """One rendered-tile exchange: 14-byte tail in, status (+ PNG) out.

        The tail's colormap id and flags are wire-controlled bytes and go
        through the sanctioned validators before anything dereferences
        them; an unknown colormap bumps its own named counter so a fleet
        of version-skewed viewers shows up as a spike, then kills the
        connection like every other validator failure.
        """
        raw = await self._read(framing.read_exact(
            reader, proto.RENDER_QUERY_TAIL.size))
        (level, index_real, index_imag,
         colormap_id, flags) = proto.RENDER_QUERY_TAIL.unpack(raw)
        try:
            proto.validate_colormap(colormap_id)
        except framing.ProtocolError:
            self.counters.inc(obs_names.GATEWAY_RENDER_UNKNOWN_COLORMAP)
            raise
        proto.validate_count(flags, 0, "render flags")
        status, payload = await self._resolve_render(
            level, index_real, index_imag, colormap_id)
        self._write_response(writer, status, payload)

    async def _serve_session(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        """One session-scoped exchange: 22-byte tail in, SESSION_REPLY +
        status (+ PNG) out.

        The tail's colormap and flag bytes are wire-controlled and go
        through the sanctioned validators (each behind its own named
        counter) before anything dereferences them; the session id is
        never more than a dict-key probe.  A gateway without a session
        service kills the connection like a validator failure — the
        client's capability story is "no reply header means no
        sessions", same as a legacy DataServer dropping the magic.
        """
        raw = await self._read(framing.read_exact(
            reader, proto.SESSION_QUERY_TAIL.size))
        (session_id, level, index_real, index_imag,
         colormap_id, flags) = proto.SESSION_QUERY_TAIL.unpack(raw)
        if self.sessions is None:
            self.counters.inc(obs_names.SESSION_UNSUPPORTED)
            raise framing.ProtocolError(
                "session query on a gateway without a session service")
        try:
            proto.validate_colormap(colormap_id)
        except framing.ProtocolError:
            self.counters.inc(obs_names.GATEWAY_RENDER_UNKNOWN_COLORMAP)
            raise
        try:
            proto.validate_session_flags(flags)
        except framing.ProtocolError:
            self.counters.inc(obs_names.SESSION_BAD_FLAGS)
            raise
        sid, caps, status, payload = await self._resolve_session(
            session_id, level, index_real, index_imag, colormap_id, flags)
        writer.write(proto.SESSION_REPLY.pack(sid, caps))
        self._write_response(writer, status, payload)

    def _write_response(self, writer: asyncio.StreamWriter, status: int,
                        payload: Optional[bytes | tuple[int, int]]) -> None:
        framing.write_byte(writer, status)
        if status == proto.QUERY_REDIRECT:
            # Fixed-size REDIRECT tail, no length prefix (net/protocol).
            # Packed here, after the status byte, so source order mirrors
            # wire order for the proto-frames parity check.
            assert isinstance(payload, tuple)
            writer.write(proto.REDIRECT.pack(*payload))
        elif status == proto.QUERY_ACCEPT:
            assert isinstance(payload, bytes)
            framing.write_u32(writer, len(payload))
            writer.write(payload)

    def _redirect_for(self, level: int, index_real: int,
                      index_imag: int) -> Optional[tuple[int, int]]:
        """``(authoritative shard, ring version)`` for a key another
        shard owns, else ``None``."""
        if self.ring_slice is None:
            return None
        key = (level, index_real, index_imag)
        if self.ring_slice.owns(key):
            return None
        self.counters.inc(obs_names.GATEWAY_REDIRECTS)
        return (self.ring_slice.owner_of(key), self.ring_slice.version)

    # -- the serve path ---------------------------------------------------

    async def _resolve_admitted(
            self, level: int, index_real: int,
            index_imag: int) -> tuple[int, Optional[bytes | tuple[int, int]]]:
        """Admission control, then resolve; returns (status, payload).

        One latency histogram (``gateway_request_seconds``) split by an
        ``outcome`` label: tier-1 hit / store hit / computed-on-read /
        unavailable / rejected / overloaded — the split is what makes a
        p99 actionable (a slow p99 of ``computed`` is farm latency; of
        ``store_hit``, disk).
        """
        t0 = time.monotonic()
        status, payload, outcome = await self._resolve_outcome(
            level, index_real, index_imag)
        self.registry.observe(obs_names.HIST_GATEWAY_REQUEST_SECONDS,
                              time.monotonic() - t0,
                              labels={"outcome": outcome})
        if status == proto.QUERY_ACCEPT:
            self.trace.record("served", (level, index_real, index_imag))
        return status, payload

    async def _resolve_outcome(
            self, level: int, index_real: int,
            index_imag: int) -> tuple[int, Optional[bytes | tuple[int, int]], str]:
        self.counters.inc("gateway_queries")
        if not proto.query_in_range(level, index_real, index_imag):
            self.counters.inc("gateway_rejected")
            flight.note(obs_events.GW_REJECT,
                        key=(level, index_real, index_imag), path="query")
            return proto.QUERY_REJECT, None, obs_names.OUTCOME_REJECTED
        redirect = self._redirect_for(level, index_real, index_imag)
        if redirect is not None:
            return proto.QUERY_REDIRECT, redirect, obs_names.OUTCOME_REDIRECTED
        # Tier-1 hits are answered before admission: they cost no I/O and
        # no compute, so shedding them would only push load onto retries.
        entry = self.cache.get_cached((level, index_real, index_imag))
        if entry is not None:
            self.counters.inc("gateway_served")
            return proto.QUERY_ACCEPT, entry.payload, obs_names.OUTCOME_TIER1
        if self._active >= self.max_queue_depth or not self.bucket.try_acquire():
            self.counters.inc("gateway_overloaded")
            logger.info("shed query (%d,%d,%d): %d in service",
                        level, index_real, index_imag, self._active)
            flight.note(obs_events.GW_SHED,
                        key=(level, index_real, index_imag), path="query",
                        in_service=self._active)
            return proto.QUERY_OVERLOADED, None, obs_names.OUTCOME_OVERLOADED
        self._active += 1
        try:
            payload, outcome = await self._resolve(level, index_real,
                                                   index_imag)
        finally:
            self._active -= 1
        if payload is None:
            self.counters.inc("gateway_unavailable")
            return (proto.QUERY_NOT_AVAILABLE, None,
                    obs_names.OUTCOME_UNAVAILABLE)
        self.counters.inc("gateway_served")
        return proto.QUERY_ACCEPT, payload, outcome

    # -- the render path --------------------------------------------------

    async def _resolve_render(
            self, level: int, index_real: int, index_imag: int,
            colormap_id: int) -> tuple[int, Optional[bytes | tuple[int, int]]]:
        """Render-path twin of :meth:`_resolve_admitted`: same admission
        gates, same latency histogram (new ``outcome`` values), payload is
        a palette PNG instead of the codec body."""
        t0 = time.monotonic()
        status, payload, outcome = await self._render_outcome(
            level, index_real, index_imag, colormap_id)
        self.registry.observe(obs_names.HIST_GATEWAY_REQUEST_SECONDS,
                              time.monotonic() - t0,
                              labels={"outcome": outcome})
        if status == proto.QUERY_ACCEPT:
            self.trace.record(
                "render_served",
                (level, index_real, index_imag, colormap_id))
        return status, payload

    async def _render_outcome(
            self, level: int, index_real: int, index_imag: int,
            colormap_id: int) -> tuple[int, Optional[bytes | tuple[int, int]], str]:
        self.counters.inc(obs_names.GATEWAY_RENDER_QUERIES)
        if not proto.query_in_range(level, index_real, index_imag):
            self.counters.inc("gateway_rejected")
            flight.note(obs_events.GW_REJECT,
                        key=(level, index_real, index_imag), path="render")
            return proto.QUERY_REJECT, None, obs_names.OUTCOME_REJECTED
        redirect = self._redirect_for(level, index_real, index_imag)
        if redirect is not None:
            return proto.QUERY_REDIRECT, redirect, obs_names.OUTCOME_REDIRECTED
        # Like tier-1 raw hits, rendered-cache hits are answered before
        # admission: a hot body is a memcpy, and the render cache is the
        # whole point under flash-crowd load.
        render_key = (level, index_real, index_imag, colormap_id)
        body = self.render_cache.get(render_key)
        if body is not None:
            self.counters.inc(obs_names.GATEWAY_RENDER_SERVED)
            return (proto.QUERY_ACCEPT, body,
                    obs_names.OUTCOME_RENDER_CACHE)
        if self._active >= self.max_queue_depth \
                or not self.bucket.try_acquire():
            self.counters.inc("gateway_overloaded")
            logger.info("shed render (%d,%d,%d): %d in service",
                        level, index_real, index_imag, self._active)
            flight.note(obs_events.GW_SHED,
                        key=(level, index_real, index_imag), path="render",
                        in_service=self._active)
            return proto.QUERY_OVERLOADED, None, obs_names.OUTCOME_OVERLOADED
        self._active += 1
        try:
            body = await self._render(level, index_real, index_imag,
                                      colormap_id)
        finally:
            self._active -= 1
        if body is None:
            self.counters.inc("gateway_unavailable")
            return (proto.QUERY_NOT_AVAILABLE, None,
                    obs_names.OUTCOME_UNAVAILABLE)
        self.counters.inc(obs_names.GATEWAY_RENDER_SERVED)
        return proto.QUERY_ACCEPT, body, obs_names.OUTCOME_RENDERED

    async def _render(self, level: int, index_real: int, index_imag: int,
                      colormap_id: int) -> Optional[bytes]:
        """Resolve the escape payload through the raw serve path (tier-1 /
        store / compute-on-read, coalesced), then colormap + PNG-encode on
        a worker thread.  Single-flight per (tile, colormap): a stampede
        on one hot rendered tile costs one render."""
        max_iter = self._level_max_iter.get(level)
        flight_key = ("render", level, max_iter, index_real, index_imag,
                      colormap_id)

        async def supplier() -> Optional[bytes]:
            payload, _outcome = await self._resolve(level, index_real,
                                                    index_imag)
            if payload is None:
                return None
            t0 = time.monotonic()
            body = await asyncio.to_thread(
                self._render_body, payload, colormap_id)
            self.registry.observe(obs_names.HIST_GATEWAY_RENDER_SECONDS,
                                  time.monotonic() - t0)
            return self.render_cache.put(
                (level, index_real, index_imag, colormap_id), body)

        return await self.singleflight.run(flight_key, supplier)

    def _render_body(self, payload: bytes, colormap_id: int) -> bytes:
        """Blocking decode + render; runs on a worker thread."""
        pixels = Chunk.deserialize_data(payload)
        return render.render_tile_png(pixels,
                                      proto.COLORMAPS[colormap_id])

    # -- the session path --------------------------------------------------

    async def _resolve_session(
            self, session_id: int, level: int, index_real: int,
            index_imag: int, colormap_id: int, flags: int
    ) -> tuple[int, int, int, Optional[bytes | tuple[int, int]]]:
        """Session lifecycle + admission + render; returns
        ``(session id, granted caps, status, payload)``.

        Latency lands in its own histogram (``session_request_seconds``,
        split by the same outcome label family) so first-paint latency is
        directly comparable against the full-depth render path.
        """
        svc = self.sessions
        self.counters.inc(obs_names.SESSION_QUERIES)
        if session_id == 0:
            state = svc.open(flags)
        else:
            state = svc.touch(session_id)
            if state is None:
                # Soft reject on a live connection: expired/unknown ids
                # are a normal part of the lifecycle (TTL, LRU eviction,
                # gateway restart) — the client reopens with id 0.
                self.counters.inc(obs_names.SESSION_UNKNOWN)
                return 0, 0, proto.QUERY_REJECT, None
        t0 = time.monotonic()
        status, payload, outcome = await self._session_outcome(
            state, level, index_real, index_imag, colormap_id)
        self.registry.observe(obs_names.HIST_SESSION_REQUEST_SECONDS,
                              time.monotonic() - t0,
                              labels={"outcome": outcome})
        return state.session_id, state.caps, status, payload

    async def _session_outcome(
            self, state, level: int, index_real: int, index_imag: int,
            colormap_id: int
    ) -> tuple[int, Optional[bytes | tuple[int, int]], str]:
        if not proto.query_in_range(level, index_real, index_imag):
            self.counters.inc("gateway_rejected")
            flight.note(obs_events.GW_REJECT,
                        key=(level, index_real, index_imag), path="session")
            return proto.QUERY_REJECT, None, obs_names.OUTCOME_REJECTED
        redirect = self._redirect_for(level, index_real, index_imag)
        if redirect is not None:
            return proto.QUERY_REDIRECT, redirect, obs_names.OUTCOME_REDIRECTED
        # The viewport hint always lands (trajectory + prefetch verdict
        # + plan), whatever the admission verdict below — a shed query
        # is still evidence of where the user is heading.
        planned = self.sessions.note_query(state, level, index_real,
                                           index_imag)
        if planned:
            self._spawn_prefetch(planned)
        # Weighted fair admission: the session's private budget is
        # charged before everything — even cache hits.  The global
        # bucket below protects compute, so cached bytes rightly skip
        # it; this one bounds the *session's* service rate, and a hot
        # session replaying cached tiles must not dodge its budget
        # while the rest of the crowd queues.
        if not state.admit():
            self.counters.inc(obs_names.SESSION_THROTTLED)
            flight.note(obs_events.GW_SESSION_THROTTLE,
                        key=(level, index_real, index_imag),
                        session=state.session_id)
            return (proto.QUERY_OVERLOADED, None,
                    obs_names.OUTCOME_SESSION_THROTTLED)
        render_key = (level, index_real, index_imag, colormap_id)
        body = self.render_cache.get(render_key)
        if body is not None:
            self.counters.inc(obs_names.GATEWAY_RENDER_SERVED)
            return (proto.QUERY_ACCEPT, body,
                    obs_names.OUTCOME_RENDER_CACHE)
        if self._active >= self.max_queue_depth \
                or not self.bucket.try_acquire():
            self.counters.inc("gateway_overloaded")
            flight.note(obs_events.GW_SHED,
                        key=(level, index_real, index_imag),
                        path="session", in_service=self._active)
            return proto.QUERY_OVERLOADED, None, obs_names.OUTCOME_OVERLOADED
        self._active += 1
        try:
            body, outcome = await self._render_session(
                state, level, index_real, index_imag, colormap_id)
        finally:
            self._active -= 1
        if body is None:
            self.counters.inc("gateway_unavailable")
            return (proto.QUERY_NOT_AVAILABLE, None,
                    obs_names.OUTCOME_UNAVAILABLE)
        self.counters.inc(obs_names.GATEWAY_RENDER_SERVED)
        return proto.QUERY_ACCEPT, body, outcome

    def _spawn_prefetch(self, keys: list[tuple[int, int, int]]) -> None:
        """Warm planned tiles off the response path (fire-and-forget)."""
        task = asyncio.get_running_loop().create_task(
            self.sessions.prefetch(keys))
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_tasks.discard)

    async def _render_session(
            self, state, level: int, index_real: int, index_imag: int,
            colormap_id: int) -> tuple[Optional[bytes], str]:
        """Render for a session: refine-capable sessions get cold tiles
        as a cheap low-``max_iter`` first paint (the full depth is
        scheduled behind it); everything else takes the standard render
        path.  Warm tiles (tier 1 / store) are full quality either way —
        the first-paint shortcut only pays when pixels would have to be
        computed."""
        full_iter = self._level_max_iter.get(level)
        fp_iter = None
        if state.caps & proto.SESSION_CAP_REFINE:
            fp_iter = self.sessions.first_paint_iter(full_iter)
        if fp_iter is None or self.ondemand is None:
            body = await self._render(level, index_real, index_imag,
                                      colormap_id)
            return body, obs_names.OUTCOME_RENDERED
        flight_key = ("render", level, fp_iter, index_real, index_imag,
                      colormap_id)

        async def supplier() -> tuple[Optional[bytes], str]:
            payload, outcome = await self._resolve_first_paint(
                level, index_real, index_imag, fp_iter, full_iter)
            if payload is None:
                return None, obs_names.OUTCOME_UNAVAILABLE
            t0 = time.monotonic()
            body = await asyncio.to_thread(
                self._render_body, payload, colormap_id)
            self.registry.observe(obs_names.HIST_GATEWAY_RENDER_SECONDS,
                                  time.monotonic() - t0)
            if outcome is not obs_names.OUTCOME_FIRST_PAINT:
                # Shallow bodies must not linger in the render cache:
                # they'd outlive the deep save's invalidation sweep only
                # if cached before it — which this put would be.
                body = self.render_cache.put(
                    (level, index_real, index_imag, colormap_id), body)
            return body, outcome

        return await self.singleflight.run(flight_key, supplier)

    async def _resolve_first_paint(
            self, level: int, index_real: int, index_imag: int,
            fp_iter: int, full_iter: int) -> tuple[Optional[bytes], str]:
        """Payload for a first paint: warm reads are full quality; a true
        miss computes the cheap variant and queues the deep one."""
        key = (level, index_real, index_imag)
        flight_key = (level, fp_iter, index_real, index_imag)

        async def supplier() -> tuple[Optional[bytes], str]:
            entry = await asyncio.to_thread(self.cache.load, key)
            if entry is not None:
                return entry.payload, obs_names.OUTCOME_STORE
            entry = await self.ondemand.compute(
                Workload(level, fp_iter, index_real, index_imag))
            if entry is None:
                return None, obs_names.OUTCOME_UNAVAILABLE
            # Deliberately NOT promoted into tier 1: the shallow payload
            # is a one-shot paint, and the deep save that follows would
            # have to invalidate it anyway.
            self.counters.inc(obs_names.SESSION_FIRST_PAINTS)
            self.sessions.schedule_refine(
                Workload(level, full_iter, index_real, index_imag))
            return entry.payload, obs_names.OUTCOME_FIRST_PAINT

        return await self.singleflight.run(flight_key, supplier)

    def invalidate_saved(self, key: tuple[int, int, int]) -> None:
        """A (possibly deeper) variant of ``key`` just persisted: drop
        the stale decoded and rendered cache entries and settle any
        pending refinement.  The coordinator's save hook fans in here."""
        self.cache.invalidate(key)
        self.render_cache.invalidate_tile(key)
        if self.sessions is not None:
            self.sessions.on_chunk_saved(key)

    async def _resolve(self, level: int, index_real: int,
                       index_imag: int) -> tuple[Optional[bytes], str]:
        """Store lookup falling through to compute-on-read, single-flight
        per full workload identity ``(level, max_iter, i, j)``; returns
        ``(payload, outcome)`` (followers inherit the leader's outcome —
        they paid the leader's resolution path's latency)."""
        key = (level, index_real, index_imag)
        max_iter = self._level_max_iter.get(level)
        flight_key = (level, max_iter, index_real, index_imag)

        async def supplier() -> tuple[Optional[bytes], str]:
            entry = await asyncio.to_thread(self.cache.load, key)
            outcome = obs_names.OUTCOME_STORE
            if entry is None and self.ondemand is not None \
                    and max_iter is not None:
                entry = await self.ondemand.compute(
                    Workload(level, max_iter, index_real, index_imag))
                outcome = obs_names.OUTCOME_COMPUTED
                if entry is not None:
                    # Promote the fresh tile so follow-up requests are
                    # tier-1 hits, not store reads.
                    entry = self.cache.put(key, entry.payload)
            if entry is None:
                return None, obs_names.OUTCOME_UNAVAILABLE
            return entry.payload, outcome

        return await self.singleflight.run(flight_key, supplier)
