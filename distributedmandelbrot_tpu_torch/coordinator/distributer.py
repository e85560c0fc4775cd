"""Asyncio job-distribution server (the write-side coordinator service).

Wire-compatible with the reference Distributer (``Distributer.cs:207-458``)
— same purpose/status codes, same 16-byte workload frames, same raw
16 MiB result payload — plus the batched-dispatch extension
(:mod:`distributedmandelbrot_tpu_torch.net.protocol`).

Differences by design:

- single asyncio event loop instead of a blocking accept loop + threads;
  chunk persistence runs in a thread pool so ingest never blocks the loop
  (the reference saves on a fire-and-forget Task, ``Distributer.cs:436-442``)
- every receive is exact-length (fixes the 16 MiB short-read bug,
  ``Distributer.cs:415-416``)
- a connection may carry any number of messages back-to-back (the
  reference is connection-per-message; clients that close after one
  message remain fully supported — EOF just ends the session)
- the lease sweep is an asyncio task with the same default 5-minute period
  (``Distributer.cs:24``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import numpy as np

from distributedmandelbrot_tpu_torch.codecs.rle import RleCodec
from distributedmandelbrot_tpu_torch.coordinator.scheduler import (Key,
                                                             TileScheduler)
from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu_torch.core.workload import (WORKLOAD_WIRE_SIZE,
                                                     Workload)
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.spans import Span, SpanStore
from distributedmandelbrot_tpu_torch.obs.trace import TraceLog
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils import faults
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

logger = logging.getLogger("dmtpu.distributer")

MAX_BATCH = 4096
# Per-report ceiling on sync samples / span records: a worker drains its
# recorder (8 K ring) after every upload, so an honest report is far
# smaller; a count beyond this is a corrupt or hostile frame.
MAX_SPANS = 65536

# Wire stage code (net/protocol.py SPAN_STAGE_*) -> stage name.
_STAGE_NAMES = {
    proto.SPAN_STAGE_PREFETCH: obs_names.SPAN_PREFETCH,
    proto.SPAN_STAGE_DISPATCH: obs_names.SPAN_DISPATCH,
    proto.SPAN_STAGE_COMPUTE: obs_names.SPAN_COMPUTE,
    proto.SPAN_STAGE_D2H: obs_names.SPAN_D2H,
    proto.SPAN_STAGE_UPLOAD: obs_names.SPAN_UPLOAD,
}


def _peer_id(writer: asyncio.StreamWriter) -> Optional[str]:
    """Connection id for trace events — the per-worker key the skew
    summary groups on (a worker keeps one connection per exchange loop)."""
    peer = writer.get_extra_info("peername")
    if isinstance(peer, (tuple, list)) and len(peer) >= 2:
        return f"{peer[0]}:{peer[1]}"
    return str(peer) if peer else None


class Distributer:
    def __init__(self, scheduler: TileScheduler, store: ChunkStore, *,
                 host: str = "0.0.0.0",
                 port: int = proto.DEFAULT_DISTRIBUTER_PORT,
                 sweep_period: float = proto.DEFAULT_SWEEP_PERIOD,
                 read_timeout: Optional[float] = proto.DEFAULT_READ_TIMEOUT,
                 counters: Optional[Counters] = None,
                 trace: Optional[TraceLog] = None,
                 spans: Optional[SpanStore] = None,
                 accept_spans: bool = True,
                 accept_session: bool = True,
                 on_chunk_saved=None,
                 ring_slice=None) -> None:
        self.scheduler = scheduler
        self.store = store
        # One shard's view of the consistent-hash ring (control/ring.py
        # RingSlice, duck-typed to avoid an import cycle through the
        # control package).  None is the unsharded coordinator: the
        # SHARD capability is never offered and every key is ours.
        self.ring_slice = ring_slice
        self.host = host
        self.port = port
        self.sweep_period = sweep_period
        self.read_timeout = read_timeout
        self.counters = counters if counters is not None else Counters()
        self.registry = self.counters.registry
        self.trace = trace if trace is not None else TraceLog()
        self.spans = spans if spans is not None else SpanStore()
        # False makes this build behave like a legacy coordinator for the
        # 0x04 extension (unknown purpose byte -> drop the connection) —
        # the degradation path the worker tests drive.
        self.accept_spans = accept_spans
        # Same switch for the 0x05 session extension: False drops the
        # hello, which is what pushes a session-capable worker onto its
        # connection-per-exchange fallback.
        self.accept_session = accept_session
        self._rle = RleCodec()
        # Optional ``callback(key)`` fired on this event loop after a chunk
        # is durably persisted — the gateway's on-demand path hangs its
        # arrival notification here.
        self.on_chunk_saved = on_chunk_saved
        self._server: Optional[asyncio.Server] = None
        self._sweep_task: Optional[asyncio.Task] = None
        # Group-commit persistence: accepted tiles go through a bounded
        # queue to one drainer task, which coalesces whatever is backed
        # up into a single ``store.put_many`` flush per wake-up.  The
        # bound is backpressure — a store slower than ingest stalls the
        # uploading sessions instead of growing an unbounded backlog.
        self._persist_queue: Optional[asyncio.Queue] = None
        self._persist_task: Optional[asyncio.Task] = None
        self.persist_queue_depth = 256
        self.persist_flush_tiles = 64
        # Tiles accepted in the scheduler whose asynchronous save has not
        # landed yet.  The recovery manager excludes these from every
        # checkpoint: completed-in-memory without a durable index entry
        # must not be checkpointed as done (coordinator/recovery.py).
        self._pending_saves: set[Key] = set()

    async def _read(self, coro):
        """Apply the configured read deadline (reference: the toggleable
        socket receive timeout, Distributer.cs:17).  A client that stalls
        mid-frame raises TimeoutError and loses the connection instead of
        pinning a handler task (and its claim) until lease expiry."""
        if self.read_timeout is None:
            return await coro
        try:
            return await asyncio.wait_for(coro, self.read_timeout)
        except (TimeoutError, asyncio.TimeoutError):
            # asyncio.TimeoutError only aliases the builtin from 3.11 on;
            # catching both keeps 3.10 (pyproject's floor) correct.
            self.counters.inc("read_timeouts")
            raise

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._sweep_task = asyncio.create_task(self._sweep_loop())
        self._start_persist_loop()
        self.registry.gauge(
            obs_names.GAUGE_PERSIST_QUEUE_DEPTH,
            fn=lambda: self._persist_queue.qsize()
            if self._persist_queue is not None else 0)
        logger.info("distributer listening on %s:%d", self.host, self.port)

    def _start_persist_loop(self) -> None:
        self._persist_queue = asyncio.Queue(maxsize=self.persist_queue_depth)
        self._persist_task = asyncio.create_task(self._persist_loop())

    async def stop(self) -> None:
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            try:
                await self._sweep_task
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._persist_task is not None:
            # Flush: the sentinel trails every enqueued tile, so awaiting
            # the drainer means every accepted result is durable (or
            # reopened) before stop() returns.
            await self._persist_queue.put(None)
            try:
                await self._persist_task
            except asyncio.CancelledError:
                pass
            self._persist_task = None

    async def _sweep_loop(self) -> None:
        while True:
            await asyncio.sleep(self.sweep_period)
            swept = self.scheduler.sweep()
            if swept:
                logger.info("lease sweep requeued %d tiles", swept)

    # -- connection handling ----------------------------------------------

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        # Counted at accept so the session e2e can assert the steady
        # state really is one connection per worker lane.
        self.counters.inc(obs_names.COORD_CONNECTIONS_ACCEPTED)
        try:
            while True:
                try:
                    # Idle deadline too: a silent client is disconnected
                    # (it re-dials) instead of pinning this task forever.
                    purpose = await framing.read_byte(reader) \
                        if self.read_timeout is None else \
                        await asyncio.wait_for(framing.read_byte(reader),
                                               self.read_timeout)
                except (ConnectionError, TimeoutError,
                        asyncio.TimeoutError):
                    break  # clean EOF / idle close between messages
                if purpose == proto.PURPOSE_REQUEST:
                    await self._handle_request(writer)
                elif purpose == proto.PURPOSE_RESPONSE:
                    await self._handle_response(reader, writer)
                elif purpose == proto.PURPOSE_BATCH_REQUEST:
                    await self._handle_batch_request(reader, writer)
                elif purpose == proto.PURPOSE_BATCH_RESPONSE:
                    await self._handle_batch_response(reader, writer)
                elif purpose == proto.PURPOSE_SPANS and self.accept_spans:
                    await self._handle_spans(reader, writer)
                elif purpose == proto.PURPOSE_SESSION and self.accept_session:
                    await self._handle_session(reader, writer)
                    break  # a session consumes the connection; EOF follows
                else:
                    logger.error("unknown purpose byte %#x from %s",
                                 purpose, peer)
                    self.counters.inc(obs_names.COORD_FRAMES_REJECTED)
                    flight.note(obs_events.SESS_REJECT_FRAME, peer=peer,
                                purpose=purpose)
                    break
                await writer.drain()
        except (ConnectionError, TimeoutError, asyncio.TimeoutError,
                asyncio.CancelledError):
            pass  # per-connection failures never take down the accept loop
        except framing.ProtocolError as e:
            # Malformed or hostile frame: drop the connection, leave a
            # trail, keep the accept loop alive.
            self.counters.inc(obs_names.COORD_FRAMES_REJECTED)
            flight.note(obs_events.SESS_REJECT_FRAME, peer=peer,
                        error=str(e)[:120])
            logger.error("dropping %s: %s", peer, e)
        except Exception:
            logger.exception("error serving %s", peer)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_request(self, writer: asyncio.StreamWriter) -> None:
        with self.registry.timed(obs_names.HIST_GRANT_SECONDS):
            w = self.scheduler.acquire()
            if w is None:
                framing.write_byte(writer, proto.WORKLOAD_NOT_AVAILABLE)
                self.counters.inc("requests_denied")
            else:
                framing.write_byte(writer, proto.WORKLOAD_AVAILABLE)
                writer.write(w.to_wire())
                self.counters.inc("workloads_granted")
                self.trace.record("granted", w.key, worker=_peer_id(writer))
                # Grant timestamp for NTP-style clock alignment: paired
                # with the worker's request/receive clock samples when a
                # span report for this key arrives (obs/spans.py).
                self.spans.note_grant(w.key, time.monotonic())
                logger.info("granted %s", w)

    async def _handle_batch_request(self, reader: asyncio.StreamReader,
                                    writer: asyncio.StreamWriter) -> None:
        count = await self._read(framing.read_u32(reader))
        with self.registry.timed(obs_names.HIST_GRANT_SECONDS):
            grants = self.scheduler.acquire_batch(min(count, MAX_BATCH))
            if not grants:
                framing.write_byte(writer, proto.WORKLOAD_NOT_AVAILABLE)
                self.counters.inc("requests_denied")
                return
            framing.write_byte(writer, proto.WORKLOAD_AVAILABLE)
            framing.write_u32(writer, len(grants))
            peer = _peer_id(writer)
            t_grant = time.monotonic()
            for w in grants:
                writer.write(w.to_wire())
                self.trace.record("granted", w.key, worker=peer)
                self.spans.note_grant(w.key, t_grant)
            self.counters.inc("workloads_granted", len(grants))
            logger.info("granted batch of %d tiles", len(grants))

    async def _handle_response(self, reader: asyncio.StreamReader,
                               writer: asyncio.StreamWriter) -> None:
        await self._ingest_one(reader, writer)

    async def _handle_spans(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        """Ingest one worker span report (PURPOSE_SPANS, 0x04)."""
        worker_id, sync_data, span_data = await self._read_span_report(reader)
        self._ingest_span_report(worker_id, sync_data, span_data)
        framing.write_byte(writer, proto.SPANS_ACCEPT)

    async def _read_span_report(self, reader: asyncio.StreamReader,
                                declared: Optional[int] = None):
        """Read one span report body (shared by the 0x04 exchange and the
        session's FRAME_SPANS, which also cross-checks the frame header's
        declared length against the report's own counts)."""
        hdr = await self._read(
            framing.read_exact(reader, proto.SPANS_HEADER_WIRE_SIZE))
        worker_id, n_sync, n_spans = proto.SPANS_HEADER.unpack(hdr)
        n_sync = proto.validate_count(
            n_sync, MAX_SPANS, f"sync count from worker {worker_id:016x}")
        n_spans = proto.validate_count(
            n_spans, MAX_SPANS, f"span count from worker {worker_id:016x}")
        if declared is not None and declared != (
                proto.SPANS_HEADER_WIRE_SIZE
                + n_sync * proto.SPAN_SYNC_WIRE_SIZE
                + n_spans * proto.SPAN_RECORD_WIRE_SIZE):
            raise framing.ProtocolError(
                f"span frame length {declared} disagrees with its counts")
        sync_data = await self._read(framing.read_exact(
            reader, n_sync * proto.SPAN_SYNC_WIRE_SIZE))
        span_data = await self._read(framing.read_exact(
            reader, n_spans * proto.SPAN_RECORD_WIRE_SIZE))
        return worker_id, sync_data, span_data

    def _ingest_span_report(self, worker_id: int, sync_data: bytes,
                            span_data: bytes) -> None:
        for level, ir, ii, t_req, t_recv in \
                proto.SPAN_SYNC.iter_unpack(sync_data):
            c_grant = self.spans.grant_time((level, ir, ii))
            if c_grant is None:
                # Grant fell out of the bounded map (or predates this
                # process); the sample cannot be paired.
                self.counters.inc(obs_names.COORD_SPANS_UNALIGNED)
                continue
            self.spans.add_sync(worker_id, c_grant, t_req, t_recv)
            self.counters.inc(obs_names.COORD_SPAN_SYNC_SAMPLES)
        records = []
        for level, ir, ii, stage, device, seq, t0, t1 in \
                proto.SPAN_RECORD.iter_unpack(span_data):
            name = _STAGE_NAMES.get(stage)
            if name is None:
                continue  # future stage code from a newer worker; skip
            records.append(Span(name, (level, ir, ii), t0, t1,
                                device, seq))
        self.counters.inc(obs_names.COORD_SPANS_INGESTED,
                          self.spans.ingest(worker_id, records))
        self.counters.inc(obs_names.COORD_SPAN_REPORTS)

    # -- persistent session (PURPOSE_SESSION, 0x05) ------------------------

    async def _handle_session(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter) -> None:
        """Run one persistent multiplexed session until the peer hangs up.

        Hello first (echoing the negotiated capability subset), then a
        frame loop: lease requests, uploads (whose acks may piggyback
        fresh grants), span reports.  Client frames must arrive with
        strictly incrementing seqs; any violation or malformed frame
        raises ProtocolError, which drops the whole session.
        """
        hello = await self._read(
            framing.read_exact(reader, proto.SESSION_HELLO_WIRE_SIZE))
        (offered,) = proto.SESSION_HELLO.unpack(hello)
        # SHARD is only echoed by a ring-configured coordinator, so a
        # sharded worker dialing an unsharded one negotiates down to
        # treating it as the sole owner of the keyspace.
        acceptable = proto.SESSION_FLAG_RLE | proto.SESSION_FLAG_GRANTN
        if self.ring_slice is not None:
            acceptable |= proto.SESSION_FLAG_SHARD
        negotiated = offered & acceptable
        framing.write_byte(writer, proto.SESSION_ACCEPT)
        writer.write(proto.SESSION_HELLO.pack(negotiated))
        await writer.drain()
        self.counters.inc(obs_names.COORD_SESSIONS_OPENED)
        peer = _peer_id(writer)
        flight.note(obs_events.SESS_OPEN, peer=peer,
                    negotiated=negotiated)
        expected_seq = 0
        while True:
            try:
                hdr = await self._read(framing.read_exact(
                    reader, proto.SESSION_FRAME_WIRE_SIZE))
            except (ConnectionError, TimeoutError, asyncio.TimeoutError):
                return  # clean end of session (EOF or idle between frames)
            frame_type, seq, length = proto.SESSION_FRAME.unpack(hdr)
            proto.validate_session_seq(seq, expected_seq)
            expected_seq = (expected_seq + 1) & proto.MAX_SESSION_SEQ
            length = proto.validate_payload_length(length)
            self.counters.inc(obs_names.COORD_SESSION_FRAMES)
            if frame_type == proto.FRAME_LEASE_REQ:
                await self._session_lease(reader, writer, seq, length)
            elif frame_type == proto.FRAME_LEASE_REQN:
                await self._session_lease_reqn(reader, writer, seq, length,
                                               negotiated)
            elif frame_type == proto.FRAME_UPLOAD:
                await self._session_upload(reader, writer, seq, length,
                                           negotiated, peer)
            elif frame_type == proto.FRAME_SPANS:
                await self._session_spans(reader, length)
            elif frame_type == proto.FRAME_RING_REQ:
                await self._session_ring_req(reader, writer, seq, length,
                                             negotiated)
            else:
                raise framing.ProtocolError(
                    f"unknown session frame type "
                    f"{proto.frame_name(frame_type)}")
            await writer.drain()

    async def _session_lease(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter,
                             seq: int, length: int) -> None:
        if length != 4:
            raise framing.ProtocolError(
                f"lease request frame length {length}, expected 4")
        count = proto.validate_count(
            await self._read(framing.read_u32(reader)), MAX_BATCH,
            "session lease count")
        with self.registry.timed(obs_names.HIST_GRANT_SECONDS):
            grants = self.scheduler.acquire_batch(count) if count else []
        if not grants:
            self.counters.inc("requests_denied")
        writer.write(proto.SESSION_FRAME.pack(
            proto.FRAME_LEASE_GRANT, seq,
            4 + len(grants) * WORKLOAD_WIRE_SIZE))
        self._write_grant_list(writer, grants, _peer_id(writer))

    async def _session_lease_reqn(self, reader: asyncio.StreamReader,
                                  writer: asyncio.StreamWriter,
                                  seq: int, length: int,
                                  negotiated: int) -> None:
        """Batched lease request: grant up to ``count`` tiles in one round
        trip, replied as groups no wider than the worker's fusion width so
        the pipeline's dispatch coalescer can hand each group straight to a
        megakernel launch without re-slicing."""
        if not negotiated & proto.SESSION_FLAG_GRANTN:
            raise framing.ProtocolError(
                "batched lease request on a session that did not "
                "negotiate it")
        if length != proto.LEASE_REQN_WIRE_SIZE:
            raise framing.ProtocolError(
                f"batched lease frame length {length}, expected "
                f"{proto.LEASE_REQN_WIRE_SIZE}")
        count, width = proto.LEASE_REQN.unpack(await self._read(
            framing.read_exact(reader, proto.LEASE_REQN_WIRE_SIZE)))
        count = proto.validate_count(count, MAX_BATCH, "batched lease count")
        if count == 0:
            raise framing.ProtocolError(
                "batched lease count 0 (a worker with no room must not ask)")
        width = proto.validate_count(width, count, "grant batch width")
        if width == 0:
            raise framing.ProtocolError("grant batch width 0")
        with self.registry.timed(obs_names.HIST_GRANT_SECONDS):
            grants = self.scheduler.acquire_batch(count)
        if not grants:
            # Empty drain probes are visible as requests_denied; counting
            # them as batches would skew grants-per-batch toward zero.
            self.counters.inc("requests_denied")
        else:
            # Counted BEFORE the reply hits the wire: a client thread can
            # otherwise read the grants and assert on the counter while
            # this coroutine is still a few statements from the inc.
            self.counters.inc(obs_names.COORD_GRANT_BATCHES)
            self.registry.observe(obs_names.HIST_COORD_GRANTS_PER_BATCH,
                                  float(len(grants)))
        batches = [grants[i:i + width] for i in range(0, len(grants), width)]
        writer.write(proto.SESSION_FRAME.pack(
            proto.FRAME_LEASE_GRANTN, seq,
            proto.LEASE_GRANTN_WIRE_SIZE + 4 * len(batches)
            + len(grants) * WORKLOAD_WIRE_SIZE))
        writer.write(proto.LEASE_GRANTN.pack(len(batches), len(grants)))
        peer = _peer_id(writer)
        for batch in batches:
            self._write_grant_list(writer, batch, peer)

    def _write_grant_list(self, writer: asyncio.StreamWriter, grants,
                          peer: Optional[str]) -> None:
        framing.write_u32(writer, len(grants))
        t_grant = time.monotonic()
        for w in grants:
            writer.write(w.to_wire())
            self.trace.record("granted", w.key, worker=peer)
            self.spans.note_grant(w.key, t_grant)
        if grants:
            self.counters.inc("workloads_granted", len(grants))

    async def _session_ring_req(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter,
                                seq: int, length: int,
                                negotiated: int) -> None:
        """Answer a worker's ring query with this shard's slice identity.

        A stale client ring version is counted but still answered — the
        reply IS the correction; only a session that never negotiated
        sharding asking is a protocol violation."""
        if not negotiated & proto.SESSION_FLAG_SHARD:
            raise framing.ProtocolError(
                "ring request on a session that did not negotiate sharding")
        if length != proto.RING_REQ_WIRE_SIZE:
            raise framing.ProtocolError(
                f"ring request frame length {length}, expected "
                f"{proto.RING_REQ_WIRE_SIZE}")
        (client_version,) = proto.RING_REQ.unpack(await self._read(
            framing.read_exact(reader, proto.RING_REQ_WIRE_SIZE)))
        rs = self.ring_slice
        self.counters.inc(obs_names.COORD_SHARD_RING_REQS)
        if client_version != rs.version:
            self.counters.inc(obs_names.COORD_SHARD_RING_SKEW)
        writer.write(proto.SESSION_FRAME.pack(
            proto.FRAME_RING_INFO, seq, proto.RING_INFO_WIRE_SIZE))
        writer.write(proto.RING_INFO.pack(rs.version, rs.shard,
                                          rs.n_shards))

    def _write_redirect(self, writer: asyncio.StreamWriter, seq: int,
                        owner: int) -> None:
        """Redirect answer for a misrouted upload: the ack slot carries
        the authoritative shard instead of accept/reject."""
        writer.write(proto.SESSION_FRAME.pack(
            proto.FRAME_REDIRECT, seq, proto.REDIRECT_WIRE_SIZE))
        writer.write(proto.REDIRECT.pack(owner, self.ring_slice.version))
        self.counters.inc(obs_names.COORD_SHARD_REDIRECTS)

    def _write_upload_ack(self, writer: asyncio.StreamWriter, seq: int,
                          flag: int, want: int, peer: Optional[str]) -> None:
        """Accept/reject ack for one upload, piggybacking up to ``want``
        fresh grants — the steady-state replacement for a separate lease
        round trip."""
        if want:
            with self.registry.timed(obs_names.HIST_GRANT_SECONDS):
                grants = self.scheduler.acquire_batch(want)
        else:
            grants = []
        writer.write(proto.SESSION_FRAME.pack(
            proto.FRAME_UPLOAD_ACK, seq,
            1 + 4 + len(grants) * WORKLOAD_WIRE_SIZE))
        framing.write_byte(writer, flag)
        self._write_grant_list(writer, grants, peer)

    async def _session_upload(self, reader: asyncio.StreamReader,
                              writer: asyncio.StreamWriter, seq: int,
                              length: int, negotiated: int,
                              peer: Optional[str]) -> None:
        t_accept = time.monotonic()
        min_len = WORKLOAD_WIRE_SIZE + proto.UPLOAD_HEADER_WIRE_SIZE
        if length < min_len:
            raise framing.ProtocolError(
                f"upload frame length {length} below header size {min_len}")
        w = Workload.from_wire(await self._read(
            framing.read_exact(reader, WORKLOAD_WIRE_SIZE)))
        codec, want = proto.UPLOAD_HEADER.unpack(await self._read(
            framing.read_exact(reader, proto.UPLOAD_HEADER_WIRE_SIZE)))
        want = proto.validate_count(want, MAX_BATCH, "piggyback lease count")
        body_len = length - min_len
        if codec == proto.WIRE_CODEC_RAW:
            # An RLE body's length is data-dependent (bounded by the
            # already-validated frame length); a raw body is exact.
            if body_len != CHUNK_PIXELS:
                raise framing.ProtocolError(
                    f"raw upload body {body_len}, expected {CHUNK_PIXELS}")
        elif codec == proto.WIRE_CODEC_RLE:
            if not negotiated & proto.SESSION_FLAG_RLE:
                raise framing.ProtocolError(
                    "RLE upload on a session that did not negotiate it")
        else:
            raise framing.ProtocolError(f"unknown wire codec {codec:#x}")
        if self.ring_slice is not None and not self.ring_slice.owns(w.key):
            # Another shard's key (a worker holding a stale ring, or a
            # ring version rolled mid-flight): drain the body to keep
            # the frame stream in sync, then point at the owner.  Only
            # SHARD-negotiated sessions can legally carry foreign keys'
            # redirects, but a misroute on a down-negotiated session
            # still must not be accepted — reject it there instead.
            await self._read(framing.read_exact(reader, body_len))
            self.counters.inc(obs_names.COORD_SHARD_MISROUTES)
            if negotiated & proto.SESSION_FLAG_SHARD:
                owner = self.ring_slice.owner_of(w.key)
                logger.info("redirecting result for %s to shard %d", w,
                            owner)
                flight.note(obs_events.SESS_REDIRECT, key=w.key,
                            owner=owner, peer=peer)
                self._write_redirect(writer, seq, owner)
            else:
                self.counters.inc(obs_names.COORD_RESULTS_REJECTED)
                flight.note(obs_events.SESS_RESULT_REJECTED, key=w.key,
                            reason="misroute")
                logger.info("rejected result for %s (not this shard's "
                            "key)", w)
                self._write_upload_ack(writer, seq, proto.RESPONSE_REJECT,
                                       want, peer)
            return
        token = self.scheduler.claim(w)
        if token is None:
            # Stale or unknown lease: the body still has to be drained to
            # keep the frame stream in sync before the reject ack.
            await self._read(framing.read_exact(reader, body_len))
            self.counters.inc(obs_names.COORD_RESULTS_REJECTED)
            flight.note(obs_events.SESS_RESULT_REJECTED, key=w.key,
                        reason="stale_lease")
            logger.info("rejected result for %s (stale or unknown lease)", w)
            self._write_upload_ack(writer, seq, proto.RESPONSE_REJECT,
                                   want, peer)
            return
        try:
            body = await self._read(framing.read_exact(reader, body_len))
        except (ConnectionError, TimeoutError, asyncio.TimeoutError,
                framing.ProtocolError):
            self.scheduler.release_claim(w, token)
            self.counters.inc(obs_names.COORD_RESULTS_DROPPED)
            flight.note(obs_events.SESS_RESULT_DROPPED, key=w.key,
                        reason="upload_stalled")
            logger.info("dropped result for %s (session upload stalled "
                        "or connection lost)", w)
            raise
        if codec == proto.WIRE_CODEC_RLE:
            t0 = time.monotonic()
            try:
                # Decode off the loop: np.repeat of 16 Mi pixels is
                # milliseconds of pure CPU the other sessions shouldn't
                # stall behind.  The decoder itself rejects bombs — the
                # run counts must sum to exactly CHUNK_PIXELS before
                # anything is allocated at that size.
                pixels = await asyncio.to_thread(
                    self._rle.decode, body, CHUNK_PIXELS)
            except ValueError as e:
                self.scheduler.release_claim(w, token)
                self.counters.inc(obs_names.COORD_RESULTS_DROPPED)
                flight.note(obs_events.SESS_RESULT_DROPPED, key=w.key,
                            reason="bad_rle")
                raise framing.ProtocolError(
                    f"bad RLE body for {w}: {e}") from None
            self.registry.observe(obs_names.HIST_COORD_DECODE_SECONDS,
                                  time.monotonic() - t0)
            self.counters.inc(obs_names.WIRE_COMPRESSED_BYTES, body_len)
        else:
            pixels = np.frombuffer(body, dtype=np.uint8)
            self.counters.inc(obs_names.WIRE_RAW_BYTES, body_len)
        if not self.scheduler.finish_claim(w, token):
            self.counters.inc(obs_names.COORD_RESULTS_DROPPED)
            flight.note(obs_events.SESS_RESULT_DROPPED, key=w.key,
                        reason="expired_mid_upload")
            logger.info("dropped result for %s (lease expired mid-upload)", w)
            self._write_upload_ack(writer, seq, proto.RESPONSE_REJECT,
                                   want, peer)
            return
        self.counters.inc(obs_names.COORD_RESULTS_ACCEPTED)
        self.registry.observe(obs_names.HIST_ACCEPT_SECONDS,
                              time.monotonic() - t_accept)
        self.trace.record("result_received", w.key, worker=peer)
        chunk = Chunk(w.level, w.index_real, w.index_imag, pixels)
        faults.hit("coord.between_accept_and_persist")
        await self._enqueue_persist(w, chunk)
        self._write_upload_ack(writer, seq, proto.RESPONSE_ACCEPT, want, peer)

    async def _session_spans(self, reader: asyncio.StreamReader,
                             length: int) -> None:
        worker_id, sync_data, span_data = await self._read_span_report(
            reader, declared=length)
        self._ingest_span_report(worker_id, sync_data, span_data)

    async def _handle_batch_response(self, reader: asyncio.StreamReader,
                                     writer: asyncio.StreamWriter) -> None:
        # An honest worker's batch came from acquire_batch, which never
        # grants more than MAX_BATCH — a larger count is a corrupt or
        # hostile frame, and pretending to iterate it would pin this
        # handler on a stream that can only end in EOF.
        count = proto.validate_count(
            await self._read(framing.read_u32(reader)), MAX_BATCH,
            "batch-response count")
        for _ in range(count):
            await self._ingest_one(reader, writer)

    async def _ingest_one(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        t_accept = time.monotonic()
        w = Workload.from_wire(
            await self._read(framing.read_exact(reader, WORKLOAD_WIRE_SIZE)))
        # Claim (consume) the lease at echo time, as the reference does
        # (Distributer.cs:404): a concurrent second submission for the same
        # tile is rejected instead of double-matching while this payload is
        # still in flight.
        token = self.scheduler.claim(w)
        if token is None:
            framing.write_byte(writer, proto.RESPONSE_REJECT)
            await writer.drain()
            self.counters.inc(obs_names.COORD_RESULTS_REJECTED)
            flight.note(obs_events.SESS_RESULT_REJECTED, key=w.key,
                        reason="stale_lease")
            logger.info("rejected result for %s (stale or unknown lease)", w)
            return
        try:
            # The accept notification lives inside the claim's guarded
            # region: a peer that vanishes between accept and payload
            # must release the claim, not wait out its expiry.
            framing.write_byte(writer, proto.RESPONSE_ACCEPT)
            await writer.drain()
            data = await self._read(framing.read_exact(reader, CHUNK_PIXELS))
        except (ConnectionError, TimeoutError, asyncio.TimeoutError,
                framing.ProtocolError):
            # read_exact raises ConnectionError on a clean close,
            # ProtocolError on a truncated payload; a stalled upload
            # raises TimeoutError.  Either way the payload never
            # arrived: make the tile grantable again now rather than
            # waiting out the claim's expiry.
            self.scheduler.release_claim(w, token)
            self.counters.inc(obs_names.COORD_RESULTS_DROPPED)
            flight.note(obs_events.SESS_RESULT_DROPPED, key=w.key,
                        reason="upload_stalled")
            logger.info("dropped result for %s (upload stalled or "
                        "connection lost)", w)
            raise
        if not self.scheduler.finish_claim(w, token):
            # Claim expired between accept and payload arrival; drop.
            self.counters.inc(obs_names.COORD_RESULTS_DROPPED)
            flight.note(obs_events.SESS_RESULT_DROPPED, key=w.key,
                        reason="expired_mid_upload")
            logger.info("dropped result for %s (lease expired mid-upload)", w)
            return
        self.counters.inc(obs_names.COORD_RESULTS_ACCEPTED)
        # Accept latency: echo arrival -> payload fully landed (the
        # upload leg of the pipeline as the coordinator sees it).
        self.registry.observe(obs_names.HIST_ACCEPT_SECONDS,
                              time.monotonic() - t_accept)
        self.trace.record("result_received", w.key, worker=_peer_id(writer))
        chunk = Chunk(w.level, w.index_real, w.index_imag,
                      np.frombuffer(data, dtype=np.uint8))
        # Crashpoint: the tile is complete in the scheduler but its save
        # has not reached the writer queue — the widest window where only
        # the pending-save exclusion keeps a checkpoint honest.
        faults.hit("coord.between_accept_and_persist")
        await self._enqueue_persist(w, chunk)

    def pending_save_keys(self) -> set[Key]:
        """Keys whose persistence is in flight (checkpoint exclusion)."""
        return set(self._pending_saves)

    async def _enqueue_persist(self, w: Workload, chunk: Chunk) -> None:
        """Hand an accepted tile to the group-commit drainer.  Lazily
        starts the loop so handler-level tests that never call start()
        still persist; blocks (backpressuring the session) when the
        writer queue is full."""
        self._pending_saves.add(w.key)
        if self._persist_task is None or self._persist_task.done():
            self._start_persist_loop()
        await self._persist_queue.put((w, chunk))

    async def _persist_loop(self) -> None:
        """Drain the writer queue: block for one tile, then greedily
        scoop whatever else is backed up (bounded by the flush size) so
        a busy farm amortises blob writes and index appends into one
        ``put_many`` flush per wake-up."""
        while True:
            item = await self._persist_queue.get()
            if item is None:
                return
            batch = [item]
            while len(batch) < self.persist_flush_tiles:
                try:
                    nxt = self._persist_queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is None:
                    # Sentinel drawn mid-drain: flush this batch, then
                    # let the next wake-up see the sentinel and exit.
                    self._persist_queue.put_nowait(None)
                    break
                batch.append(nxt)
            await self._persist_batch(batch)

    async def _persist_batch(self, batch) -> None:
        try:
            t0 = time.monotonic()
            await asyncio.to_thread(self.store.put_many,
                                    [chunk for _, chunk in batch])
            dt = time.monotonic() - t0
            self.counters.inc(obs_names.COORD_PERSIST_US, int(dt * 1e6))
            self.registry.observe(obs_names.HIST_PERSIST_SECONDS, dt)
            self.counters.inc(obs_names.COORD_CHUNKS_SAVED, len(batch))
            flight.note(obs_events.STORE_FLUSH, tiles=len(batch),
                        seconds=round(dt, 6))
            for _, chunk in batch:
                self.trace.record("persisted", chunk.key)
                if self.on_chunk_saved is not None:
                    try:
                        self.on_chunk_saved(chunk.key)
                    except Exception:
                        # A notification bug must not reopen a saved tile.
                        logger.exception("on_chunk_saved callback failed")
            logger.info("saved %d chunks in one flush", len(batch))
        except Exception:
            # The batch's bytes are lost; reopen the tiles so they are
            # granted again rather than leaving silent holes in a
            # "complete" run.
            logger.exception("failed to save batch of %d chunks; "
                             "reopening tiles", len(batch))
            self.counters.inc("save_errors", len(batch))
            flight.note(obs_events.STORE_SAVE_ERROR, tiles=len(batch))
            for w, _ in batch:
                flight.note(obs_events.STORE_REOPEN, key=w.key)
                self.scheduler.reopen(w)
        finally:
            # Durable (or reopened) either way: checkpoints may include —
            # or, on reopen, re-grant — these tiles from now on.
            for w, _ in batch:
                self._pending_saves.discard(w.key)
