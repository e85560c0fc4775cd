"""Asyncio chunk-serving server (the read-side coordinator service).

Wire-compatible with the reference DataServer (``DataServer.cs:82-224``):
12-byte query ``(level, index_real, index_imag)`` each uint32 LE, one status
byte (accept / reject-invalid / not-yet-available), and on accept a
uint32-length-prefixed codec payload.

Improvements: queries on one connection can repeat until EOF; the store's
payload LRU means a hot chunk is served without the decode + re-encode round
trip the reference performs per request (``DataServer.cs:204-221``); index
scanning runs in a thread pool off the event loop.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

logger = logging.getLogger("dmtpu.dataserver")


class DataServer:
    def __init__(self, store: ChunkStore, *, host: str = "0.0.0.0",
                 port: int = proto.DEFAULT_DATASERVER_PORT,
                 read_timeout: Optional[float] = proto.DEFAULT_READ_TIMEOUT,
                 counters: Optional[Counters] = None,
                 ring_slice=None) -> None:
        self.store = store
        self.host = host
        self.port = port
        self.read_timeout = read_timeout
        self.counters = counters if counters is not None else Counters()
        # Duck-typed control.ring.RingSlice (owns/owner_of/version).  A
        # sharded coordinator's store holds only its own slice, so a
        # query for a foreign key is answered with QUERY_REDIRECT + the
        # authoritative shard instead of a not-available that would
        # never resolve here.
        self.ring_slice = ring_slice
        self._server: Optional[asyncio.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("dataserver listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        peer = writer.get_extra_info("peername")
        try:
            while True:
                try:
                    # Same per-read deadline as the write side (reference:
                    # DataServer.cs:11): idle or stalled clients are closed
                    # and re-dial instead of pinning this task.
                    raw = await framing.read_exact(reader, proto.QUERY.size) \
                        if self.read_timeout is None else \
                        await asyncio.wait_for(
                            framing.read_exact(reader, proto.QUERY.size),
                            self.read_timeout)
                except (ConnectionError, TimeoutError,
                        asyncio.TimeoutError):
                    break  # clean EOF / idle close between queries
                level, index_real, index_imag = proto.QUERY.unpack(raw)
                await self._serve_query(writer, level, index_real, index_imag)
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        except framing.ProtocolError as e:
            # Malformed or hostile frame (e.g. a truncated query): drop
            # the connection, leave a trail, keep the accept loop alive.
            self.counters.inc(obs_names.COORD_FRAMES_REJECTED)
            logger.error("dropping %s: %s", peer, e)
        except Exception:
            logger.exception("error serving %s", peer)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _serve_query(self, writer: asyncio.StreamWriter, level: int,
                           index_real: int, index_imag: int) -> None:
        if not proto.query_in_range(level, index_real, index_imag):
            framing.write_byte(writer, proto.QUERY_REJECT)
            self.counters.inc("queries_rejected")
            logger.info("rejected invalid query (%d,%d,%d)",
                        level, index_real, index_imag)
            return
        key = (level, index_real, index_imag)
        if self.ring_slice is not None and not self.ring_slice.owns(key):
            framing.write_byte(writer, proto.QUERY_REDIRECT)
            writer.write(proto.REDIRECT.pack(self.ring_slice.owner_of(key),
                                             self.ring_slice.version))
            self.counters.inc(obs_names.DATASERVER_REDIRECTS)
            return
        payload = await asyncio.to_thread(
            self.store.load_payload, level, index_real, index_imag)
        if payload is None:
            framing.write_byte(writer, proto.QUERY_NOT_AVAILABLE)
            self.counters.inc("queries_unavailable")
            return
        framing.write_byte(writer, proto.QUERY_ACCEPT)
        framing.write_u32(writer, len(payload))
        writer.write(payload)
        self.counters.inc("queries_served")
        logger.info("served chunk (%d,%d,%d): %d bytes",
                    level, index_real, index_imag, len(payload))
