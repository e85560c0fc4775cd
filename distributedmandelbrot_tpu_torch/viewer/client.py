"""Synchronous client for the DataServer protocol (viewer side).

Same exchange as the reference viewer (``DistributedMandelbrotViewer.py:
62-108``): 12-byte query, status byte, length-prefixed codec payload.
Decoding goes through the shared codec registry instead of a hand-rolled
RLE loop, and straight into numpy (the reference round-trips 16M pixels
through a Python list, ``DistributedMandelbrotViewer.py:102``).

Unlike the reference's connection-per-query, the client keeps one
connection open and pipelines queries over it (the server loops until EOF),
which matters on the stitch path — a level-L image is L^2 fetches.  A
broken connection is re-dialed transparently once per fetch.
"""

from __future__ import annotations

import enum
import socket
from typing import Optional

import numpy as np

from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class FetchStatus(enum.Enum):
    OK = "ok"
    NOT_AVAILABLE = "not_available"
    REJECTED = "rejected"
    # Gateway only: admission control shed the request — back off and retry.
    OVERLOADED = "overloaded"
    # Sharded gateway only: this shard does not own the key; the
    # authoritative shard is in :attr:`DataClient.last_redirect`.
    REDIRECTED = "redirected"


_STATUS_BY_BYTE = {
    proto.QUERY_NOT_AVAILABLE: FetchStatus.NOT_AVAILABLE,
    proto.QUERY_REJECT: FetchStatus.REJECTED,
    proto.QUERY_OVERLOADED: FetchStatus.OVERLOADED,
}


class DataClient:
    def __init__(self, host: str, port: int, *,
                 timeout: Optional[float] = 30.0) -> None:
        self.host = host
        self.port = port
        self.timeout = timeout
        # (shard, ring_version) from the most recent REDIRECTED reply.
        self.last_redirect: Optional[tuple[int, int]] = None
        # Session framing state: the id the gateway issued (0 = none
        # yet / reopen on next fetch) and the capability bits — the
        # request until the first exchange, the grant after it.
        self.session_id = 0
        self.session_caps = proto.SESSION_CAPS_MASK
        self._sock: Optional[socket.socket] = None

    def _connected(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=self.timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "DataClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fetch(self, level: int, index_real: int, index_imag: int
              ) -> tuple[Optional[np.ndarray], FetchStatus]:
        """Fetch one chunk's flat uint8 pixels; (None, status) if unavailable."""
        try:
            return self._fetch_once(level, index_real, index_imag)
        except (ConnectionError, OSError):
            # Stale persistent connection (server restart, idle teardown):
            # re-dial once and retry; a second failure propagates.
            self.close()
            return self._fetch_once(level, index_real, index_imag)

    def _fetch_once(self, level: int, index_real: int, index_imag: int
                    ) -> tuple[Optional[np.ndarray], FetchStatus]:
        sock = self._connected()
        framing.send_all(sock, proto.QUERY.pack(level, index_real, index_imag))
        return self._read_response(sock)

    def _read_redirect(self, sock: socket.socket) -> None:
        """Consume a QUERY_REDIRECT's fixed-size tail (no length prefix)
        and latch it in :attr:`last_redirect`."""
        shard, ring_version = proto.REDIRECT.unpack(
            framing.recv_exact(sock, proto.REDIRECT_WIRE_SIZE))
        self.last_redirect = (shard, ring_version)

    def _read_response(self, sock: socket.socket
                       ) -> tuple[Optional[np.ndarray], FetchStatus]:
        # The model pairs this reader with the dataserver, which never
        # sheds, so the QUERY_OVERLOADED arm is dead in every explored
        # configuration.  The arm is still live in production: the
        # gateway's plain-query path answers the same framing and DOES
        # send OVERLOADED under admission pressure, but it reads the
        # request as u32 + tail rather than one QUERY struct and so
        # sits outside the extracted exchange pairs.  Audited 2026-08.
        status = framing.recv_byte(sock)  # dmtpu: ignore[fsm-dead-arm]
        miss = _STATUS_BY_BYTE.get(status)
        if miss is not None:
            return None, miss
        if status == proto.QUERY_REDIRECT:
            self._read_redirect(sock)
            return None, FetchStatus.REDIRECTED
        if status != proto.QUERY_ACCEPT:
            raise framing.ProtocolError(f"unknown query status {status:#x}")
        # The length word sizes an allocation: bound it before trusting it
        # (a hostile/corrupt server must not pick our buffer sizes).
        length = proto.validate_payload_length(framing.recv_u32(sock))
        payload = framing.recv_exact(sock, length)
        return Chunk.deserialize_data(payload), FetchStatus.OK

    def fetch_render(self, level: int, index_real: int, index_imag: int,
                     colormap_id: int = proto.COLORMAP_JET
                     ) -> tuple[Optional[bytes], FetchStatus]:
        """Fetch one tile server-rendered as a palette PNG (gateway
        extension): returns the PNG body bytes instead of escape counts.

        Decode with :func:`distributedmandelbrot_tpu_torch.serve.render.
        decode_rendered_png` (or any PNG library) — the bytes are pinned
        bit-identical to rendering the raw tile client-side.  Gateway
        only, like :meth:`fetch_many`.
        """
        try:
            return self._fetch_render_once(level, index_real, index_imag,
                                           colormap_id)
        except (ConnectionError, OSError):
            self.close()
            return self._fetch_render_once(level, index_real, index_imag,
                                           colormap_id)

    def _fetch_render_once(self, level: int, index_real: int,
                           index_imag: int, colormap_id: int
                           ) -> tuple[Optional[bytes], FetchStatus]:
        sock = self._connected()
        framing.send_u32(sock, proto.GATEWAY_RENDER_MAGIC)
        return self._render_exchange(sock, level, index_real, index_imag,
                                     colormap_id)

    def _render_exchange(self, sock: socket.socket, level: int,
                         index_real: int, index_imag: int, colormap_id: int
                         ) -> tuple[Optional[bytes], FetchStatus]:
        """The post-magic exchange: 14-byte tail out, status (+ PNG) in.
        (Split from :meth:`_fetch_render_once` so it mirrors the server's
        post-magic handler frame for frame.)"""
        framing.send_all(sock, proto.RENDER_QUERY_TAIL.pack(
            level, index_real, index_imag, colormap_id, 0))
        status = framing.recv_byte(sock)
        miss = _STATUS_BY_BYTE.get(status)
        if miss is not None:
            return None, miss
        if status == proto.QUERY_REDIRECT:
            self._read_redirect(sock)
            return None, FetchStatus.REDIRECTED
        if status != proto.QUERY_ACCEPT:
            raise framing.ProtocolError(f"unknown query status {status:#x}")
        length = proto.validate_payload_length(framing.recv_u32(sock))
        return framing.recv_exact(sock, length), FetchStatus.OK

    def open_session(self, caps: int = proto.SESSION_CAPS_MASK) -> None:
        """Arm the session framing: the next :meth:`fetch_session` opens
        a session requesting ``caps``; later fetches ride the issued id.

        :attr:`session_id` / :attr:`session_caps` expose what the
        gateway granted after the first exchange.  Gateway only — a
        legacy DataServer drops the connection on the magic, which
        surfaces as the usual transport error.
        """
        self.session_id = 0
        self.session_caps = caps

    def fetch_session(self, level: int, index_real: int, index_imag: int,
                      colormap_id: int = proto.COLORMAP_JET
                      ) -> tuple[Optional[bytes], FetchStatus]:
        """Session-scoped render fetch: like :meth:`fetch_render`, but
        the query carries the session id + viewport hint so the gateway
        tracks the trajectory, prefetches ahead of the pan, and may
        serve a cold tile as a fast low-iter first paint (refined in
        the background).  Call :meth:`open_session` once first.

        A soft ``REJECTED`` with the reply id 0 means the session
        expired server-side; the client resets to reopen on the next
        call, so one retry re-establishes the session.
        """
        try:
            return self._fetch_session_once(level, index_real, index_imag,
                                            colormap_id)
        except (ConnectionError, OSError):
            self.close()
            return self._fetch_session_once(level, index_real, index_imag,
                                            colormap_id)

    def _fetch_session_once(self, level: int, index_real: int,
                            index_imag: int, colormap_id: int
                            ) -> tuple[Optional[bytes], FetchStatus]:
        sock = self._connected()
        framing.send_u32(sock, proto.GATEWAY_SESSION_MAGIC)
        flags = self.session_caps if self.session_id == 0 else 0
        return self._session_exchange(sock, self.session_id, level,
                                      index_real, index_imag, colormap_id,
                                      flags)

    def _session_exchange(self, sock: socket.socket, session_id: int,
                          level: int, index_real: int, index_imag: int,
                          colormap_id: int, flags: int
                          ) -> tuple[Optional[bytes], FetchStatus]:
        """The post-magic exchange: 22-byte tail out, reply header +
        status (+ PNG) in.  (Split from :meth:`_fetch_session_once` so it
        mirrors the server's post-magic handler frame for frame.)"""
        framing.send_all(sock, proto.SESSION_QUERY_TAIL.pack(
            session_id, level, index_real, index_imag, colormap_id, flags))
        sid, caps = proto.SESSION_REPLY.unpack(
            framing.recv_exact(sock, proto.SESSION_REPLY_WIRE_SIZE))
        if sid != 0:
            self.session_id = sid
            self.session_caps = caps
        else:
            # Unknown/expired session: reopen (with the original
            # capability request) on the next fetch.
            self.session_id = 0
        status = framing.recv_byte(sock)
        miss = _STATUS_BY_BYTE.get(status)
        if miss is not None:
            return None, miss
        if status == proto.QUERY_REDIRECT:
            self._read_redirect(sock)
            return None, FetchStatus.REDIRECTED
        if status != proto.QUERY_ACCEPT:
            raise framing.ProtocolError(f"unknown query status {status:#x}")
        length = proto.validate_payload_length(framing.recv_u32(sock))
        return framing.recv_exact(sock, length), FetchStatus.OK

    def fetch_many(self, queries: list[tuple[int, int, int]]
                   ) -> list[tuple[Optional[np.ndarray], FetchStatus]]:
        """Batched fetch (gateway extension): one round trip for N tiles.

        Sends ``GATEWAY_BATCH_MAGIC, count, count x 12-byte queries`` and
        reads ``count`` standard responses back in request order.  Only
        gateways understand this framing — a legacy DataServer would read
        the magic as a (rejected) level — so point it at the gateway port.
        """
        if not queries:
            return []
        try:
            return self._fetch_many_once(queries)
        except (ConnectionError, OSError):
            self.close()
            return self._fetch_many_once(queries)

    def _fetch_many_once(self, queries: list[tuple[int, int, int]]
                         ) -> list[tuple[Optional[np.ndarray], FetchStatus]]:
        sock = self._connected()
        request = bytearray()
        request += proto.BATCH_HEADER.pack(proto.GATEWAY_BATCH_MAGIC,
                                           len(queries))
        for level, index_real, index_imag in queries:
            request += proto.QUERY.pack(level, index_real, index_imag)
        framing.send_all(sock, bytes(request))
        return [self._read_response(sock) for _ in queries]


class ShardedDataClient:
    """Ring-aware read fan-out: one :class:`DataClient` per shard.

    Consults the ring before dispatch, so the common case is a direct
    hit on the authoritative shard; a ``REDIRECTED`` reply (version
    skew: the serving fleet runs a different ring) is chased up to
    :data:`~distributedmandelbrot_tpu_torch.net.protocol.MAX_REDIRECT_HOPS`
    times before surfacing as ``REDIRECTED`` to the caller.

    ``ring`` is duck-typed (``shards``, ``owner_of(key)``) — hand it a
    ``control.ring.HashRing``.  ``use_gateway`` picks each shard's
    gateway port when the ring names one (falling back per shard to the
    legacy dataserver port, which never redirects — ring routing alone
    lands those queries on the right index).
    """

    def __init__(self, ring, *, timeout: Optional[float] = 30.0,
                 use_gateway: bool = True) -> None:
        self.ring = ring
        self.clients = []
        for s in ring.shards:
            port = s.gateway_port if use_gateway and s.gateway_port \
                else s.dataserver_port
            self.clients.append(DataClient(s.host, port, timeout=timeout))

    def close(self) -> None:
        for c in self.clients:
            c.close()

    def __enter__(self) -> "ShardedDataClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fetch(self, level: int, index_real: int, index_imag: int
              ) -> tuple[Optional[np.ndarray], FetchStatus]:
        return self._route(level, index_real, index_imag,
                           lambda c: c.fetch(level, index_real, index_imag))

    def fetch_render(self, level: int, index_real: int, index_imag: int,
                     colormap_id: int = proto.COLORMAP_JET
                     ) -> tuple[Optional[bytes], FetchStatus]:
        return self._route(
            level, index_real, index_imag,
            lambda c: c.fetch_render(level, index_real, index_imag,
                                     colormap_id))

    def _route(self, level: int, index_real: int, index_imag: int, op):
        shard = self.ring.owner_of((level, index_real, index_imag))
        result = None
        for _ in range(proto.MAX_REDIRECT_HOPS + 1):
            client = self.clients[shard]
            result = op(client)
            if result[1] is not FetchStatus.REDIRECTED:
                return result
            assert client.last_redirect is not None
            nxt = client.last_redirect[0]
            if not 0 <= nxt < len(self.clients) or nxt == shard:
                break  # split-brain ring: don't chase a self-redirect
            shard = nxt
        return result
