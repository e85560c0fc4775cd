"""Asyncio gateway client for the load generator.

One connection per request, deliberately: an open-loop arrival models an
independent viewer showing up, and a shared pipelined socket would
serialize responses behind the slowest head-of-line tile — the viewer
client's behaviour, which is exactly what the storm harness exists to
NOT do.  Requests round-robin across replica addresses, which is the
whole multi-replica read story: any replica can serve any tile because
they share one object store.

Speaks both gateway framings: the 12-byte raw query (escape-count codec
payload back) and the rendered-tile query (``GATEWAY_RENDER_MAGIC`` +
14-byte tail, palette PNG back).  Response length words pass through the
sanctioned bound check before sizing a read, same as the viewer client.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Optional

from distributedmandelbrot_tpu_torch.loadgen import recorder as rec
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto

_STATUS_OUTCOMES = {
    proto.QUERY_OVERLOADED: rec.OUTCOME_SHED,
    proto.QUERY_NOT_AVAILABLE: rec.OUTCOME_UNAVAILABLE,
    proto.QUERY_REJECT: rec.OUTCOME_UNAVAILABLE,
}


class GatewayDriver:
    """Async request function over one or more gateway replicas.

    Instances are callable with ``(level, index_real, index_imag)`` and
    return ``(outcome, payload_bytes)`` in the recorder's vocabulary, so
    a driver plugs straight into :class:`~distributedmandelbrot_tpu_torch.
    loadgen.runner.OpenLoopRunner`.
    """

    def __init__(self, addresses: list[tuple[str, int]], *,
                 render: bool = False,
                 colormap_id: int = proto.COLORMAP_JET,
                 timeout: Optional[float] = 30.0) -> None:
        if not addresses:
            raise ValueError("need at least one gateway address")
        self.addresses = list(addresses)
        self.render = render
        self.colormap_id = proto.validate_colormap(colormap_id)
        self.timeout = timeout
        self._rr = itertools.cycle(range(len(self.addresses)))

    async def __call__(self, level: int, index_real: int,
                       index_imag: int) -> tuple[str, int]:
        host, port = self.addresses[next(self._rr)]
        try:
            exchange = self._exchange(host, port, level, index_real,
                                      index_imag)
            if self.timeout is not None:
                return await asyncio.wait_for(exchange, self.timeout)
            return await exchange
        except (ConnectionError, OSError, TimeoutError,
                asyncio.TimeoutError, framing.ProtocolError):
            return rec.OUTCOME_ERROR, 0

    async def _exchange(self, host: str, port: int, level: int,
                        index_real: int, index_imag: int) -> tuple[str, int]:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            self._send_query(writer, level, index_real, index_imag)
            await writer.drain()
            status = await framing.read_byte(reader)
            outcome = _STATUS_OUTCOMES.get(status)
            if outcome is not None:
                return outcome, 0
            if status != proto.QUERY_ACCEPT:
                raise framing.ProtocolError(
                    f"unknown query status {status:#x}")
            length = proto.validate_payload_length(
                await framing.read_u32(reader))
            payload = await framing.read_exact(reader, length)
            return rec.OUTCOME_OK, len(payload)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _send_query(self, writer: asyncio.StreamWriter, level: int,
                    index_real: int, index_imag: int) -> None:
        if self.render:
            framing.write_u32(writer, proto.GATEWAY_RENDER_MAGIC)
            writer.write(proto.RENDER_QUERY_TAIL.pack(
                level, index_real, index_imag, self.colormap_id, 0))
        else:
            writer.write(proto.QUERY.pack(level, index_real, index_imag))
