"""Asyncio HTTP exporter: /metrics, /varz, /healthz on loopback.

A hand-rolled ~100-line HTTP/1.0 responder, not a web framework: the
package's only dependencies are numpy and jax, the endpoint serves three
GET routes to trusted scrapers, and the coordinator already owns an
asyncio loop for its two wire services — the exporter is just a third
``asyncio.start_server`` beside them (same lifecycle pattern as the
gateway, ephemeral port by default).

- ``/metrics`` — Prometheus text exposition format v0.0.4 (``# HELP`` /
  ``# TYPE``, ``_bucket{le=...}`` / ``_sum`` / ``_count`` for
  histograms), rendered by :func:`render_prometheus` so tests and
  ``tools/check_metrics.py`` can validate the text without a socket;
- ``/varz`` — JSON snapshot: every instrument, histogram percentiles,
  plus whatever the embedding coordinator contributes through the
  ``varz_extra`` callback (scheduler frontier depth, trace summaries);
- ``/healthz`` — liveness probe, ``ok``;
- ``/trace.json`` — the merged coordinator + worker timeline in Chrome
  trace-event JSON (obs/chrome.py), loadable at ui.perfetto.dev;
- ``/timeseries?name=&window=`` — ring-buffer history from the attached
  :class:`~distributedmandelbrot_tpu_torch.obs.timeseries.TimeseriesSampler`
  (counter rates, gauge traces, histogram percentile series);
- ``/fleet`` — the merged fleet snapshot from an attached
  :class:`~distributedmandelbrot_tpu_torch.obs.fleet.FleetAggregator`;
- ``/flight?window=`` — live flight-recorder ring snapshot from the
  attached :class:`~distributedmandelbrot_tpu_torch.obs.flight.FlightRecorder`
  (the same header + events document the crash dumps carry);
- ``POST /checkpoint`` — on-demand durability checkpoint (admin-only
  write route, present iff the embedding coordinator supplies
  ``checkpoint_cb``; `dmtpu admin checkpoint` posts here).
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import re
import threading
import urllib.parse
from typing import Callable, Optional

from distributedmandelbrot_tpu_torch.obs.chrome import render_chrome_trace
from distributedmandelbrot_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                                   Registry)
from distributedmandelbrot_tpu_torch.obs.spans import SpanStore, critical_path
from distributedmandelbrot_tpu_torch.obs.trace import TraceLog

logger = logging.getLogger("dmtpu.exporter")

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_READ_TIMEOUT = 10.0


def _sanitize(name: str) -> str:
    """Exposition-legal metric name (ad-hoc shim counters may carry
    characters Prometheus grammar forbids)."""
    if _NAME_OK.match(name):
        return name
    cleaned = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not re.match(r"[a-zA-Z_:]", cleaned):
        cleaned = "_" + cleaned
    return cleaned


def _fmt(value: float) -> str:
    """Exposition float: integers without the trailing .0, specials in
    Prometheus spelling."""
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value) == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_str(labels, extra: str = "") -> str:
    parts = [f'{_sanitize(k)}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(registry: Registry) -> str:
    """The full registry in text exposition format v0.0.4."""
    lines: list[str] = []
    for name, kind, help_text, children in registry.collect():
        name = _sanitize(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for inst in children:
            if isinstance(inst, Counter):
                lines.append(f"{name}{_labels_str(inst.labels)} "
                             f"{_fmt(inst.value)}")
            elif isinstance(inst, Gauge):
                lines.append(f"{name}{_labels_str(inst.labels)} "
                             f"{_fmt(inst.read())}")
            elif isinstance(inst, Histogram):
                counts, total, count = inst.state()
                cum = 0
                for bound, c in zip(inst.bounds, counts):
                    cum += c
                    le = 'le="%s"' % _fmt(bound)
                    lines.append(
                        f"{name}_bucket{_labels_str(inst.labels, le)}"
                        f" {cum}")
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_labels_str(inst.labels, inf)} {count}")
                lines.append(f"{name}_sum{_labels_str(inst.labels)} "
                             f"{_fmt(total)}")
                lines.append(f"{name}_count{_labels_str(inst.labels)} "
                             f"{count}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """HTTP telemetry endpoint beside the coordinator's wire services.

    ``varz_extra`` (optional callable -> dict) runs on the exporter's
    event loop per /varz request, so a coordinator can report live
    scheduler state without locking; ``trace`` adds span/skew summaries.
    """

    def __init__(self, registry: Registry, *,
                 trace: Optional[TraceLog] = None,
                 spans: Optional[SpanStore] = None,
                 varz_extra: Optional[Callable[[], dict]] = None,
                 checkpoint_cb: Optional[Callable[[], "asyncio.Future"]]
                 = None,
                 sampler=None, fleet=None, flight=None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        self.trace = trace
        self.spans = spans
        self.varz_extra = varz_extra
        # Optional TimeseriesSampler (/timeseries), FleetAggregator
        # (/fleet) and FlightRecorder (/flight) — duck-typed so the
        # exporter needs none of those modules.
        self.sampler = sampler
        self.fleet = fleet
        self.flight = flight
        # Async callable -> stats dict; enables the POST /checkpoint
        # admin route (the coordinator wires its RecoveryManager here).
        self.checkpoint_cb = checkpoint_cb
        self.host = host
        self.port = port
        self._server: Optional[asyncio.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("metrics exporter on http://%s:%d (/metrics /varz "
                    "/healthz /trace.json)", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- request handling --------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(),
                                             _READ_TIMEOUT)
            parts = request.decode("latin-1").split()
            if len(parts) < 2:
                return
            method = parts[0].upper()
            path, _, query = parts[1].partition("?")
            # Drain headers; every response closes the connection, so
            # nothing after the header block matters.
            while True:
                line = await asyncio.wait_for(reader.readline(),
                                              _READ_TIMEOUT)
                if line in (b"\r\n", b"\n", b""):
                    break
            if method == "POST" and path == "/checkpoint" \
                    and self.checkpoint_cb is not None:
                # The route takes no arguments; any request body goes
                # unread (HTTP/1.0 — the response closes the connection).
                try:
                    stats = await self.checkpoint_cb()
                    body = (json.dumps(stats, sort_keys=True) + "\n").encode()
                    self._respond(writer, 200, "application/json", body)
                except Exception as e:
                    logger.exception("on-demand checkpoint failed")
                    self._respond(writer, 500,
                                  "text/plain; charset=utf-8",
                                  f"checkpoint failed: {e}\n".encode())
            elif method not in ("GET", "HEAD"):
                self._respond(writer, 405, "text/plain; charset=utf-8",
                              b"method not allowed\n")
            elif path == "/metrics":
                body = render_prometheus(self.registry).encode()
                self._respond(writer, 200,
                              "text/plain; version=0.0.4; charset=utf-8",
                              body, head=method == "HEAD")
            elif path == "/varz":
                body = (json.dumps(self._varz(), indent=1, sort_keys=True)
                        + "\n").encode()
                self._respond(writer, 200, "application/json", body,
                              head=method == "HEAD")
            elif path == "/healthz":
                self._respond(writer, 200, "text/plain; charset=utf-8",
                              b"ok\n", head=method == "HEAD")
            elif path == "/trace.json":
                # Merged farm timeline in Chrome trace-event format —
                # what `dmtpu trace` fetches and ui.perfetto.dev loads.
                body = (json.dumps(render_chrome_trace(self.trace,
                                                       self.spans))
                        + "\n").encode()
                self._respond(writer, 200, "application/json", body,
                              head=method == "HEAD")
            elif path == "/timeseries" and self.sampler is not None:
                params = urllib.parse.parse_qs(query)
                name = (params.get("name") or [None])[0]
                window = None
                try:
                    raw = (params.get("window") or [None])[0]
                    if raw is not None:
                        window = max(0.0, float(raw))
                except ValueError:
                    window = None  # garbage window -> whole history
                doc = self.sampler.to_json(name, window=window)
                status = 404 if "error" in doc else 200
                body = (json.dumps(doc, sort_keys=True) + "\n").encode()
                self._respond(writer, status, "application/json", body,
                              head=method == "HEAD")
            elif path == "/flight" and self.flight is not None:
                params = urllib.parse.parse_qs(query)
                window = None
                try:
                    raw = (params.get("window") or [None])[0]
                    if raw is not None:
                        window = max(0.0, float(raw))
                except ValueError:
                    window = None  # garbage window -> whole ring
                doc = self.flight.snapshot(window=window)
                body = (json.dumps(doc, sort_keys=True) + "\n").encode()
                self._respond(writer, 200, "application/json", body,
                              head=method == "HEAD")
            elif path == "/fleet" and self.fleet is not None:
                body = (json.dumps(self.fleet.snapshot(), sort_keys=True)
                        + "\n").encode()
                self._respond(writer, 200, "application/json", body,
                              head=method == "HEAD")
            else:
                self._respond(writer, 404, "text/plain; charset=utf-8",
                              b"not found (try /metrics /varz /healthz "
                              b"/trace.json /timeseries /fleet /flight)\n")
            await writer.drain()
        except (ConnectionError, TimeoutError, asyncio.TimeoutError,
                asyncio.CancelledError):
            pass
        except Exception:
            logger.exception("exporter request failed")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    def _respond(self, writer: asyncio.StreamWriter, status: int,
                 ctype: str, body: bytes, *, head: bool = False) -> None:
        reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed",
                  500: "Internal Server Error"}.get(status, "?")
        writer.write((f"HTTP/1.0 {status} {reason}\r\n"
                      f"Content-Type: {ctype}\r\n"
                      f"Content-Length: {len(body)}\r\n"
                      f"Connection: close\r\n\r\n").encode())
        if not head:
            writer.write(body)

    def _varz(self) -> dict:
        out = self.registry.snapshot()
        if self.trace is not None:
            spans = self.trace.spans()
            reported = (self.spans.compute_seconds_by_key()
                        if self.spans is not None else None)
            out["trace"] = {
                "recorded": self.trace.recorded,
                "dropped": self.trace.dropped,
                "spans": len(spans),
                "complete_spans": sum(1 for s in spans if s["complete"]),
                "worker_skew": self.trace.worker_skew(reported=reported),
            }
            if self.spans is not None:
                out["trace"]["span_store"] = {
                    "ingested": self.spans.ingested,
                    "workers": len(self.spans.workers()),
                    "unaligned": self.spans.unaligned,
                }
                out["farm_trace"] = critical_path(spans, self.spans)
        if self.varz_extra is not None:
            try:
                out.update(self.varz_extra())
            except Exception:
                logger.exception("varz_extra callback failed")
        return out


class ExporterThread:
    """A MetricsExporter on its own thread-owned loop, for processes
    with no asyncio loop of their own (the synchronous worker, bench
    harnesses).  start() blocks until the port is bound so the caller
    can immediately advertise it."""

    def __init__(self, registry: Registry, *,
                 varz_extra: Optional[Callable[[], dict]] = None,
                 sampler=None, fleet=None, flight=None,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.registry = registry
        self.varz_extra = varz_extra
        self.sampler = sampler
        self.fleet = fleet
        self.flight = flight
        self.host = host
        self.port = port
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_event: Optional[asyncio.Event] = None
        self._startup_error: Optional[BaseException] = None

    def start(self, timeout: float = 10.0) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="dmtpu-exporter",
                                        daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("exporter thread did not start in time")
        if self._startup_error is not None:
            raise RuntimeError("exporter thread failed to start") \
                from self._startup_error

    def stop(self, timeout: float = 10.0) -> None:
        if self._loop is not None and self._stop_event is not None:
            self._loop.call_soon_threadsafe(self._stop_event.set)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:
            self._startup_error = e
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        exporter = MetricsExporter(
            self.registry, varz_extra=self.varz_extra,
            sampler=self.sampler, fleet=self.fleet,
            flight=self.flight,
            host=self.host, port=self.port)
        await exporter.start()
        self.port = exporter.port
        sampler_task = (asyncio.create_task(self.sampler.run())
                        if self.sampler is not None else None)
        self._ready.set()
        try:
            await self._stop_event.wait()
        finally:
            if sampler_task is not None:
                sampler_task.cancel()
                try:
                    await sampler_task
                except asyncio.CancelledError:
                    pass
            await exporter.stop()
