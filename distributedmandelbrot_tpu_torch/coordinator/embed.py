"""Run a Coordinator on a background thread — programmatic embedding.

The process-level entry point is the CLI (``dmtpu coordinator``); this is
the in-process form used by the benchmark farm loop and the test suite:
a coordinator on ephemeral loopback ports with a thread-owned asyncio
loop, driven from synchronous code through the worker/viewer clients.
"""

from __future__ import annotations

import asyncio
import threading
import time

from distributedmandelbrot_tpu_torch.coordinator.app import Coordinator


_UNSET = object()  # "use Coordinator's default" — None must mean "disable"


class EmbeddedCoordinator:
    """Context manager owning a Coordinator in a daemon thread."""

    def __init__(self, data_dir_parent: str, level_settings, *,
                 lease_timeout: float = 3600.0, sweep_period: float = 300.0,
                 read_timeout: float | None = _UNSET, clock=None,
                 gateway: bool = True, exporter: bool = True,
                 checkpoint_period: float = 0.0,
                 **gateway_kwargs) -> None:
        self._ready = threading.Event()
        self._stop: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self.coordinator: Coordinator | None = None
        self._kwargs = dict(data_dir_parent=data_dir_parent,
                            host="127.0.0.1", distributer_port=0,
                            dataserver_port=0, lease_timeout=lease_timeout,
                            sweep_period=sweep_period, clock=clock,
                            checkpoint_period=checkpoint_period)
        # The embedded form serves tests and benches, so the gateway is on
        # by default (ephemeral port).  gateway_kwargs passes the admission
        # knobs straight through (gateway_max_queue_depth, gateway_rate,
        # gateway_burst, gateway_cache_tiles, gateway_render_tiles,
        # ondemand_deadline).
        if gateway:
            self._kwargs["gateway_port"] = 0
        # The metrics exporter rides along the same way: on by default at
        # an ephemeral loopback port, so tests and benches can scrape
        # /metrics and /varz without reserving a well-known port.
        if exporter:
            self._kwargs["exporter_port"] = 0
        self._kwargs.update(gateway_kwargs)
        if read_timeout is not _UNSET:
            self._kwargs["read_timeout"] = read_timeout
        self._level_settings = level_settings
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._error: BaseException | None = None

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:
            self._error = e
            self._ready.set()

    async def _main(self) -> None:
        self.coordinator = Coordinator(self._level_settings, **self._kwargs)
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        await self.coordinator.start()
        self._ready.set()
        await self._stop.wait()
        await self.coordinator.stop()

    def __enter__(self) -> "EmbeddedCoordinator":
        self._thread.start()
        if not self._ready.wait(timeout=30):
            raise TimeoutError("coordinator failed to start")
        if self._error is not None:
            raise self._error
        return self

    def __exit__(self, *exc) -> None:
        if self._loop is not None and self._stop is not None:
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout=30)

    @property
    def distributer_port(self) -> int:
        return self.coordinator.distributer_port

    @property
    def dataserver_port(self) -> int:
        return self.coordinator.dataserver_port

    @property
    def gateway_port(self) -> int | None:
        return self.coordinator.gateway_port

    @property
    def exporter_port(self) -> int | None:
        return self.coordinator.exporter_port

    @property
    def registry(self):
        return self.coordinator.registry

    @property
    def trace(self):
        return self.coordinator.trace

    @property
    def spans(self):
        return self.coordinator.spans

    @property
    def scheduler(self):
        return self.coordinator.scheduler

    @property
    def counters(self):
        return self.coordinator.counters

    @property
    def store(self):
        return self.coordinator.store

    def wait_saves_settled(self, expected_accepted: int = 1,
                           timeout: float = 30.0) -> None:
        """Block until >= ``expected_accepted`` results are ingested AND
        their async chunk saves have landed.  (Without an expected count
        there is a race: the client's upload may still be in the server's
        socket buffer when this is called.)"""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            accepted = self.coordinator.counters.get("results_accepted")
            saved = (self.coordinator.counters.get("chunks_saved")
                     + self.coordinator.counters.get("save_errors"))
            if accepted >= expected_accepted and saved >= accepted:
                return
            time.sleep(0.02)
        raise TimeoutError("chunk saves did not settle")
