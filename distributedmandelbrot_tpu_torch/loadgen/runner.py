"""The open-loop runner and its timebases.

Open loop means the schedule is law: every arrival is issued at its
scheduled instant whether or not earlier requests have completed.  The
runner never awaits a request before issuing the next — it spawns a task
per arrival and only gathers them at the end — so a slow or collapsing
server sees the *population's* rate, and queue growth shows up as
latency instead of being silently absorbed by client backpressure.

Time is abstracted behind a two-method timebase (``now()`` /
``sleep(dt)``) so the same runner drives both modes:

- :class:`RealTimebase` — ``time.monotonic`` + ``asyncio.sleep``, for
  storming an actual gateway;
- :class:`VirtualTimebase` — a heap of pending sleepers advanced by an
  explicit :meth:`~VirtualTimebase.drain` pump.  Tests run a "10 second"
  storm in milliseconds, with *exact* issue times: the pump only moves
  the clock when every runnable task has quiesced, so there is no real
  scheduler jitter to blur assertions.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import Awaitable, Callable, Optional

from distributedmandelbrot_tpu_torch.loadgen.recorder import (OUTCOME_ERROR,
                                                        StormRecorder)
from distributedmandelbrot_tpu_torch.loadgen.schedule import Request

# request callable: (level, index_real, index_imag) -> (outcome, nbytes)
RequestFn = Callable[[int, int, int], Awaitable[tuple[str, int]]]


class RealTimebase:
    """Wall-clock timebase (monotonic)."""

    def now(self) -> float:
        return time.monotonic()

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(dt)


class VirtualTimebase:
    """Deterministic manual clock for asyncio tests.

    ``sleep`` parks the caller on a heap keyed by wake time;
    :meth:`drain` repeatedly lets every runnable task make progress
    (a burst of zero-sleeps), then pops the earliest sleeper, jumps the
    clock to its wake time, and releases it.  Virtual time therefore
    advances only when nothing else can run — the discrete-event
    simulation contract.
    """

    # How many zero-sleep yields count as "everything runnable has run".
    # Each yield cycles asyncio's entire ready queue once; chained
    # awaits (task -> gather -> request fn) need a few cycles to settle.
    _YIELDS = 50

    def __init__(self, *, max_idle_rounds: int = 1000) -> None:
        # Grace before a pending target task with no sleepers is called
        # a deadlock.  The default suits pure-virtual tests; raise it
        # when real IO (sockets, threads) completes work off the virtual
        # clock and merely needs wall time — pair that with a bounded
        # per-request timeout so a true hang still terminates.
        self.max_idle_rounds = max_idle_rounds
        self._now = 0.0
        self._seq = 0
        self._sleepers: list[tuple[float, int, asyncio.Future]] = []

    def now(self) -> float:
        return self._now

    async def sleep(self, dt: float) -> None:
        if dt <= 0:
            await asyncio.sleep(0)
            return
        future = asyncio.get_running_loop().create_future()
        heapq.heappush(self._sleepers, (self._now + dt, self._seq, future))
        self._seq += 1
        await future

    async def _quiesce(self) -> None:
        for _ in range(self._YIELDS):
            await asyncio.sleep(0)

    async def drain(self, until: Optional[asyncio.Task] = None) -> None:
        """Pump virtual time until ``until`` completes (or, with no
        target task, until no sleeper remains)."""
        idle_rounds = 0
        while True:
            await self._quiesce()
            if until is not None and until.done():
                return
            if until is None and not self._sleepers:
                return
            if not self._sleepers:
                # Target task pending but nothing waiting on the clock:
                # it must be about to finish or about to sleep.  Give it
                # bounded grace, then call the deadlock.
                idle_rounds += 1
                if idle_rounds > self.max_idle_rounds:
                    raise RuntimeError(
                        "virtual clock deadlock: task pending, no sleepers")
                continue
            idle_rounds = 0
            wake, _, future = heapq.heappop(self._sleepers)
            self._now = max(self._now, wake)
            if not future.done():
                future.set_result(None)


class OpenLoopRunner:
    """Issue a schedule open-loop against an async request function.

    ``max_inflight`` is a *safety rail*, not backpressure: crossing it
    bumps ``loadgen_client_saturated`` (so the report can flag a
    generator-bound run) and, only at the hard ``2x`` ceiling, skips
    issuing — recorded as an error, never silently dropped.
    """

    def __init__(self, schedule: list[Request], request: RequestFn,
                 recorder: StormRecorder, *,
                 timebase: Optional[RealTimebase | VirtualTimebase] = None,
                 max_inflight: int = 10_000) -> None:
        self.schedule = schedule
        self.request = request
        self.recorder = recorder
        self.timebase = timebase if timebase is not None else RealTimebase()
        self.max_inflight = max_inflight
        self._inflight = 0
        self.issue_times: list[float] = []  # run-relative, for the tests

    async def run(self) -> float:
        """Play the schedule; returns the run's duration in timebase
        seconds (last completion - start)."""
        start = self.timebase.now()
        tasks: list[asyncio.Task] = []
        for item in self.schedule:
            delay = (start + item.time) - self.timebase.now()
            if delay > 0:
                await self.timebase.sleep(delay)
            self.recorder.issued()
            self.issue_times.append(self.timebase.now() - start)
            if self._inflight >= self.max_inflight:
                self.recorder.saturated()
                if self._inflight >= 2 * self.max_inflight:
                    self.recorder.record(item.phase, OUTCOME_ERROR, 0.0)
                    continue
            self._inflight += 1
            tasks.append(asyncio.ensure_future(self._issue(item)))
        if tasks:
            await asyncio.gather(*tasks)
        return self.timebase.now() - start

    async def _issue(self, item: Request) -> None:
        t0 = self.timebase.now()
        try:
            outcome, nbytes = await self.request(
                item.level, item.index_real, item.index_imag)
        except asyncio.CancelledError:
            raise
        except Exception:
            outcome, nbytes = OUTCOME_ERROR, 0
        finally:
            self._inflight -= 1
        self.recorder.record(item.phase, outcome,
                             self.timebase.now() - t0, nbytes)
