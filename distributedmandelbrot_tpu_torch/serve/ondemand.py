"""Compute-on-read: turn a gateway miss into a farm job and await the tile.

A cache/store miss for a tile the run is configured to render does not
have to be a 404: the scheduler already knows how to get it computed.  The
on-demand path pushes the tile to the FRONT of the scheduler's frontier
(:meth:`TileScheduler.prioritize`), so the next worker lease grants it
ahead of the background sweep, then awaits the resulting upload+persist
with a per-request deadline.

Arrival is signalled by the distributer's save path (the coordinator wires
:meth:`notify_saved` into it), with a slow poll of the store as a backstop
for tiles that land through any other route (a second coordinator on the
same data dir, an operator copying files in).

A miss for a tile the scheduler has already marked completed is usually a
save still in flight — but if the store stays empty past one poll window
the bytes are genuinely gone, and the tile is un-completed and re-granted
(:meth:`TileScheduler.refine`) rather than letting every reader time out.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING, Optional

from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.serve.cache import DecodedTileCache
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

if TYPE_CHECKING:  # import would cycle through coordinator.__init__ -> app
    from distributedmandelbrot_tpu_torch.coordinator.scheduler import TileScheduler

logger = logging.getLogger("dmtpu.serve")

Key = tuple[int, int, int]


class OnDemandComputer:
    """Awaitable miss->compute->serve bridge between gateway and scheduler."""

    def __init__(self, scheduler: "TileScheduler", cache: DecodedTileCache, *,
                 deadline: float = proto.DEFAULT_ONDEMAND_DEADLINE,
                 poll_interval: float = 1.0,
                 counters: Optional[Counters] = None) -> None:
        self.scheduler = scheduler
        self.cache = cache
        self.deadline = deadline
        self.poll_interval = poll_interval
        self.counters = counters if counters is not None else Counters()
        self._arrivals: dict[Key, asyncio.Event] = {}

    def notify_saved(self, key: Key) -> None:
        """Wake waiters for a freshly persisted tile (coordinator loop)."""
        event = self._arrivals.get(key)
        if event is not None:
            event.set()

    async def compute(self, workload: Workload):
        """Prioritize the tile and await its arrival; the promoted
        :class:`CachedTile` on success, None past the deadline.

        Callers coalesce upstream (``SingleFlight``), so one call here is
        one scheduler injection no matter how many clients are waiting.
        """
        loop = asyncio.get_running_loop()
        t_deadline = loop.time() + self.deadline
        key = workload.key
        event = self._arrivals.get(key)
        if event is None:
            event = self._arrivals[key] = asyncio.Event()
        self.counters.inc("ondemand_requests")
        # Prioritize returns False for out-of-grid keys and for tiles the
        # scheduler already recorded as completed.  The usual completed
        # case is a save still in flight, which lands within a poll; but
        # we only get here after a cache/store miss, so a completed tile
        # that stays missing means the bytes are gone (wiped data dir, a
        # foreign store).  Give the in-flight save one poll window, then
        # heal: un-complete via ``refine`` and re-grant the compute
        # instead of waiting out the whole deadline for nothing.
        heal = not self.scheduler.prioritize(workload)
        if not heal:
            logger.info("on-demand: prioritized %s", workload)
        try:
            while True:
                remaining = t_deadline - loop.time()
                if remaining <= 0:
                    self.counters.inc("ondemand_timeouts")
                    logger.info("on-demand: deadline expired for %s", key)
                    return None
                try:
                    await asyncio.wait_for(
                        event.wait(), min(remaining, self.poll_interval))
                except (TimeoutError, asyncio.TimeoutError):
                    pass  # poll the store below, then keep waiting
                entry = await asyncio.to_thread(self.cache.load, key)
                if entry is not None:
                    self.counters.inc("ondemand_served")
                    return entry
                if heal:
                    heal = False
                    refine = getattr(self.scheduler, "refine", None)
                    if refine is not None and refine(workload):
                        self.counters.inc("ondemand_healed")
                        logger.info(
                            "on-demand: completed tile missing from store,"
                            " re-granted %s", workload)
                # Save notification without a loadable payload (save error
                # reopened the tile, or a spurious wake): re-arm and wait.
                event.clear()
        finally:
            # Callers coalesce upstream, so this compute() owns the entry:
            # drop it (served, timed out, or cancelled) to keep the table
            # bounded; the next miss for the key re-arms a fresh event.
            if self._arrivals.get(key) is event:
                del self._arrivals[key]
