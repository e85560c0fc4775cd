"""Single-flight request coalescing.

N concurrent gateway requests for the same tile key must trigger exactly
one store read / one on-demand compute — the classic cache-stampede guard
every serving stack in front of an expensive backend needs (here the
backend is a whole worker farm computing a 16 Mpix tile).

The first caller for a key becomes the *leader*: its supplier runs in a
detached task, so a leader whose connection drops mid-flight does not
cancel the flight for the followers piled up behind it.  Everyone —
leader included — awaits the shared future; the result (or the exception)
fans out to all of them.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Hashable, Optional, TypeVar

from distributedmandelbrot_tpu_torch.utils.metrics import Counters

T = TypeVar("T")


class SingleFlight:
    """Per-key coalescing of concurrent async suppliers (one event loop)."""

    def __init__(self, counters: Optional[Counters] = None) -> None:
        self.counters = counters if counters is not None else Counters()
        self._inflight: dict[Hashable, asyncio.Future] = {}
        self._tasks: set[asyncio.Task] = set()

    @property
    def inflight_count(self) -> int:
        return len(self._inflight)

    def cancel_inflight(self) -> list[asyncio.Task]:
        """Cancel all running flights (shutdown); returns them to await."""
        tasks = list(self._tasks)
        for task in tasks:
            task.cancel()
        return tasks

    async def run(self, key: Hashable,
                  supplier: Callable[[], Awaitable[T]]) -> T:
        """Run ``supplier`` once per key across concurrent callers.

        Followers arriving while a flight is up await its result instead
        of starting their own.  A follower's cancellation only cancels
        that follower; the flight itself completes and serves the rest.
        """
        existing = self._inflight.get(key)
        if existing is not None:
            self.counters.inc("coalesce_followers")
            return await asyncio.shield(existing)
        self.counters.inc("coalesce_leaders")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        task = asyncio.create_task(self._fly(key, fut, supplier))
        # Keep a strong ref: the loop only weakly references tasks, and a
        # GC'd flight would strand every waiter.
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return await asyncio.shield(fut)

    async def _fly(self, key: Hashable, fut: asyncio.Future,
                   supplier: Callable[[], Awaitable[T]]) -> None:
        try:
            result = await supplier()
        except BaseException as e:
            # Unregister BEFORE resolving: a caller retrying the moment
            # the future settles must start a fresh flight, not join a
            # finished one.
            self._inflight.pop(key, None)
            if not fut.cancelled():
                fut.set_exception(e)
            if isinstance(e, asyncio.CancelledError):
                raise
        else:
            self._inflight.pop(key, None)
            if not fut.cancelled():
                fut.set_result(result)
