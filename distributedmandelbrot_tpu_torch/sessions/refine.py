"""Progressive refinement: full-depth compute behind a cheap first paint.

A session's first paint of a cold tile is served from a low-``max_iter``
workload — a fraction of the iteration cost, so the user sees pixels
fast.  This tracker then hands the *full-depth* workload back to the
scheduler (``scheduler.refine``: un-complete the 3-tuple, queue at the
frontier head) and remembers the key until the deep variant's save lands
(the coordinator's save hook calls :meth:`on_saved`, right after the
decoded/rendered cache tiers dropped their stale shallow entries).
The workload 4-tuple keys the store by ``max_iter``, so both variants
coexist on disk; reads always see the newest save.
"""

from __future__ import annotations

import threading
from typing import Optional

from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.sessions.table import Key
from distributedmandelbrot_tpu_torch.utils.metrics import Counters


class RefinementTracker:
    def __init__(self, scheduler, *,
                 counters: Optional[Counters] = None) -> None:
        # Duck-typed coordinator.scheduler.TileScheduler (refine).
        self.scheduler = scheduler
        self.counters = counters if counters is not None else Counters()
        self._pending: set[Key] = set()
        self._lock = threading.Lock()

    def schedule(self, w: Workload) -> bool:
        """Queue the full-depth workload behind a just-served first
        paint; idempotent while the refinement is in flight."""
        with self._lock:
            if w.key in self._pending:
                return True
        if not self.scheduler.refine(w):
            return False
        with self._lock:
            self._pending.add(w.key)
        self.counters.inc(obs_names.SESSION_REFINES_SCHEDULED)
        return True

    def on_saved(self, key: Key) -> None:
        """A chunk save landed; if it was a pending refinement, the deep
        variant is now durable and the refinement is done."""
        with self._lock:
            if key not in self._pending:
                return
            self._pending.discard(key)
        self.counters.inc(obs_names.SESSION_REFINES_COMPLETED)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)
