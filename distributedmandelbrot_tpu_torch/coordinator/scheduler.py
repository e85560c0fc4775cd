"""Tile scheduler: frontier queue + lease table + completion dedup.

Semantics preserved from the reference's Distributer (at-least-once with
dedup at ingest):

- a tile is handed out iff it is neither completed nor under an unexpired
  lease (``Distributer.cs:317-330``)
- grants are ordered level-setting by level-setting, ``index_real`` outer,
  ``index_imag`` inner (``Distributer.cs:338-340``)
- a result is accepted iff an unexpired matching lease exists; late
  (expired-lease) and duplicate results are rejected
  (``Distributer.cs:404,447-456``)
- expired leases make the tile grantable again, both lazily and via a
  periodic sweep (``DistributerWorkload.cs:116-120``, ``Distributer.cs:153-160``)
- completion is keyed on ``(level, i, j)`` only, fixing the reference's
  broken hash/equality contract so resume dedup is exact, not best-effort
  (survey caveat on ``DistributerWorkload.cs:50-51``).

Design difference (the TPU build's hot-path fix): the reference rescans the
whole O(sum level^2) grid per request; this scheduler keeps an advancing
cursor over the grid plus a retry queue fed by lease expiry, making grants
O(1) amortized.  A batched acquire leases k tiles in one call — the server
-side half of batched dispatch that keeps a device mesh fed.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Sequence

from distributedmandelbrot_tpu_torch.coordinator.clock import Clock, MonotonicClock
from distributedmandelbrot_tpu_torch.core.workload import LevelSetting, Workload
from distributedmandelbrot_tpu_torch.net.protocol import DEFAULT_LEASE_TIMEOUT
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names

if TYPE_CHECKING:
    from distributedmandelbrot_tpu_torch.obs.metrics import Registry
    from distributedmandelbrot_tpu_torch.obs.trace import TraceLog

Key = tuple[int, int, int]


@dataclass
class Lease:
    workload: Workload
    expires_at: float

    def expired(self, now: float) -> bool:
        return now >= self.expires_at


class TileScheduler:
    """Pure scheduling logic — no I/O, no real time."""

    def __init__(self, level_settings: Sequence[LevelSetting], *,
                 completed: Optional[set[Key]] = None,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT,
                 clock: Optional[Clock] = None,
                 registry: Optional["Registry"] = None,
                 trace: Optional["TraceLog"] = None,
                 owns: Optional[Callable[[Key], bool]] = None) -> None:
        if not level_settings:
            raise ValueError("at least one level setting required")
        seen_levels: set[int] = set()
        for s in level_settings:
            if s.level in seen_levels:
                raise ValueError(f"duplicate level {s.level}")
            seen_levels.add(s.level)
        self._levels = seen_levels
        self.level_settings = tuple(level_settings)
        self.lease_timeout = lease_timeout
        self.clock = clock if clock is not None else MonotonicClock()
        self._completed: set[Key] = set(completed or ())
        # Completion counter restricted to the configured grid: the resume
        # set may carry keys from levels this run does not render (index
        # replay keeps every level ever computed), so len(_completed) alone
        # cannot answer is_complete().  Counting membership once here and
        # maintaining the integer on every completion/reopen keeps
        # is_complete() O(1) — the stats loop and embedders call it per
        # tick, and a full-grid rescan is O(sum level^2) at level-1000
        # scale (the rescan cost this scheduler was built to avoid,
        # Distributer.cs:335-353).
        # Keyspace filter for a sharded control plane: a ring slice's
        # ``owns`` restricts the frontier to this coordinator's keys.
        # None (the default) is the unsharded whole-grid scheduler.
        # The owned total is enumerated once up front so is_complete()
        # and the frontier gauge stay O(1) — the same trade the
        # _remaining counter already makes for resume sets.
        self._owns = owns
        if owns is None:
            self._owned_tiles = self.total_tiles
        else:
            self._owned_tiles = sum(
                1 for s in self.level_settings
                for i in range(s.level) for j in range(s.level)
                if owns((s.level, i, j)))
        self._remaining = self._owned_tiles - sum(
            1 for k in self._completed if self._counts(k))
        self._leases: dict[Key, Lease] = {}
        self._claims: dict[Key, tuple[int, Lease]] = {}
        self._claim_seq = 0  # claim identity; see claim()
        self._retry: deque[Workload] = deque()
        # The frontier cursor is a flat position into the grid enumeration
        # (settings in order, index_real outer, index_imag inner) rather
        # than a live generator, so a checkpoint can record it as one
        # integer and a restore resumes the frontier exactly where the
        # crashed coordinator left it (snapshot_state/restore_state).
        self._cursor_pos = 0
        self._cursor_done = False
        # Passive telemetry hooks — the scheduler stays pure logic (no
        # I/O, no real time); both default to None and cost nothing then.
        self._registry = registry
        self._trace = trace

    def _record(self, event: str, key: Key) -> None:
        if self._trace is not None:
            self._trace.record(event, key)

    def _count_requeue(self, key: Key, *, expired: bool = False) -> None:
        if expired:
            self._record("lease_expired", key)
            flight.note(obs_events.SCHED_EXPIRE, key=key)
            if self._registry is not None:
                self._registry.inc(obs_names.COORD_LEASES_EXPIRED)
        self._record("requeued", key)
        flight.note(obs_events.SCHED_REQUEUE, key=key)
        if self._registry is not None:
            self._registry.inc(obs_names.COORD_REQUEUES)

    # -- state inspection -------------------------------------------------

    @property
    def total_tiles(self) -> int:
        return sum(s.tile_count for s in self.level_settings)

    @property
    def owned_tiles(self) -> int:
        """Tiles of the configured grid this scheduler may grant (the
        whole grid unless a ring slice's ``owns`` filter restricts it)."""
        return self._owned_tiles

    @property
    def completed_count(self) -> int:
        """Completed tiles of the CONFIGURED (and owned) grid (resume
        sets may carry keys from other levels or other shards' slices;
        those are excluded so stats can never report more tiles
        complete than this scheduler grants)."""
        return self._owned_tiles - self._remaining

    @property
    def outstanding_leases(self) -> int:
        now = self.clock.now()
        return sum(1 for l in self._leases.values() if not l.expired(now))

    @property
    def frontier_depth(self) -> int:
        """Tiles still to grant: not completed and not under a lease or
        claim.  O(1) from maintained integers (the exporter's frontier
        gauge reads this per scrape); expired-but-unswept leases make it
        a slight undercount until the next sweep, which is the honest
        view of what a worker asking right now would be offered."""
        return max(0,
                   self._remaining - len(self._leases) - len(self._claims))

    def is_complete(self) -> bool:
        """All tiles of all configured levels are done (O(1))."""
        return self._remaining == 0

    def _in_grid(self, key: Key) -> bool:
        level, i, j = key
        return level in self._levels and 0 <= i < level and 0 <= j < level

    def _counts(self, key: Key) -> bool:
        """Does ``key`` count toward _remaining?  In the configured grid
        AND in this scheduler's owned slice — a foreign shard's key must
        never move the completion counter it was not counted into."""
        return self._in_grid(key) and (self._owns is None
                                       or self._owns(key))

    # -- grant path -------------------------------------------------------

    def _workload_at(self, pos: int) -> Optional[Workload]:
        """Grid workload at flat cursor position ``pos`` (grant order:
        settings in sequence, ``index_real`` outer, ``index_imag`` inner,
        ``Distributer.cs:338-340``); None past the end of the grid."""
        for s in self.level_settings:
            if pos < s.tile_count:
                return Workload(s.level, s.max_iter, pos // s.level,
                                pos % s.level)
            pos -= s.tile_count
        return None

    def _grantable(self, w: Workload, now: float) -> bool:
        if self._owns is not None and not self._owns(w.key):
            return False  # another shard's key (cursor walks the grid)
        if w.key in self._completed:
            return False
        claim = self._claims.get(w.key)
        if claim is not None and not claim[1].expired(now):
            return False  # a result for this tile is mid-upload
        lease = self._leases.get(w.key)
        return lease is None or lease.expired(now)

    def _next_needed(self, now: float) -> Optional[Workload]:
        while self._retry:
            w = self._retry.popleft()
            if self._grantable(w, now):
                return w
        while not self._cursor_done:
            w = self._workload_at(self._cursor_pos)
            if w is None:
                self._cursor_done = True
                break
            self._cursor_pos += 1
            if self._grantable(w, now):
                return w
        return None

    def acquire(self) -> Optional[Workload]:
        """Grant the next needed tile and lease it; None if none available.

        None does not mean the run is finished — tiles under unexpired
        leases may yet expire and become grantable (poll again later),
        exactly as in the reference's pull loop.
        """
        now = self.clock.now()
        w = self._next_needed(now)
        if w is None:
            # Lazy expiry, matching the reference's per-request re-check
            # (Distributer.cs:317-330): when the frontier is empty, requeue
            # any expired leases/claims right now instead of making the
            # worker wait for the periodic sweep.  O(|leases|), and only on
            # the otherwise-idle path.
            if self.sweep():
                w = self._next_needed(now)
            if w is None:
                return None
        self._record("scheduled", w.key)
        self._leases[w.key] = Lease(w, now + self.lease_timeout)
        flight.note(obs_events.SCHED_GRANT, key=w.key)
        return w

    def acquire_batch(self, max_count: int) -> list[Workload]:
        """Lease up to ``max_count`` tiles in one call (batched dispatch)."""
        out: list[Workload] = []
        while len(out) < max_count:
            w = self.acquire()
            if w is None:
                break
            out.append(w)
        return out

    # -- ingest path ------------------------------------------------------

    def can_accept(self, w: Workload) -> bool:
        """A result is acceptable iff an unexpired matching lease exists."""
        lease = self._leases.get(w.key)
        return (lease is not None and not lease.expired(self.clock.now())
                and lease.workload.matches(w))

    def claim(self, w: Workload) -> Optional[int]:
        """Atomically consume the matching lease at accept time; returns an
        opaque claim token, or None if the result is not acceptable.

        The reference matches-and-removes the lease when the 16-byte echo
        arrives, *before* the payload (``Distributer.cs:404``); doing the
        same here closes the window where a second worker's submission for
        the same tile could match the lease while the first payload is
        still in flight.  The claim keeps the lease's expiry: a payload
        that dawdles past it is dropped (`finish_claim`), and the sweep
        requeues expired claims just like expired leases.

        The token carries the claim's identity: if this claim expires
        mid-upload and the tile is re-leased and re-claimed by another
        submission, the dawdler's late ``finish_claim``/``release_claim``
        is a no-op instead of consuming the live claim.
        """
        if not self.can_accept(w):
            return None
        self._claim_seq += 1
        self._claims[w.key] = (self._claim_seq, self._leases.pop(w.key))
        flight.note(obs_events.SCHED_CLAIM, key=w.key,
                    lease=self._claim_seq)
        return self._claim_seq

    def finish_claim(self, w: Workload, token: int) -> bool:
        """Record completion after the claimed result's payload landed."""
        entry = self._claims.get(w.key)
        if entry is None or entry[0] != token:
            return False  # claim expired and was swept / superseded
        del self._claims[w.key]
        if entry[1].expired(self.clock.now()):
            self._retry.append(entry[1].workload)
            self._count_requeue(w.key, expired=True)
            return False
        if w.key not in self._completed:
            self._completed.add(w.key)
            if self._counts(w.key):
                # Only owned configured-grid tiles count toward
                # is_complete(); a foreign key slipping through the claim
                # path must not drive _remaining negative and end the run
                # early.
                self._remaining -= 1
        flight.note(obs_events.SCHED_ACCEPT, key=w.key, lease=token)
        return True

    def release_claim(self, w: Workload, token: int) -> None:
        """Abort a claim (payload never arrived); tile grantable again."""
        entry = self._claims.get(w.key)
        if entry is None or entry[0] != token:
            return  # superseded; nothing to release
        del self._claims[w.key]
        flight.note(obs_events.SCHED_RELEASE, key=w.key, lease=token)
        if w.key not in self._completed:
            self._retry.append(entry[1].workload)
            self._count_requeue(w.key)

    def complete(self, w: Workload) -> bool:
        """Record a completed tile; returns False for stale/unknown results.

        Single-step composite of :meth:`claim` + :meth:`finish_claim` for
        callers with no payload phase (tests, embedders).
        """
        token = self.claim(w)
        return token is not None and self.finish_claim(w, token)

    def prioritize(self, w: Workload) -> bool:
        """Move a tile to the front of the grant order (compute-on-read).

        Returns False for tiles this run cannot produce (out of grid) and
        for tiles already completed (the caller should read the store).
        Returns True when the tile is either queued at the frontier head or
        already in flight under an unexpired lease/claim — in both cases a
        result is expected, so the caller may await its arrival.

        A duplicate in the retry queue is harmless: grants re-check
        ``_grantable`` at pop time, so stale entries are skipped.
        """
        if not self._counts(w.key):
            return False
        if w.key in self._completed:
            return False
        if self._grantable(w, self.clock.now()):
            self._retry.appendleft(w)
            flight.note(obs_events.SCHED_PRIORITIZE, key=w.key)
        return True

    def refine(self, w: Workload) -> bool:
        """Re-grant a tile at a different depth (progressive refinement).

        A session's first paint completes the tile's 3-tuple key with a
        cheap low-``max_iter`` workload; serving full quality means
        granting the same key again at full depth.  Completion is keyed
        on the 3-tuple, so this un-completes the tile (if completed) and
        queues ``w`` — which carries the target ``max_iter`` — at the
        frontier head.  Returns False for out-of-grid/out-of-slice keys;
        True means a grant at ``w``'s depth is queued or already in
        flight, so the caller may await the deep save.
        """
        if not self._counts(w.key):
            return False
        if w.key in self._completed:
            self._completed.discard(w.key)
            self._remaining += 1
        flight.note(obs_events.SCHED_REFINE, key=w.key,
                    max_iter=w.max_iter)
        if self._grantable(w, self.clock.now()):
            self._retry.appendleft(w)
        return True

    def reopen(self, w: Workload) -> None:
        """Un-complete a tile whose persistence failed so it is granted again.

        Ingest marks a tile complete before its asynchronous save lands; if
        the save errors, the result's bytes are gone and the tile must go
        back in the frontier or the run would finish with a silent hole.
        """
        if w.key in self._completed and self._counts(w.key):
            # Out-of-grid (and out-of-slice) keys stay in _completed and
            # never enter the frontier: requeueing one would let it be
            # granted and re-completed, corrupting the _remaining
            # counter for tiles this scheduler doesn't grant.
            self._completed.discard(w.key)
            self._remaining += 1
            self._retry.append(w)
            flight.note(obs_events.SCHED_REOPEN, key=w.key)
            self._count_requeue(w.key)

    # -- checkpoint / restore ---------------------------------------------

    def snapshot_state(self, *, exclude: Optional[set[Key]] = None) -> dict:
        """Checkpointable view of the scheduler (coordinator/recovery.py).

        Plain Python structures only — serialization (and the index
        offset the completed set pairs with) is the recovery module's
        business.  ``exclude`` removes keys whose persistence is still
        in flight: a tile completed in memory but without a durable
        index entry must not be checkpointed as done, or a crash before
        its save lands would leave a hole no replay can fill.  Lease
        expiries are captured as *remaining* TTLs against this clock, so
        a restore under a different clock origin (a new process) grants
        workers the time they actually had left.  Claims are folded into
        the lease list: their upload connections die with the process,
        and the worker's retry needs a live lease to land against.
        """
        now = self.clock.now()
        completed = set(self._completed)
        retry = list(self._retry)
        if exclude:
            completed -= exclude
            # An excluded completed tile must also be re-grantable after a
            # restore: if the crash beats its save, no index entry ever
            # appears, its lease is gone (consumed at accept), and the
            # cursor is past it — without a retry entry it would never be
            # granted again and the run could not finish.  restore_state
            # filters retry against the final completed set, so if the
            # save DID land (suffix replay finds it) the entry is dropped.
            max_iters = {s.level: s.max_iter for s in self.level_settings}
            for key in sorted(exclude):
                if key in self._completed and self._counts(key):
                    level, i, j = key
                    retry.append(Workload(level, max_iters[level], i, j))
        leases: list[tuple[Workload, float]] = []
        for lease in self._leases.values():
            leases.append((lease.workload, lease.expires_at - now))
        for _, lease in self._claims.values():
            leases.append((lease.workload, lease.expires_at - now))
        return {
            "cursor_pos": self._cursor_pos,
            "cursor_done": self._cursor_done,
            "completed": completed,
            "retry": retry,
            "leases": leases,
        }

    def restore_state(self, *, cursor_pos: int, cursor_done: bool,
                      retry: Sequence[Workload],
                      leases: Sequence[tuple[Workload, float]]) -> int:
        """Adopt a checkpointed frontier; returns the leases rebuilt.

        The completed set is NOT restored here — the coordinator seeds
        it through the constructor after merging the checkpoint's set
        with the index-suffix replay, and this method filters against
        it: a tile that completed after the checkpoint must drop out of
        the restored retry queue and lease table.  A lease whose
        remaining TTL ran out while the coordinator was down goes
        straight to the retry queue (grantable now) instead of waiting
        for a sweep to notice.
        """
        now = self.clock.now()
        self._cursor_pos = cursor_pos
        self._cursor_done = cursor_done
        self._retry = deque(w for w in retry
                            if w.key not in self._completed)
        rebuilt = 0
        for w, remaining in leases:
            if w.key in self._completed or w.key in self._leases:
                continue
            if remaining > 0:
                self._leases[w.key] = Lease(w, now + remaining)
                rebuilt += 1
            else:
                self._retry.append(w)
                self._count_requeue(w.key, expired=True)
        flight.note(obs_events.SCHED_RESTORE, leases=rebuilt,
                    retry=len(self._retry))
        return rebuilt

    # -- maintenance ------------------------------------------------------

    def sweep(self) -> int:
        """Drop expired leases/claims and requeue their tiles."""
        now = self.clock.now()
        swept = 0
        expired = [k for k, l in self._leases.items() if l.expired(now)]
        for key in expired:
            lease = self._leases.pop(key)
            if key not in self._completed:
                self._retry.append(lease.workload)
                self._count_requeue(key, expired=True)
        swept += len(expired)
        expired = [k for k, (_, l) in self._claims.items() if l.expired(now)]
        for key in expired:
            _, lease = self._claims.pop(key)
            if key not in self._completed:
                self._retry.append(lease.workload)
                self._count_requeue(key, expired=True)
        swept += len(expired)
        return swept
