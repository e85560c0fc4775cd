"""Session table: id issuance, viewport trajectories, LRU/TTL expiry.

One :class:`SessionState` per live viewer session.  The table is
thread-safe (the gateway's event loop touches it inline while varz
scrapes read from the exporter thread) and bounded two ways: ``capacity``
evicts the least-recently-touched session, ``ttl`` expires idle ones —
lazily on :meth:`SessionTable.touch` and in bulk via
:meth:`SessionTable.sweep`.  An evicted/expired session is not an error
on the wire: the client's next query gets the soft unknown-session
reject and reopens with id 0.

The clock is injectable so expiry, fairness refill, and trajectory
timestamps are all deterministic under the loadgen virtual timebase.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Optional

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.serve.gateway import TokenBucket
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

Key = tuple[int, int, int]

# Per-session prefetch marks kept at most; oldest marks fall off first.
# A mark is one predicted tile awaiting its hit/miss verdict — a pan at
# human speed never holds more than a handful.
MAX_PREFETCH_MARKS = 128


@dataclass(frozen=True)
class ViewportObs:
    """One observed viewport sample on a session's trajectory."""

    t: float
    level: int
    index_real: int
    index_imag: int

    @property
    def key(self) -> Key:
        return (self.level, self.index_real, self.index_imag)


class SessionState:
    """One live session: granted capabilities, the trajectory ring, the
    private admission budget, and outstanding prefetch marks.

    ``weight`` scales the session's token budget (weighted fair
    admission): a weight-2 session refills twice as fast and bursts
    twice as deep as a weight-1 one under the same configured rate.
    """

    __slots__ = ("session_id", "caps", "weight", "bucket", "created",
                 "last_seen", "_trajectory", "_prefetched")

    def __init__(self, session_id: int, caps: int, *, weight: float = 1.0,
                 rate: Optional[float] = None, burst: float = 32.0,
                 trajectory_len: int = 8,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.session_id = session_id
        self.caps = caps
        self.weight = weight
        scaled_rate = rate * weight if rate is not None and rate > 0 else rate
        self.bucket = TokenBucket(scaled_rate, burst * weight, clock=clock)
        self.created = clock()
        self.last_seen = self.created
        self._trajectory: deque[ViewportObs] = deque(maxlen=trajectory_len)
        self._prefetched: OrderedDict[Key, None] = OrderedDict()

    def observe(self, level: int, index_real: int, index_imag: int,
                now: float) -> None:
        """Append a viewport sample; the ring keeps the newest ``maxlen``."""
        self._trajectory.append(ViewportObs(now, level, index_real,
                                            index_imag))
        self.last_seen = now

    def trajectory(self) -> tuple[ViewportObs, ...]:
        return tuple(self._trajectory)

    def admit(self) -> bool:
        """Charge one query against this session's budget."""
        return self.bucket.try_acquire()

    def mark_prefetched(self, key: Key) -> bool:
        """Remember that ``key`` was prefetched for this session; False
        if it is already marked (don't replan the same tile)."""
        if key in self._prefetched:
            return False
        self._prefetched[key] = None
        while len(self._prefetched) > MAX_PREFETCH_MARKS:
            self._prefetched.popitem(last=False)
        return True

    def consume_prefetch(self, key: Key) -> bool:
        """Pop ``key``'s mark if present — the query landed on a
        predicted tile (a prefetch hit)."""
        if key in self._prefetched:
            del self._prefetched[key]
            return True
        return False


class SessionTable:
    """Thread-safe registry of live sessions.

    Ids are issued monotonically from 1 — 0 is the wire's open-a-session
    sentinel, so it can never name a live entry.  ``session_rate`` /
    ``session_burst`` parameterize each session's private token budget
    (``None`` rate admits everything — fairness off).
    """

    def __init__(self, *, capacity: int = 1024, ttl: Optional[float] = 300.0,
                 trajectory_len: int = 8,
                 session_rate: Optional[float] = None,
                 session_burst: float = 32.0,
                 clock: Callable[[], float] = time.monotonic,
                 counters: Optional[Counters] = None) -> None:
        self.capacity = capacity
        self.ttl = ttl
        self.trajectory_len = trajectory_len
        self.session_rate = session_rate
        self.session_burst = session_burst
        self.clock = clock
        self.counters = counters if counters is not None else Counters()
        self._sessions: OrderedDict[int, SessionState] = OrderedDict()
        self._lock = threading.Lock()
        self._next_id = 0
        self.counters.registry.gauge(
            obs_names.GAUGE_SESSIONS_ACTIVE,
            help="live interactive sessions",
            fn=lambda: float(len(self)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def now(self) -> float:
        return self.clock()

    def open(self, caps: int, *, weight: float = 1.0) -> SessionState:
        """Issue a new session with the given granted capability bits."""
        with self._lock:
            self._next_id += 1
            state = SessionState(self._next_id, caps, weight=weight,
                                 rate=self.session_rate,
                                 burst=self.session_burst,
                                 trajectory_len=self.trajectory_len,
                                 clock=self.clock)
            self._sessions[state.session_id] = state
            evicted = 0
            while len(self._sessions) > self.capacity:
                self._sessions.popitem(last=False)
                evicted += 1
        self.counters.inc(obs_names.SESSION_OPENS)
        if evicted:
            self.counters.inc(obs_names.SESSION_EVICTED, evicted)
        return state

    def touch(self, session_id: int) -> Optional[SessionState]:
        """Look up a live session, refreshing its LRU position and idle
        clock; ``None`` for unknown or just-expired ids.

        ``session_id`` arrives straight off the wire — it is only ever
        a dict-key probe here, never an index.
        """
        now = self.clock()
        expired = False
        with self._lock:
            state = self._sessions.get(session_id)
            if state is None:
                return None
            if self.ttl is not None and now - state.last_seen > self.ttl:
                del self._sessions[session_id]
                state = None
                expired = True
            else:
                self._sessions.move_to_end(session_id)
                state.last_seen = now
        if expired:
            self.counters.inc(obs_names.SESSION_EXPIRED)
        return state

    def sweep(self) -> int:
        """Expire every idle session in one pass (periodic maintenance —
        touch already expires lazily, this reclaims sessions nobody
        queries again)."""
        if self.ttl is None:
            return 0
        now = self.clock()
        with self._lock:
            idle = [sid for sid, s in self._sessions.items()
                    if now - s.last_seen > self.ttl]
            for sid in idle:
                del self._sessions[sid]
        if idle:
            self.counters.inc(obs_names.SESSION_EXPIRED, len(idle))
        return len(idle)

    def varz(self) -> dict:
        """Aggregate view for the /varz debug page."""
        with self._lock:
            active = len(self._sessions)
            issued = self._next_id
        return {
            "active": active,
            "issued": issued,
            "capacity": self.capacity,
            "ttl": self.ttl,
            "opened": self.counters.get(obs_names.SESSION_OPENS),
            "expired": self.counters.get(obs_names.SESSION_EXPIRED),
            "evicted": self.counters.get(obs_names.SESSION_EVICTED),
        }
