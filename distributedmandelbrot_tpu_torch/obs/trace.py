"""Per-tile lifecycle trace: a bounded ring of timestamped events.

The farm's pipeline is ``scheduled -> granted -> result_received ->
persisted`` (plus ``served`` on the read side and ``lease_expired`` /
``requeued`` on the churn side).  Counters say HOW MANY tiles moved;
this ring says WHERE EACH ONE spent its time — the queue wait, the
worker's compute+upload, the persist tail — and, because grant/receive
events carry the worker's connection id, which worker is the straggler
(the load-balance skew the MPI Mandelbrot literature, arxiv 2007.00745,
shows dominating farm wall-clock).

Deliberately a deque ring, not a log file: at level-1000 scale the full
event stream is millions of entries, and the questions the trace answers
("what does a tile's life look like", "who is slow *right now*") only
need a recent window.  Overwritten events are counted, never silently
dropped.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import NamedTuple, Optional

Key = tuple[int, int, int]

# Pipeline order; spans() validates monotonic timestamps along it.
LIFECYCLE = ("scheduled", "granted", "result_received", "persisted",
             "served")
CHURN = ("lease_expired", "requeued")


class TraceEvent(NamedTuple):
    ts: float  # time.monotonic(); deltas only, never wall-clock
    event: str
    key: Key
    worker: Optional[str]  # connection id ("ip:port") where known


class TraceLog:
    """Thread-safe bounded ring of :class:`TraceEvent`.

    Writers are the coordinator loop and worker threads; readers are the
    exporter and tests.  ``capacity`` bounds memory (~100 bytes/event);
    8192 covers a few thousand tile lifetimes of recent history.
    """

    def __init__(self, capacity: int = 8192, *, clock=time.monotonic) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._events: deque[TraceEvent] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._recorded = 0

    def record(self, event: str, key: Key,
               worker: Optional[str] = None) -> None:
        ev = TraceEvent(self._clock(), event, key, worker)
        with self._lock:
            self._events.append(ev)
            self._recorded += 1

    @property
    def recorded(self) -> int:
        """Total events ever recorded (>= len(events()) once wrapped)."""
        with self._lock:
            return self._recorded

    @property
    def dropped(self) -> int:
        """Events the ring has overwritten."""
        with self._lock:
            return self._recorded - len(self._events)

    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    # -- derived views -----------------------------------------------------

    def spans(self) -> list[dict]:
        """Join events into per-tile latency breakdowns.

        One dict per tile key present in the window: the latest timestamp
        per event type, the worker that produced the result, and the
        stage latencies where both endpoints are in view (``queue_s`` =
        scheduled->granted, ``compute_s`` = granted->result_received,
        ``persist_s`` = result_received->persisted, ``total_s`` =
        scheduled->persisted).  ``complete`` marks tiles whose four
        write-path events are all present in order.
        """
        latest: dict[Key, dict[str, TraceEvent]] = {}
        requeues: dict[Key, int] = {}
        for ev in self.events():
            if ev.event in CHURN:
                requeues[ev.key] = requeues.get(ev.key, 0) + 1
                continue
            latest.setdefault(ev.key, {})[ev.event] = ev
        out = []
        for key in sorted(latest):
            evs = latest[key]
            ts = {name: e.ts for name, e in evs.items()}
            span: dict = {"key": key, "events": ts,
                          "churn": requeues.get(key, 0)}
            got = evs.get("result_received") or evs.get("granted")
            span["worker"] = got.worker if got is not None else None
            write_path = LIFECYCLE[:4]
            present = [ts[n] for n in write_path if n in ts]
            span["complete"] = (len(present) == len(write_path)
                                and present == sorted(present))
            for label, a, b in (("queue_s", "scheduled", "granted"),
                                ("compute_s", "granted", "result_received"),
                                ("persist_s", "result_received", "persisted"),
                                ("total_s", "scheduled", "persisted")):
                if a in ts and b in ts and ts[b] >= ts[a]:
                    span[label] = ts[b] - ts[a]
            out.append(span)
        return out

    def worker_skew(self,
                    reported: Optional[dict[Key, float]] = None) -> dict:
        """Per-worker load summary over the current window.

        For each worker (connection id) seen on a ``result_received``:
        tiles finished and busy seconds.  ``busy_s`` prefers the
        worker-reported compute-span duration for the tile (``reported``
        maps tile key -> seconds, typically ``SpanStore.compute_seconds
        _by_key()``); without one it falls back to the coordinator-only
        grant->receive interval — which also contains network + upload
        time, so each worker's ``busy_source`` labels what the number
        is: ``"reported"`` (all tiles span-backed), ``"lease"`` (pure
        fallback), or ``"mixed"``.  The headline ``skew`` is max busy /
        mean busy across workers — 1.0 is a perfectly balanced farm; the
        MPI-paper pathology shows up as one worker's skew >> 1 while the
        rest idle.
        """
        reported = reported or {}
        busy: dict[str, float] = {}
        tiles: dict[str, int] = {}
        span_tiles: dict[str, int] = {}
        for span in self.spans():
            worker = span.get("worker")
            if worker is None:
                continue
            if span["key"] in reported:
                dur = reported[span["key"]]
                from_span = True
            elif "compute_s" in span:
                dur = span["compute_s"]
                from_span = False
            else:
                continue
            busy[worker] = busy.get(worker, 0.0) + dur
            tiles[worker] = tiles.get(worker, 0) + 1
            span_tiles[worker] = span_tiles.get(worker, 0) + from_span
        if not busy:
            return {"workers": {}, "skew": None}

        def source(w: str) -> str:
            if span_tiles[w] == tiles[w]:
                return "reported"
            return "lease" if span_tiles[w] == 0 else "mixed"

        mean = sum(busy.values()) / len(busy)
        return {
            "workers": {w: {"tiles": tiles[w],
                            "busy_s": round(busy[w], 6),
                            "busy_source": source(w)}
                        for w in sorted(busy)},
            "skew": round(max(busy.values()) / mean, 3) if mean > 0 else None,
        }
