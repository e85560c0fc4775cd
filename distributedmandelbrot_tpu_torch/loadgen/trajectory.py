"""Session-trajectory workload model + the sticky session driver.

The storm harness's arrivals model anonymous independent viewers; an
interactive session is the opposite — one viewer issuing a *correlated*
stream of queries as they pan and zoom.  This module models a population
of such sessions: the aggregate arrival process is still Poisson (the
phase machinery unchanged), but each arrival is dealt to a session, and
a session's n-th query continues its own straight-line pan from a
Zipf-sampled anchor at a per-session velocity, *bouncing* off the
level's edges (a viewer pans, they don't teleport — a mod-level wrap
would poison the server's velocity estimate for a whole trajectory
window after every crossing).
``hot_share`` skews the deal toward session 0 — the flash-crowd
fairness scenario where one hot session would starve the rest without
per-session budgets.

:class:`SessionDriver` speaks the ``GATEWAY_SESSION_MAGIC`` framing
with two kinds of stickiness a real viewer has: a session always hits
the same replica (ids are per-gateway, not fleet-global), and its
queries are serialized per session (a viewer doesn't race itself), so
the server observes the trajectory in order — which is what makes the
predictor's velocity estimate, and therefore the measured prefetch hit
ratio, meaningful.  Different sessions still overlap freely; the storm
stays open-loop across the population.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Optional

from distributedmandelbrot_tpu_torch.loadgen import recorder as rec
from distributedmandelbrot_tpu_torch.loadgen.driver import _STATUS_OUTCOMES
from distributedmandelbrot_tpu_torch.loadgen.runner import OpenLoopRunner
from distributedmandelbrot_tpu_torch.loadgen.schedule import (Phase, Request,
                                                        ZipfTiles,
                                                        poisson_arrivals)
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


@dataclass(frozen=True)
class SessionRequest(Request):
    """One scheduled session query: a :class:`Request` plus the session
    slot (the model's stable viewer identity — the wire id is issued by
    whichever gateway the slot sticks to)."""

    session: int = 0


# Per-session pan velocities (tiles per query), drawn uniformly: the
# four cardinal pans and the four diagonals.
_VELOCITIES = ((1, 0), (-1, 0), (0, 1), (0, -1),
               (1, 1), (-1, -1), (1, -1), (-1, 1))


def _reflect(x: int, level: int) -> int:
    """Fold an unbounded pan coordinate into [0, level) by reflection
    (triangle wave of period 2*level): ... 5 6 7 7 6 5 ... at level 8."""
    m = x % (2 * level)
    return m if m < level else 2 * level - 1 - m


def build_session_schedule(phases: list[Phase], *, level: int,
                           sessions: int, seed: int = 0,
                           zipf_s: float = 1.1,
                           hot_share: float = 0.0) -> list[SessionRequest]:
    """Deal a Poisson arrival process onto panning sessions.

    Anchors are Zipf-sampled (sessions start where viewers start:
    on popular tiles), velocities are per-session, and the whole thing
    is seed-deterministic like :func:`~distributedmandelbrot_tpu_torch.
    loadgen.schedule.build_schedule`.
    """
    if sessions < 1:
        raise ValueError(f"need >= 1 session, got {sessions}")
    if not 0.0 <= hot_share < 1.0:
        raise ValueError(f"hot_share must be in [0, 1), got {hot_share}")
    rng = random.Random(seed)
    sampler = ZipfTiles(level, s=zipf_s, seed=seed)
    anchors = [sampler.sample() for _ in range(sessions)]
    velocities = [_VELOCITIES[rng.randrange(len(_VELOCITIES))]
                  for _ in range(sessions)]
    counts = [0] * sessions
    schedule: list[SessionRequest] = []
    for t, name in poisson_arrivals(phases, seed=seed + 1):
        if hot_share > 0.0 and sessions > 1 and rng.random() < hot_share:
            slot = 0
        else:
            slot = rng.randrange(sessions)
        step = counts[slot]
        counts[slot] += 1
        _, anchor_real, anchor_imag = anchors[slot]
        d_real, d_imag = velocities[slot]
        schedule.append(SessionRequest(
            t, name, level,
            _reflect(anchor_real + step * d_real, level),
            _reflect(anchor_imag + step * d_imag, level),
            session=slot))
    return schedule


class SessionDriver:
    """Async request function speaking the session framing.

    Callable with a :class:`SessionRequest`; returns ``(outcome,
    nbytes)`` in the recorder's vocabulary, so it plugs into
    :class:`SessionRunner`.  ``ok_by_session`` accumulates per-slot
    goodput for the fairness-spread report.
    """

    def __init__(self, addresses: list[tuple[str, int]], *,
                 colormap_id: int = proto.COLORMAP_JET,
                 caps: int = proto.SESSION_CAPS_MASK,
                 timeout: Optional[float] = 30.0) -> None:
        if not addresses:
            raise ValueError("need at least one gateway address")
        self.addresses = list(addresses)
        self.colormap_id = proto.validate_colormap(colormap_id)
        self.caps = proto.validate_session_flags(caps)
        self.timeout = timeout
        self._sids: dict[int, int] = {}
        self._locks: dict[int, asyncio.Lock] = {}
        self.ok_by_session: dict[int, int] = {}
        self.shed_by_session: dict[int, int] = {}

    async def __call__(self, item: SessionRequest) -> tuple[str, int]:
        slot = item.session
        # Serialize per session so the gateway sees the pan in order;
        # an open-loop backlog queues here, and the wait is honestly
        # part of that session's latency.
        lock = self._locks.setdefault(slot, asyncio.Lock())
        async with lock:
            try:
                exchange = self._exchange(slot, item.level,
                                          item.index_real, item.index_imag)
                if self.timeout is not None:
                    return await asyncio.wait_for(exchange, self.timeout)
                return await exchange
            except (ConnectionError, OSError, TimeoutError,
                    asyncio.TimeoutError, framing.ProtocolError):
                return rec.OUTCOME_ERROR, 0

    async def _exchange(self, slot: int, level: int, index_real: int,
                        index_imag: int) -> tuple[str, int]:
        # Sticky replica: session ids are per-gateway state.
        host, port = self.addresses[slot % len(self.addresses)]
        reader, writer = await asyncio.open_connection(host, port)
        try:
            sid = self._sids.get(slot, 0)
            flags = self.caps if sid == 0 else 0
            framing.write_u32(writer, proto.GATEWAY_SESSION_MAGIC)
            writer.write(proto.SESSION_QUERY_TAIL.pack(
                sid, level, index_real, index_imag, self.colormap_id,
                flags))
            await writer.drain()
            raw = await framing.read_exact(reader,
                                           proto.SESSION_REPLY_WIRE_SIZE)
            new_sid, _caps = proto.SESSION_REPLY.unpack(raw)
            # 0 means the server dropped the session (TTL/LRU): reopen
            # on this slot's next query.
            self._sids[slot] = new_sid
            status = await framing.read_byte(reader)
            outcome = _STATUS_OUTCOMES.get(status)
            if outcome is not None:
                if outcome == rec.OUTCOME_SHED:
                    self.shed_by_session[slot] = \
                        self.shed_by_session.get(slot, 0) + 1
                return outcome, 0
            if status != proto.QUERY_ACCEPT:
                raise framing.ProtocolError(
                    f"unknown query status {status:#x}")
            length = proto.validate_payload_length(
                await framing.read_u32(reader))
            payload = await framing.read_exact(reader, length)
            self.ok_by_session[slot] = self.ok_by_session.get(slot, 0) + 1
            return rec.OUTCOME_OK, len(payload)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class SessionRunner(OpenLoopRunner):
    """Open-loop runner whose request function takes the whole
    :class:`SessionRequest` (the driver needs the session slot, not just
    the key)."""

    async def _issue(self, item: Request) -> None:
        t0 = self.timebase.now()
        try:
            outcome, nbytes = await self.request(item)
        except asyncio.CancelledError:
            raise
        except Exception:
            outcome, nbytes = rec.OUTCOME_ERROR, 0
        finally:
            self._inflight -= 1
        self.recorder.record(item.phase, outcome,
                             self.timebase.now() - t0, nbytes)


def ok_spread(ok_by_session: dict[int, int],
              sessions: int) -> tuple[int, int]:
    """``(min, max)`` per-session OK counts over all ``sessions`` slots
    (absent slots count zero) — the bounded-spread fairness criterion
    compares these."""
    counts = [ok_by_session.get(slot, 0) for slot in range(sessions)]
    return min(counts), max(counts)
