"""Explicit-state exploration of the composed protocol automata.

Takes the client x server :class:`~.fsm.EndpointPair` automata and
exhaustively explores their asynchronous product (two bounded FIFO
queues, one per direction) under every realistic capability
configuration, checking:

- **dual conformance** — every message that actually arrives at a peer
  finds a matching receive arm there (statically: every send label has
  *some* receive arm; dynamically: no run wedges with an unconsumable
  queue head);
- **deadlock freedom** — no reachable global state where both
  endpoints wait forever;
- **liveness-to-EOS** — from every reachable state some continuation
  reaches a terminal state (both endpoints closed or torn down).

Bounded-model-checking semantics: queue occupancy and loop counters
are bounded, and a global state blocked *only* by one of those bounds
is recorded as a truncation (coverage boundary), never as a finding.
Faults are first-class: an endpoint that aborts (a modeled ``raise``)
or closes pushes ``EOS``, and the peer either takes a fault arm
(``try/except ConnectionError``) or aborts in turn.

The same explicit-state engine drives :class:`CrashSpec` — a compact
spec of the lease -> accept -> persist-queue -> group-commit ->
checkpoint/restore pipeline with crash transitions at every registered
``utils/faults.py`` seam — asserting exactly-once commits and
no-lost-tile across all interleavings.

Stdlib-only, never imports the package under analysis.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from distributedmandelbrot_tpu_torch.analysis.fsm import (EOS, EPS, RECV, SEND,
                                                    WILD, Automaton,
                                                    EndpointPair)

__all__ = ["CRASH_SEAMS", "CapReport", "CrashReport", "CrashSpec",
           "ExploreConfig", "ExploreReport", "PairReport", "Violation",
           "cap_configs", "cap_gate_violations", "explore_all",
           "explore_crash_model", "explore_pair", "static_dual_violations"]

SESSION_ATOMS = ("RLE", "GRANTN", "SHARD")
SHARDED = "SHARDED"  # deployment-shape pseudo-atom (server has a ring)


@dataclass(frozen=True)
class ExploreConfig:
    queue_bound: int = 3
    ctr_bound: int = 2
    max_states: int = 20000


@dataclass(frozen=True)
class Violation:
    kind: str           # dual | deadlock | liveness | cap-gate | crash-*
    pair: str
    caps: frozenset
    message: str
    origin: tuple       # (relpath, line) anchor


@dataclass
class CapReport:
    caps: frozenset
    n_states: int = 0
    truncations: int = 0
    aborts: int = 0
    terminal_reached: bool = False
    complete: bool = True   # False when max_states was hit
    violations: list = field(default_factory=list)


@dataclass
class PairReport:
    pair: EndpointPair
    configs: list = field(default_factory=list)
    static_violations: list = field(default_factory=list)

    @property
    def visited_caps(self) -> set:
        return {c.caps for c in self.configs}

    @property
    def violations(self) -> list:
        out = list(self.static_violations)
        for c in self.configs:
            out.extend(c.violations)
        return out


@dataclass
class ExploreReport:
    pairs: list = field(default_factory=list)
    traversed: set = field(default_factory=set)   # (origin, label) recvs
    recv_arms: set = field(default_factory=set)   # all non-fault recvs

    @property
    def violations(self) -> list:
        out = []
        for p in self.pairs:
            out.extend(p.violations)
        return out

    def dead_arms(self) -> list:
        """Receive arms never exercised in any configuration of any
        pair, unioned by source origin (an arm shared by several
        exchanges is dead only if unexercised everywhere)."""
        alive = {key for key in self.traversed}
        return sorted(k for k in self.recv_arms if k not in alive)


# -- capability configurations ----------------------------------------------

def _subsets(atoms: Sequence[str]):
    n = len(atoms)
    for mask in range(1 << n):
        yield frozenset(a for i, a in enumerate(atoms)
                        if mask & (1 << i))


def cap_configs(pair: EndpointPair) -> list[frozenset]:
    """Realistic cap products.  Session: an unsharded server never
    negotiates SHARD (4 legacy-to-partial products), a sharded one can
    negotiate any subset (8 products).  Query exchanges only vary in
    deployment shape."""
    if pair.kind == "session":
        out = [s for s in _subsets(("RLE", "GRANTN"))]
        out += [s | {SHARDED} for s in _subsets(SESSION_ATOMS)]
        return out
    return [frozenset(), frozenset({SHARDED})]


# -- static checks ----------------------------------------------------------

def _send_labels(auto: Automaton) -> dict:
    out: dict = {}
    for e in auto.edges:
        if e.kind == SEND and e.label not in (EOS, WILD) \
                and not (e.pos & e.neg):
            out.setdefault(e.label, []).append(e)
    return out


def _recv_labels(auto: Automaton) -> dict:
    out: dict = {}
    for e in auto.edges:
        if e.kind == RECV and e.label != EOS and not (e.pos & e.neg):
            out.setdefault(e.label, []).append(e)
    return out


def static_dual_violations(pair: EndpointPair) -> list[Violation]:
    """A label one side can send with no receive arm at all on the
    other side — unconditional dual-conformance breakage."""
    out: list[Violation] = []
    for sender, receiver in ((pair.client, pair.server),
                             (pair.server, pair.client)):
        recvs = _recv_labels(receiver)
        if WILD in recvs:
            continue  # receiver has a wildcard arm: anything matches
        for label, edges in sorted(_send_labels(sender).items()):
            if label not in recvs:
                e = edges[0]
                out.append(Violation(
                    "dual", pair.name, frozenset(),
                    f"{sender.role} sends {label} but {receiver.role} "
                    f"has no receive arm for it", e.origin))
    return out


def _first_wire_pos(auto: Automaton, start: int) -> frozenset:
    """Intersection of pos-guards over the first wire edges reachable
    from ``start`` via eps moves — the caps a receive arm's *handling*
    demands even when the dispatch edge itself is unguarded."""
    seen = {start}
    q = deque([start])
    acc: Optional[frozenset] = None
    while q:
        st = q.popleft()
        for e in auto.out(st):
            if e.kind == EPS:
                if e.dst not in seen:
                    seen.add(e.dst)
                    q.append(e.dst)
            elif not e.fault:
                acc = e.pos if acc is None else (acc & e.pos)
    return acc if acc is not None else frozenset()


def cap_gate_violations(pair: EndpointPair) -> list[Violation]:
    """Hello-mask asymmetry: the receiver's arm for a label demands a
    capability the sender does not guarantee when emitting it."""
    out: list[Violation] = []
    for sender, receiver in ((pair.client, pair.server),
                             (pair.server, pair.client)):
        sends = _send_labels(sender)
        recvs = _recv_labels(receiver)
        for label in sorted(set(sends) & set(recvs)):
            sreq = None
            for e in sends[label]:
                p = e.pos - {SHARDED}
                sreq = p if sreq is None else (sreq & p)
            rreq = None
            for e in recvs[label]:
                p = (e.pos | _first_wire_pos(receiver, e.dst)) - {SHARDED}
                rreq = p if rreq is None else (rreq & p)
            if rreq and not rreq <= (sreq or frozenset()):
                e = recvs[label][0]
                out.append(Violation(
                    "cap-gate", pair.name, frozenset(rreq),
                    f"{receiver.role} only accepts {label} under caps "
                    f"{sorted(rreq)} but {sender.role} sends it under "
                    f"{sorted(sreq or frozenset())}", e.origin))
    return out


# -- product exploration ----------------------------------------------------

def _enabled(auto: Automaton, caps: frozenset) -> dict:
    out: dict = {}
    for e in auto.edges:
        if e.pos <= caps and not (e.neg & caps):
            out.setdefault(e.src, []).append(e)
    return out


def _prune_eps(auto: Automaton, enabled: dict) -> dict:
    """Drop eps moves into states that are dead under these caps (a
    method entry whose only continuation is cap-gated away), so the
    model never walks into an artifact stuck state."""
    changed = True
    while changed:
        changed = False
        for st in list(enabled):
            keep = [e for e in enabled[st]
                    if not (e.kind == EPS and e.dst not in auto.done
                            and not enabled.get(e.dst))]
            if len(keep) != len(enabled[st]):
                changed = True
                if keep:
                    enabled[st] = keep
                else:
                    del enabled[st]
    return enabled


def _apply_cops(cops: tuple, ctrs: tuple,
                bound: int) -> tuple[Optional[tuple], bool]:
    """(new counters, counter_blocked).  inc saturating would desync
    matched send/ack windows, so a blocked inc disables the move and
    flags truncation instead."""
    if not cops:
        return ctrs, False
    cs = list(ctrs)
    for op, k in cops:
        if op == "gt0":
            if cs[k] <= 0:
                return None, False
        elif op == "eq0":
            if cs[k] != 0:
                return None, False
        elif op == "dec":
            if cs[k] <= 0:
                return None, False
            cs[k] -= 1
        elif op == "inc":
            if cs[k] >= bound:
                return None, True
            cs[k] += 1
        elif op == "reset":
            cs[k] = 0
    return tuple(cs), False


def _closure(state: int, ctrs: tuple, en: dict, auto: Automaton,
             live: dict, cfg: ExploreConfig, memo: dict) -> tuple:
    """Eps-closure of one endpoint from a program point: the wire
    moves (send/recv edges with updated counters), the done states,
    and whether an abort (raise-only dead end) or a bound truncation
    is reachable via internal moves alone.  Interleaving the peer
    against invisible internal steps only multiplies the product, so
    the product is built over wire points exclusively."""
    key = (state, ctrs)
    got = memo.get(key)
    if got is not None:
        return got
    wire: list = []
    dones: list = []
    abort = trunc = False
    seen = {key}
    stack = [key]
    while stack:
        s, c = stack.pop()
        if s in auto.done:
            dones.append(s)
            continue
        edges = en.get(s)
        if not edges:
            abort = True
            continue
        for e in edges:
            nc, cblocked = _apply_cops(e.cops, c, cfg.ctr_bound)
            if nc is None:
                trunc |= cblocked
                continue
            lv = live.get(e.dst, frozenset())
            nc = tuple(v if k in lv else 0 for k, v in enumerate(nc))
            if e.kind == EPS:
                nxt = (e.dst, nc)
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
            else:
                wire.append((e, nc))
    res = (wire, dones, abort, trunc)
    memo[key] = res
    return res


def _explore_config(pair: EndpointPair, caps: frozenset,
                    cfg: ExploreConfig, traversed: set) -> CapReport:
    rep = CapReport(caps=caps)
    cen = _prune_eps(pair.client, _enabled(pair.client, caps))
    sen = _prune_eps(pair.server, _enabled(pair.server, caps))
    autos = (pair.client, pair.server)
    ens = (cen, sen)
    lives = (pair.client.live_counters(), pair.server.live_counters())
    memos: tuple = ({}, {})

    init = (pair.client.start, pair.server.start, (), (),
            (0,) * pair.client.n_counters,
            (0,) * pair.server.n_counters, True, True)
    seen = {init}
    queue = deque([init])
    succ: dict = {}
    terminals: set = set()
    cdone, sdone = pair.client.done, pair.server.done
    queue_bound, max_states = cfg.queue_bound, cfg.max_states

    while queue:
        st = queue.popleft()
        if len(seen) > max_states:
            rep.complete = False
            break
        cs, ss, qc, qs, cc, sc, ca, sa = st
        if (not ca or cs in cdone) and (not sa or ss in sdone):
            rep.terminal_reached = True
            terminals.add(st)
            continue
        nexts: list = []
        truncated = False
        stuck_dual: Optional[tuple] = None
        stuck_recv_origin: Optional[tuple] = None
        for side in (0, 1):
            auto = autos[side]
            # Successor tuples are built inline per side (the product
            # layout is (cs, ss, qc, qs, cc, sc, ca, sa)) — a per-state
            # closure here dominated the whole exploration's runtime.
            if side == 0:
                state, ctrs, alive = cs, cc, ca
                out_q, in_q = qc, qs
            else:
                state, ctrs, alive = ss, sc, sa
                out_q, in_q = qs, qc
            if not alive or state in auto.done:
                continue

            wire, dones, can_abort, can_trunc = _closure(
                state, ctrs, ens[side], auto, lives[side], cfg,
                memos[side])
            truncated |= can_trunc
            if can_abort:
                # raise-only program point: endpoint aborts, peer
                # observes the teardown as EOS.
                rep.aborts += 1
                nexts.append(
                    (state, ss, out_q + (EOS,), in_q, ctrs, sc, False, sa)
                    if side == 0 else
                    (cs, state, in_q, out_q + (EOS,), cc, ctrs, ca, False))
            for d in dones:
                nexts.append(
                    (d, ss, out_q, in_q, ctrs, sc, alive, sa)
                    if side == 0 else
                    (cs, d, in_q, out_q, cc, ctrs, ca, alive))
            has_recv = has_eos_arm = False
            for e, nctrs in wire:
                if e.kind == SEND:
                    if e.label == EOS:
                        nout = out_q + (EOS,)
                    elif len(out_q) < queue_bound:
                        nout = out_q + (e.label,)
                    else:
                        truncated = True
                        continue
                    nexts.append(
                        (e.dst, ss, nout, in_q, nctrs, sc, alive, sa)
                        if side == 0 else
                        (cs, e.dst, in_q, nout, cc, nctrs, ca, alive))
                else:  # RECV
                    has_recv = True
                    if e.label == EOS:
                        has_eos_arm = True
                    if stuck_recv_origin is None:
                        stuck_recv_origin = e.origin
                    if not in_q:
                        continue
                    head = in_q[0]
                    if e.label == EOS:
                        if head != EOS:
                            continue
                        # sticky: a closed peer stays closed
                        nin = in_q
                    elif head == EOS:
                        continue
                    elif e.label == WILD or head == WILD \
                            or head == e.label:
                        traversed.add((e.origin, e.label))
                        nin = in_q[1:]
                    else:
                        continue
                    nexts.append(
                        (e.dst, ss, out_q, nin, nctrs, sc, alive, sa)
                        if side == 0 else
                        (cs, e.dst, nin, out_q, cc, nctrs, ca, alive))
            if has_recv and in_q and in_q[0] != EOS and stuck_dual is None:
                stuck_dual = (auto.role, auto.describe(state), in_q[0])
            if has_recv and not has_eos_arm and in_q and in_q[0] == EOS:
                # recv on a dead connection without a fault arm: the
                # exception tears this endpoint down too.
                rep.aborts += 1
                nexts.append(
                    (state, ss, out_q + (EOS,), in_q, ctrs, sc, False, sa)
                    if side == 0 else
                    (cs, state, in_q, out_q + (EOS,), cc, ctrs, ca, False))

        if not nexts:
            if truncated:
                rep.truncations += 1
                terminals.add(st)  # bound artifact: acceptable sink
            elif stuck_dual is not None:
                role, desc, head = stuck_dual
                rep.violations.append(Violation(
                    "dual", pair.name, caps,
                    f"{desc} cannot consume {head} under caps "
                    f"{sorted(caps)} (peer at "
                    f"{autos[0].describe(cs) if role != 'client' else autos[1].describe(ss)})",
                    stuck_recv_origin or ("", 0)))
            else:
                rep.violations.append(Violation(
                    "deadlock", pair.name, caps,
                    f"stuck state pair {pair.client.describe(cs)} <-> "
                    f"{pair.server.describe(ss)} under caps "
                    f"{sorted(caps)}: both endpoints wait forever",
                    stuck_recv_origin or ("", 0)))
            continue
        succ[st] = nexts
        for n in nexts:
            if n not in seen:
                seen.add(n)
                queue.append(n)

    rep.n_states = len(seen)
    if rep.complete and not rep.violations:
        # liveness-to-EOS: every explored state must be co-reachable
        # from a terminal (or bound-truncated) sink.
        pred: dict = {}
        for st, ns in succ.items():
            for n in ns:
                pred.setdefault(n, []).append(st)
        co = set(terminals)
        bfs = deque(terminals)
        while bfs:
            st = bfs.popleft()
            for p in pred.get(st, ()):
                if p not in co:
                    co.add(p)
                    bfs.append(p)
        wedged = [st for st in seen if st not in co]
        if wedged:
            st = wedged[0]
            rep.violations.append(Violation(
                "liveness", pair.name, caps,
                f"{pair.client.describe(st[0])} <-> "
                f"{pair.server.describe(st[1])} under caps "
                f"{sorted(caps)} cannot reach end-of-stream",
                ("", 0)))
    return rep


def explore_pair(pair: EndpointPair,
                 cfg: Optional[ExploreConfig] = None,
                 traversed: Optional[set] = None) -> PairReport:
    cfg = cfg or ExploreConfig()
    traversed = traversed if traversed is not None else set()
    rep = PairReport(pair=pair)
    rep.static_violations.extend(static_dual_violations(pair))
    rep.static_violations.extend(cap_gate_violations(pair))
    for caps in cap_configs(pair):
        rep.configs.append(_explore_config(pair, caps, cfg, traversed))
    return rep


def explore_all(pairs: Sequence[EndpointPair],
                cfg: Optional[ExploreConfig] = None) -> ExploreReport:
    cfg = cfg or ExploreConfig()
    report = ExploreReport()
    for pair in pairs:
        report.pairs.append(explore_pair(pair, cfg, report.traversed))
        for auto in (pair.client, pair.server):
            for e in auto.edges:
                if e.kind == RECV and not e.fault \
                        and e.label not in (EOS, WILD) \
                        and not (e.pos & e.neg):
                    report.recv_arms.add((e.origin, e.label))
    return report


# -- crash-interleaving model of the persistence pipeline -------------------

CRASH_SEAMS = (
    "coord.between_accept_and_persist",
    "store.before_chunk_write",
    "store.after_chunk_write",
    "store.after_index_append",
    "recovery.mid_checkpoint",
)


@dataclass(frozen=True)
class CrashSpec:
    """Compact spec of the scheduler lease -> accept -> persist-queue
    -> group-commit -> checkpoint/restore pipeline for one tile.  The
    knobs exist so tests can knock out a defense and watch the
    corresponding invariant break:

    - ``claim_dedup``: the scheduler refuses to re-lease a tile whose
      in-memory state is already complete (off -> double commit).
    - ``pending_exclusion``: a checkpoint never records a tile as
      complete while its chunk is still volatile in the accept/persist
      window (off -> a crash loses the tile for good).
    """

    claim_dedup: bool = True
    pending_exclusion: bool = True
    max_crashes: int = 2


@dataclass
class CrashReport:
    n_states: int = 0
    violations: list = field(default_factory=list)
    seams_fired: set = field(default_factory=set)
    quiescent_ok: int = 0


# state tuple indices for the crash model
# (leased, complete, unqueued, queued, wphase, blob, index, commits,
#  crash_since_commit, ckpt, ckpt_pending, crashes)
_W_IDLE, _W_PICKED, _W_BLOBBED, _W_APPENDED = 0, 1, 2, 3
_COMMIT_CAP = 3


def _crash_transitions(st: tuple, spec: CrashSpec):
    (leased, complete, unqueued, queued, wphase, blob, index, commits,
     since, ckpt, pending, crashes) = st
    out = []

    def emit(name, **kw):
        s = dict(leased=leased, complete=complete, unqueued=unqueued,
                 queued=queued, wphase=wphase, blob=blob, index=index,
                 commits=commits, since=since, ckpt=ckpt,
                 pending=pending, crashes=crashes)
        s.update(kw)
        out.append((name, (s["leased"], s["complete"], s["unqueued"],
                           s["queued"], s["wphase"], s["blob"],
                           s["index"], s["commits"], s["since"],
                           s["ckpt"], s["pending"], s["crashes"])))

    busy = unqueued or queued or wphase != _W_IDLE
    if not leased and not busy and (not complete or not spec.claim_dedup):
        emit("lease", leased=True)
    if leased:
        emit("accept", leased=False, complete=True, unqueued=True)
    if unqueued:
        emit("enqueue", unqueued=False, queued=True)
    if queued:
        emit("persist_pick", queued=False, wphase=_W_PICKED)
    if wphase == _W_PICKED:
        emit("chunk_write", wphase=_W_BLOBBED, blob=1)
    if wphase == _W_BLOBBED and commits < _COMMIT_CAP:
        emit("index_append", wphase=_W_APPENDED, index=1,
             commits=commits + 1, since=False)
    if wphase == _W_APPENDED:
        emit("persist_done", wphase=_W_IDLE)
    if pending is None:
        snap = complete and (not busy if spec.pending_exclusion else True)
        emit("checkpoint_begin", pending=snap)
    else:
        emit("checkpoint_end", ckpt=pending, pending=None)

    if crashes < spec.max_crashes:
        windows = {
            "coord.between_accept_and_persist": unqueued,
            "store.before_chunk_write": wphase == _W_PICKED,
            "store.after_chunk_write": wphase == _W_BLOBBED,
            "store.after_index_append": wphase == _W_APPENDED,
            "recovery.mid_checkpoint": pending is not None,
        }
        recovered = bool(index) or bool(ckpt)
        for seam, enabled in windows.items():
            if enabled:
                emit(seam, leased=False, complete=recovered,
                     unqueued=False, queued=False, wphase=_W_IDLE,
                     since=True, pending=None, crashes=crashes + 1)
    return out


def explore_crash_model(spec: Optional[CrashSpec] = None) -> CrashReport:
    spec = spec or CrashSpec()
    rep = CrashReport()
    init = (False, False, False, False, _W_IDLE, 0, 0, 0, False, False,
            None, 0)
    seen = {init}
    queue = deque([init])
    while queue:
        st = queue.popleft()
        (leased, complete, unqueued, queued, wphase, blob, index,
         commits, since, ckpt, pending, crashes) = st
        moves = _crash_transitions(st, spec)
        for name, nxt in moves:
            if name == "index_append" and index == 1 and not since:
                rep.violations.append(Violation(
                    "crash-dual", "crash-model", frozenset(),
                    "exactly-once violated: tile committed twice with "
                    "no crash in between (lease/claim dedup broken)",
                    ("", 0)))
                continue
            if name in CRASH_SEAMS:
                rep.seams_fired.add(name)
            if nxt not in seen:
                seen.add(nxt)
                queue.append(nxt)
        busy = (leased or unqueued or queued or wphase != _W_IDLE
                or pending is not None)
        lease_open = not busy and (not complete or not spec.claim_dedup)
        if not busy and not lease_open:
            # quiescent: nothing in flight and the scheduler will never
            # hand the tile out again — it had better be durable.
            if index == 1 and commits >= 1:
                rep.quiescent_ok += 1
            else:
                rep.violations.append(Violation(
                    "crash-lost", "crash-model", frozenset(),
                    "no-lost-tile violated: pipeline quiesced with the "
                    "tile marked complete but never durably committed "
                    "(checkpoint recorded a volatile accept)", ("", 0)))
    rep.n_states = len(seen)
    return rep
