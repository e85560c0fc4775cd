"""Protocol automata lifted from the wire endpoints (the v4 engine layer).

PR 6's ``proto-frames`` compares *linear* frame sequences; the session
tier stopped being linear several PRs ago — capability negotiation,
piggybacked grants, REDIRECT arms and batched leases make both
endpoints genuine state machines.  This module extracts each endpoint
into a nondeterministic send/recv automaton straight from the stdlib
AST (never importing the package — same contract as every other
analysis module), so :mod:`.explore` can compose client x server and
exhaustively check dual conformance, deadlock freedom and liveness.

Model (message granularity, payload-blind):

- **States** are program points; every state is auto-named
  ``func:L<line>`` so findings can name the stuck pair.
- **Edges** are ``send``/``recv``/``eps`` transitions labeled with a
  wire *message*: a purpose/status byte constant (``PURPOSE_SESSION``,
  ``QUERY_ACCEPT``), a frame type (``FRAME_UPLOAD``, from the
  ``SESSION_FRAME.pack`` first argument), or a header struct name
  (``SESSION_HELLO``, ``QUERY``, ``SESSION_REPLY``).  Everything else
  on the wire — grant lists, upload bodies, redirect payloads, span
  reports — is payload and invisible here (``proto-frames`` /
  ``wire-*`` keep covering it).
- **Guards**: capability tests (``flags & SESSION_FLAG_X``,
  ``negotiated & SESSION_FLAG_X``) stamp edges with positive/negative
  cap atoms; ``ring_slice is not None`` stamps the ``SHARDED``
  pseudo-atom (server-side deployment shape, not a hello flag).
- **Counters**: ``xs = []`` / ``xs.append`` / ``for .. in
  enumerate(xs)`` pairs become bounded counters so the pipelined
  upload window (send N, then read N acks) explores finitely.
- **Faults**: a recv inside ``try/except ConnectionError`` gets a
  sibling ``recv EOS`` edge into the handler — connection drop as a
  first-class transition (the server's clean end-of-session path and
  the client's legacy-hello fallback both fall out of this).
- ``raise`` paths are dropped (crash-stop): a branch that can only
  raise contributes no edges, so defensive validation never shows up
  as a protocol move.  In particular ``if not caps & X: raise`` models
  capability *gating*, and a selector mismatch arm (``if frame_type
  not in want: raise``) models the *absence* of a receive arm.

Soundness caveats (documented in the README): payload values are not
tracked, helper splicing is depth-bounded, comprehension bodies are
not walked (all comprehension-embedded wire ops in the tree are
payload reads), and unknown branch conditions fork nondeterministically
— the automaton over-approximates behaviors, so exploration findings
are real reachability facts of the *model*, not of every concrete run.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional, Sequence

from distributedmandelbrot_tpu_torch.analysis import callgraph
from distributedmandelbrot_tpu_torch.analysis.astutil import attr_chain
from distributedmandelbrot_tpu_torch.analysis.engine import PACKAGE, Project

__all__ = ["Automaton", "Edge", "EndpointPair", "build_pairs",
           "build_query_pairs", "build_session_pair", "to_dot"]

EOS = "EOS"          # synthesized end-of-stream message
WILD = "?"           # a status byte the extractor could not resolve

SEND, RECV, EPS = "send", "recv", "eps"

# Header structs that ARE messages; every other struct read/write is
# payload.  SESSION_FRAME is special: its pack/unpack first field is
# the frame type, so it turns into per-FRAME_* labeled edges instead.
FRAME_HEADER_STRUCT = "SESSION_FRAME"
MSG_STRUCTS = {"SESSION_HELLO", "QUERY", "RENDER_QUERY_TAIL",
               "SESSION_QUERY_TAIL", "SESSION_REPLY"}

# Status/purpose byte constants that are messages; RESPONSE_* /
# WIRE_CODEC_* bytes ride inside frame payloads and stay invisible.
_BYTE_LABEL_PREFIXES = ("PURPOSE_", "QUERY_")
_BYTE_LABELS_EXTRA = {"SESSION_ACCEPT"}

_SEND_BYTE = {"send_byte", "write_byte"}
_SEND_MANY = {"send_all", "send_parts"}
_RECV_EXACT = {"recv_exact", "read_exact"}
_RECV_BYTE = {"recv_byte", "read_byte"}
_IGNORED_WIRE = {"send_u32", "write_u32", "recv_u32", "read_u32"}

# Exception names whose handler represents the peer hanging up (EOS) —
# recvs inside such a try get the sibling fault edge.
_EOS_EXC_NAMES = {"ConnectionError", "ConnectionResetError", "OSError",
                  "EOFError", "TimeoutError", "IncompleteReadError"}

_SPLICE_DEPTH = 6
# Truncating the frontier drops continuations and leaves dangling
# states that read as phantom deadlocks downstream, so the cap must sit
# above the real peak (~112 items in the session dispatch loop).
_FRONTIER_CAP = 512

CLIENT_SESSION_CLASS = f"{PACKAGE}/worker/client.py::DistributerSession"
SERVER_SESSION_HANDLER = (f"{PACKAGE}/coordinator/distributer.py::"
                          f"Distributer._handle_session")


def _is_byte_label(name: str) -> bool:
    return (name in _BYTE_LABELS_EXTRA
            or any(name.startswith(p) and not name.endswith("_WIRE_SIZE")
                   for p in _BYTE_LABEL_PREFIXES))


def cap_atom_of(const_name: str) -> Optional[str]:
    """``SESSION_FLAG_RLE`` -> ``"RLE"`` (the exploration cap atom)."""
    if const_name.startswith("SESSION_FLAG_"):
        return const_name[len("SESSION_FLAG_"):]
    return None


@dataclass(frozen=True)
class Edge:
    """One labeled transition.  ``cops`` are counter guard/update ops
    applied atomically with the move: ``("inc"|"dec"|"reset"|"gt0"|
    "eq0", counter_index)``."""

    src: int
    dst: int
    kind: str            # send | recv | eps
    label: str           # message, or "" for eps
    pos: frozenset = frozenset()
    neg: frozenset = frozenset()
    cops: tuple = ()
    fault: bool = False  # EOS-sibling edges (only enabled by faults)
    origin: tuple = ("", 0)  # (relpath, line)


class Automaton:
    """A nondeterministic send/recv automaton for one endpoint."""

    def __init__(self, name: str, role: str) -> None:
        self.name = name
        self.role = role  # "client" | "server"
        self.edges: list[Edge] = []
        self.state_names: dict[int, str] = {}
        self.done: set[int] = set()
        self.n_counters = 0
        self._n_states = 0
        self._out: Optional[dict[int, list[Edge]]] = None
        self._memo: dict = {}
        self._edge_set: set[Edge] = set()
        self._live: Optional[dict[int, frozenset]] = None
        self.start = self.new_state("start")

    def new_state(self, name: str) -> int:
        s = self._n_states
        self._n_states += 1
        self.state_names[s] = name
        return s

    def memo_state(self, key: tuple, name: str) -> int:
        """Shared successor state: frontier items at the same program
        point taking the same move converge instead of minting copies
        (keeps the automaton near-linear in source size)."""
        st = self._memo.get(key)
        if st is None:
            st = self.new_state(name)
            self._memo[key] = st
        return st

    def new_counter(self) -> int:
        k = self.n_counters
        self.n_counters += 1
        return k

    def add_edge(self, edge: Edge) -> Edge:
        if edge in self._edge_set:
            return edge
        self._edge_set.add(edge)
        self.edges.append(edge)
        self._out = None
        self._live = None
        return edge

    def out(self, state: int) -> list[Edge]:
        if self._out is None:
            self._out = {}
            for e in self.edges:
                self._out.setdefault(e.src, []).append(e)
        return self._out.get(state, [])

    def describe(self, state: int) -> str:
        return f"{self.role}@{self.state_names.get(state, state)}"

    def live_counters(self) -> dict[int, frozenset]:
        """Backward liveness per state: counter k is live when some
        path ahead tests it (gt0/eq0/dec) before resetting it.  Dead
        counters can be normalized to zero during exploration — stale
        window counts from a finished exchange would otherwise
        multiply the product state space for no semantic reason.
        Cached: the exploration asks once per capability config but
        the answer only depends on the (frozen) edge set."""
        if self._live is not None:
            return self._live
        live: dict[int, set] = {s: set() for s in self.state_names}
        changed = True
        while changed:
            changed = False
            for e in self.edges:
                uses = {k for op, k in e.cops
                        if op in ("gt0", "eq0", "dec")}
                kills = {k for op, k in e.cops if op == "reset"}
                new = uses | (live.get(e.dst, set()) - kills)
                if not new <= live[e.src]:
                    live[e.src] |= new
                    changed = True
        self._live = {s: frozenset(v) for s, v in live.items()}
        return self._live


@dataclass
class EndpointPair:
    """One composed exchange: a client automaton and its server peer."""

    name: str
    kind: str  # "session" | "query"
    client: Automaton
    server: Automaton


# -- abstract values --------------------------------------------------------
#
# The extractor's tiny value domain: frozenset of constant names
# ("FRAME_UPLOAD", "True"), Tup for literal tuples, Cond for the
# `(a, b) if caps & X else (a,)` idiom, Ctr for counter-linked lists,
# RxSel for a received-but-not-yet-tested selector (frame type or
# status byte), Probe for `DICT.get(selector)` results, None=unknown.

@dataclass(frozen=True)
class Tup:
    items: tuple


@dataclass(frozen=True)
class Cond:
    atom: str
    then: object
    other: object


@dataclass(frozen=True)
class Ctr:
    index: int


@dataclass(frozen=True)
class RxSel:
    src: int            # state the selecting recv happens from
    excluded: frozenset  # labels already ruled out
    origin: tuple = ("", 0)


@dataclass(frozen=True)
class Probe:
    var: str
    keys: frozenset     # dict keys (label constants)


class _Item:
    """One frontier element: a program point plus its abstract context."""

    __slots__ = ("state", "env", "pos", "neg", "eos", "pending")

    def __init__(self, state: int, env: dict, pos: frozenset, neg: frozenset,
                 eos: Optional[int] = None,
                 pending: Optional[tuple] = None) -> None:
        self.state = state
        self.env = env
        self.pos = pos
        self.neg = neg
        self.eos = eos            # handler-entry state for EOS siblings
        self.pending = pending    # (src, dst, varname) deferred byte send

    def fork(self, **kw) -> "_Item":
        it = _Item(self.state, dict(self.env), self.pos, self.neg,
                   self.eos, self.pending)
        for k, v in kw.items():
            setattr(it, k, v)
        return it

# -- extraction -------------------------------------------------------------

class Extractor:
    """AST -> automaton, threading a frontier of :class:`_Item` through
    each statement block.  One instance per automaton build."""

    def __init__(self, project: Project, auto: Automaton) -> None:
        self.project = project
        self.auto = auto
        self.graph = callgraph.graph_for(project)
        self._ctr_by_node: dict[int, int] = {}

    # -- small helpers ----------------------------------------------------

    def _origin(self, relpath: str, node: ast.AST) -> tuple:
        return (relpath, getattr(node, "lineno", 0))

    def _flush_pending(self, item: _Item, origin: tuple) -> None:
        """Deferred byte send that no test ever resolved: wildcard."""
        if item.pending is not None:
            src, dst, _var, porigin = item.pending
            self.auto.add_edge(Edge(src, dst, SEND, WILD, item.pos,
                                    item.neg, (), False, porigin))
            item.pending = None

    # -- abstract evaluation ----------------------------------------------

    def _const_name(self, expr: ast.expr) -> Optional[str]:
        """``proto.FRAME_UPLOAD`` / bare ``FRAME_UPLOAD`` -> name."""
        chain = attr_chain(expr)
        if chain and chain[-1].isupper():
            return chain[-1]
        return None

    def _eval(self, expr: ast.expr, item: _Item):
        if isinstance(expr, ast.Constant):
            if expr.value is True:
                return frozenset({"True"})
            if expr.value is False:
                return frozenset({"False"})
            if expr.value is None:
                return frozenset({"None"})
            return None
        if isinstance(expr, ast.Name):
            return item.env.get(expr.id)
        name = self._const_name(expr)
        if name is not None:
            return frozenset({name})
        if isinstance(expr, ast.Tuple):
            return Tup(tuple(self._eval(e, item) for e in expr.elts))
        if isinstance(expr, ast.IfExp):
            g = self._cap_guard(expr.test, item)
            if g is not None:
                atom, positive = g
                then = self._eval(expr.body, item)
                other = self._eval(expr.orelse, item)
                if positive:
                    return Cond(atom, then, other)
                return Cond(atom, other, then)
            return None
        if isinstance(expr, ast.List) and not expr.elts:
            k = self._ctr_by_node.get(id(expr))
            if k is None:
                k = self.auto.new_counter()
                self._ctr_by_node[id(expr)] = k
            return Ctr(k)
        if isinstance(expr, ast.Call):
            # enumerate(xs) / list(xs) / sorted(xs): transparent wrappers
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in ("enumerate", "list", "sorted",
                                         "tuple", "reversed") and expr.args:
                return self._eval(expr.args[0], item)
        return None

    def _cond_members(self, value) -> Optional[list[tuple[str, frozenset,
                                                          frozenset]]]:
        """Flatten a (possibly Cond-wrapped) tuple of label constants to
        ``(label, extra_pos, extra_neg)`` rows; None if not that shape."""
        def consts(v) -> Optional[set[str]]:
            if isinstance(v, Tup):
                out: set[str] = set()
                for it in v.items:
                    if isinstance(it, frozenset) and len(it) == 1:
                        out.add(next(iter(it)))
                    else:
                        return None
                return out
            if isinstance(v, frozenset):
                return set(v)
            return None

        if isinstance(value, Cond):
            then, other = consts(value.then), consts(value.other)
            if then is None or other is None:
                return None
            rows = []
            for c in sorted(then | other):
                if c in then and c in other:
                    rows.append((c, frozenset(), frozenset()))
                elif c in then:
                    rows.append((c, frozenset({value.atom}), frozenset()))
                else:
                    rows.append((c, frozenset(), frozenset({value.atom})))
            return rows
        flat = consts(value)
        if flat is None:
            return None
        return [(c, frozenset(), frozenset()) for c in sorted(flat)]

    # -- guard analysis ---------------------------------------------------

    def _cap_guard(self, test: ast.expr,
                   item: _Item) -> Optional[tuple[str, bool]]:
        """(atom, positive) for capability tests; None otherwise."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            g = self._cap_guard(test.operand, item)
            if g is not None:
                return (g[0], not g[1])
            return None
        if isinstance(test, ast.BinOp) and isinstance(test.op, ast.BitAnd):
            for side in (test.right, test.left):
                name = self._const_name(side)
                if name:
                    atom = cap_atom_of(name)
                    if atom:
                        return (atom, True)
            return None
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            chain = attr_chain(test.left)
            if chain and chain[-1] == "ring_slice" \
                    and isinstance(test.comparators[0], ast.Constant) \
                    and test.comparators[0].value is None:
                if isinstance(test.ops[0], ast.IsNot):
                    return ("SHARDED", True)
                if isinstance(test.ops[0], ast.Is):
                    return ("SHARDED", False)
        return None

    # -- wire-op classification -------------------------------------------

    def _unwrap(self, expr: ast.expr) -> ast.expr:
        """Peel `await`, `self._read(x)`, `asyncio.wait_for(x, t)`."""
        while True:
            if isinstance(expr, ast.Await):
                expr = expr.value
                continue
            if isinstance(expr, ast.Call):
                chain = attr_chain(expr.func)
                if chain and chain[-1] == "_read" and len(expr.args) == 1:
                    expr = expr.args[0]
                    continue
                if chain and chain[-1] == "wait_for" and expr.args:
                    expr = expr.args[0]
                    continue
            if isinstance(expr, ast.IfExp):
                # both arms of the timeout idiom wrap the same read
                expr = expr.body
                continue
            return expr

    def _struct_of_size(self, expr: ast.expr) -> Optional[str]:
        """``proto.X.size`` / ``proto.X_WIRE_SIZE`` -> ``X``."""
        chain = attr_chain(expr)
        if not chain:
            return None
        if chain[-1] == "size" and len(chain) > 1 and chain[-2].isupper():
            return chain[-2]
        if chain[-1].endswith("_WIRE_SIZE"):
            return chain[-1][:-len("_WIRE_SIZE")]
        return None

    def _wire_call(self, expr: ast.expr) -> Optional[tuple[str, ast.Call]]:
        """(op_name, call) when expr is a framing wire op (unwrapped)."""
        expr = self._unwrap(expr)
        if not isinstance(expr, ast.Call):
            return None
        chain = attr_chain(expr.func)
        if not chain:
            return None
        name = chain[-1]
        if name in (_SEND_BYTE | _SEND_MANY | _RECV_EXACT | _RECV_BYTE
                    | _IGNORED_WIRE):
            return (name, expr)
        if name == "write" and len(chain) >= 2 \
                and chain[-2] in ("writer", "w"):
            return ("write", expr)
        return None

    def _pack_labels(self, call: ast.Call,
                     item: _Item) -> Optional[list[tuple[str, frozenset,
                                                         frozenset]]]:
        """``STRUCT.pack(..)`` -> message rows, or None if payload."""
        chain = attr_chain(call.func)
        if not (chain and chain[-1] == "pack" and len(chain) > 1):
            return None
        struct = chain[-2]
        if struct == FRAME_HEADER_STRUCT:
            if not call.args:
                return []
            rows = self._cond_members(self._eval(call.args[0], item))
            return rows or []
        if struct in MSG_STRUCTS:
            return [(struct, frozenset(), frozenset())]
        return []  # payload struct: ignored

    # -- sends / recvs ----------------------------------------------------

    def _emit_send_rows(self, item: _Item, rows, origin: tuple) -> None:
        if not rows:
            return
        labels = tuple(sorted({r[0] for r in rows}))
        dst = self.auto.memo_state(("sent", item.state, labels),
                                   "sent " + "/".join(labels))
        for label, pos, neg in rows:
            self.auto.add_edge(Edge(item.state, dst, SEND, label,
                                    item.pos | pos, item.neg | neg,
                                    (), False, origin))
        item.state = dst

    def _do_send_byte(self, call: ast.Call, item: _Item,
                      origin: tuple) -> None:
        if len(call.args) < 2:
            return
        val = self._eval(call.args[1], item)
        rows = self._cond_members(val)
        if rows is not None:
            rows = [r for r in rows if _is_byte_label(r[0])]
            self._emit_send_rows(item, rows, origin)
            return
        # unknown status variable: deferred send, resolved by later
        # `status == CONST` tests, wildcard-flushed otherwise.
        self._flush_pending(item, origin)
        if isinstance(call.args[1], ast.Name):
            dst = self.auto.memo_state(("replied", item.state, origin),
                                       f"replied:L{origin[1]}")
            item.pending = (item.state, dst, call.args[1].id, origin)
            item.state = dst

    def _do_send_many(self, call: ast.Call, item: _Item,
                      origin: tuple) -> None:
        rows: list = []
        stack: list[ast.expr] = list(call.args)
        while stack:
            a = stack.pop(0)
            if isinstance(a, ast.Starred):
                continue
            if isinstance(a, (ast.List, ast.Tuple)):
                stack = list(a.elts) + stack
                continue
            if isinstance(a, ast.Call):
                got = self._pack_labels(a, item)
                if got:
                    rows.extend(got)
        self._emit_send_rows(item, rows, origin)

    def _recv_edge(self, item: _Item, label: str, origin: tuple) -> None:
        dst = self.auto.memo_state(("got", item.state, label),
                                   f"got {label}")
        self.auto.add_edge(Edge(item.state, dst, RECV, label, item.pos,
                                item.neg, (), False, origin))
        self._eos_sibling(item, origin)
        item.state = dst

    def _eos_sibling(self, item: _Item, origin: tuple) -> None:
        if item.eos is not None:
            self.auto.add_edge(Edge(item.state, item.eos, RECV, EOS,
                                    item.pos, item.neg, (), True, origin))

    # -- recv classification for assignments ------------------------------

    def _recv_assign(self, value: ast.expr, names: list, item: _Item,
                     ctx: "_Ctx") -> bool:
        """Handle ``x = <wire recv>`` shapes; True when consumed."""
        v = self._unwrap(value)
        struct = None
        if isinstance(v, ast.Call):
            chain = attr_chain(v.func)
            if chain and chain[-1] == "unpack" and len(chain) > 1 \
                    and chain[-2].isupper() and v.args:
                inner = self._unwrap(v.args[0])
                wc = self._wire_call(inner)
                if wc is None:
                    return False  # unpack of an already-read buffer
                struct = chain[-2]
                v = inner
        wc = self._wire_call(v)
        if wc is None:
            return False
        name, call = wc
        origin = self._origin(ctx.relpath, call)
        if name in _RECV_BYTE:
            self._flush_pending(item, origin)
            if names and names[0]:
                item.env[names[0]] = RxSel(item.state, frozenset(), origin)
                self._eos_sibling(item, origin)
            else:
                self._recv_edge(item, WILD, origin)
            return True
        if name in _RECV_EXACT:
            self._flush_pending(item, origin)
            if struct is None and len(call.args) > 1:
                struct = self._struct_of_size(call.args[1])
            if struct == FRAME_HEADER_STRUCT:
                if names and names[0]:
                    item.env[names[0]] = RxSel(item.state, frozenset(),
                                               origin)
                    self._eos_sibling(item, origin)
                else:
                    self._recv_edge(item, WILD, origin)
            elif struct in MSG_STRUCTS:
                self._recv_edge(item, struct, origin)
            # payload read: invisible
            return True
        if name in _IGNORED_WIRE:
            return True
        return False

    # -- branching --------------------------------------------------------

    def _var_test(self, test: ast.expr, item: _Item):
        """Selector/flag tests -> ``(var, rows, mode)``.  ``mode`` is
        "match" (then-branch = those labels) or "invert" (else-branch =
        those labels)."""
        neg = False
        while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            neg, test = not neg, test.operand
        if isinstance(test, ast.Name):
            val = item.env.get(test.id)
            if isinstance(val, frozenset) and val <= {"True", "False",
                                                      "None"}:
                rows = [("True", frozenset(), frozenset())]
                return (test.id, rows, "invert" if neg else "match")
            return None
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.left, ast.Name)):
            return None
        var = test.left.id
        op, comp = test.ops[0], test.comparators[0]
        val = item.env.get(var)
        if isinstance(val, Probe) and isinstance(comp, ast.Constant) \
                and comp.value is None \
                and isinstance(op, (ast.Is, ast.IsNot)):
            hit = isinstance(op, ast.IsNot) != neg
            rows = [(k, frozenset(), frozenset()) for k in sorted(val.keys)]
            return (val.var, rows, "match" if hit else "invert")
        if isinstance(op, (ast.Eq, ast.In)):
            eq = not neg
        elif isinstance(op, (ast.NotEq, ast.NotIn)):
            eq = neg
        else:
            return None
        rows = self._cond_members(self._eval(comp, item))
        if not rows:
            return None
        return (var, rows, "match" if eq else "invert")

    def _resolve_rows(self, var: str, rows, item: _Item,
                      take: bool) -> list[_Item]:
        """Items for the branch where ``var`` IS one of ``rows``
        (take=True) or is NOT (take=False)."""
        val = item.env.get(var)
        labels = frozenset(r[0] for r in rows)
        if item.pending is not None and item.pending[2] == var:
            src, dst, _, porigin = item.pending
            if take:
                for label, pos, neg in rows:
                    self.auto.add_edge(Edge(src, dst, SEND, label,
                                            item.pos | pos, item.neg | neg,
                                            (), False, porigin))
                it = item.fork(pending=None)
                it.env[var] = labels
                return [it]
            return [item.fork()]
        if isinstance(val, RxSel):
            if take:
                out = []
                for label, pos, neg in rows:
                    if label in val.excluded:
                        continue
                    it = item.fork(pos=item.pos | pos, neg=item.neg | neg)
                    if _is_byte_label(label) or label.startswith("FRAME_"):
                        dst = self.auto.memo_state(
                            ("got", val.src, label), f"got {label}")
                        self.auto.add_edge(Edge(val.src, dst, RECV, label,
                                                it.pos, it.neg, (), False,
                                                val.origin))
                        it.state = dst
                    # non-wire byte (RESPONSE_* etc.): payload, no edge
                    it.env[var] = frozenset({label})
                    out.append(it)
                return out
            it = item.fork()
            it.env[var] = RxSel(val.src, val.excluded | labels)
            return [it]
        if isinstance(val, frozenset):
            if take:
                out = []
                for label, pos, neg in rows:
                    if label not in val:
                        continue
                    it = item.fork(pos=item.pos | pos, neg=item.neg | neg)
                    it.env[var] = frozenset({label})
                    out.append(it)
                return out
            rest = val - labels
            if not rest:
                return []
            it = item.fork()
            it.env[var] = rest
            return [it]
        # unknown variable: fork both ways
        return [item.fork()]

    def _branch(self, test: ast.expr, item: _Item,
                ctx: "_Ctx") -> tuple[list[_Item], list[_Item]]:
        g = self._cap_guard(test, item)
        if g is not None:
            atom, positive = g
            if positive:
                return ([item.fork(pos=item.pos | {atom})],
                        [item.fork(neg=item.neg | {atom})])
            return ([item.fork(neg=item.neg | {atom})],
                    [item.fork(pos=item.pos | {atom})])
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
            pos, neg = set(), set()
            for v in test.values:
                gv = self._cap_guard(v, item)
                if gv is not None:
                    (pos if gv[1] else neg).add(gv[0])
            then = item.fork(pos=item.pos | frozenset(pos),
                             neg=item.neg | frozenset(neg))
            return ([then], [item.fork()])
        vt = self._var_test(test, item)
        if vt is not None:
            var, rows, mode = vt
            if mode == "match":
                return (self._resolve_rows(var, rows, item, True),
                        self._resolve_rows(var, rows, item, False))
            return (self._resolve_rows(var, rows, item, False),
                    self._resolve_rows(var, rows, item, True))
        return ([item.fork()], [item.fork()])

    # -- statement walk ---------------------------------------------------

    def _dedup(self, items: list[_Item]) -> list[_Item]:
        seen: set = set()
        out: list[_Item] = []
        for it in items:
            key = (it.state, it.pos, it.neg, it.pending,
                   tuple(sorted((k, repr(v)) for k, v in it.env.items())))
            if key not in seen:
                seen.add(key)
                out.append(it)
        return out[:_FRONTIER_CAP]

    def _run_block(self, stmts: Sequence[ast.stmt], items: list[_Item],
                   ctx: "_Ctx", returns: list, breaks: list,
                   continues: list) -> list[_Item]:
        for stmt in stmts:
            nxt: list[_Item] = []
            for item in items:
                nxt.extend(self._do_stmt(stmt, item, ctx, returns,
                                         breaks, continues))
            items = self._dedup(nxt)
            if not items:
                break
        return items

    def _do_stmt(self, stmt: ast.stmt, item: _Item, ctx: "_Ctx",
                 returns: list, breaks: list,
                 continues: list) -> list[_Item]:
        if isinstance(stmt, ast.Return):
            origin = self._origin(ctx.relpath, stmt)
            self._flush_pending(item, origin)
            if isinstance(stmt.value, ast.Call) or isinstance(
                    stmt.value, ast.Await):
                call = self._unwrap(stmt.value)
                if isinstance(call, ast.Call):
                    spliced = self._try_splice(call, item, ctx)
                    if spliced is not None:
                        returns.extend(spliced)
                        return []
            rv = frozenset({"None"}) if stmt.value is None \
                else self._eval(stmt.value, item)
            returns.append((item, rv))
            return []
        if isinstance(stmt, ast.Raise):
            return []  # crash-stop: defensive paths contribute no edges
        if isinstance(stmt, ast.Break):
            breaks.append(item)
            return []
        if isinstance(stmt, ast.Continue):
            continues.append(item)
            return []
        if isinstance(stmt, ast.If):
            then_items, else_items = self._branch(stmt.test, item, ctx)
            out = self._run_block(stmt.body, then_items, ctx, returns,
                                  breaks, continues)
            out = out + self._run_block(stmt.orelse, else_items, ctx,
                                        returns, breaks, continues)
            return out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._do_loop(stmt, item, ctx, returns)
        if isinstance(stmt, ast.Try):
            return self._do_try(stmt, item, ctx, returns, breaks,
                                continues)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._run_block(stmt.body, [item], ctx, returns,
                                   breaks, continues)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
            return self._do_assign(stmt.targets[0], stmt.value, item, ctx)
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            return self._do_assign(stmt.target, stmt.value, item, ctx)
        if isinstance(stmt, ast.Expr):
            return self._do_expr(stmt.value, item, ctx)
        return [item]

    def _do_loop(self, node, item: _Item, ctx: "_Ctx",
                 returns: list) -> list[_Item]:
        origin = self._origin(ctx.relpath, node)
        self._flush_pending(item, origin)
        header = self.auto.memo_state(
            ("loop", item.state, origin),
            f"{ctx.func}:L{node.lineno}")
        self.auto.add_edge(Edge(item.state, header, EPS, "", item.pos,
                                item.neg, (), False, origin))
        breaks: list[_Item] = []
        continues: list[_Item] = []
        exits: list[_Item] = []
        body_item = item.fork(state=header)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            for n in _target_names(node.target):
                body_item.env.pop(n, None)
            it_val = self._eval(node.iter, item)
            b = self.auto.memo_state(("loop-iter", header),
                                     f"{ctx.func}:L{node.lineno}:iter")
            x = self.auto.memo_state(("loop-done", header),
                                     f"{ctx.func}:L{node.lineno}:done")
            if isinstance(it_val, Ctr):
                self.auto.add_edge(Edge(header, b, EPS, "", item.pos,
                                        item.neg,
                                        (("gt0", it_val.index),
                                         ("dec", it_val.index)),
                                        False, origin))
                self.auto.add_edge(Edge(header, x, EPS, "", item.pos,
                                        item.neg,
                                        (("eq0", it_val.index),),
                                        False, origin))
            else:
                self.auto.add_edge(Edge(header, b, EPS, "", item.pos,
                                        item.neg, (), False, origin))
                self.auto.add_edge(Edge(header, x, EPS, "", item.pos,
                                        item.neg, (), False, origin))
            body_item.state = b
            exits.append(item.fork(state=x))
        else:
            infinite = (isinstance(node.test, ast.Constant)
                        and node.test.value is True)
            if not infinite:
                x = self.auto.memo_state(
                    ("loop-done", header),
                    f"{ctx.func}:L{node.lineno}:done")
                self.auto.add_edge(Edge(header, x, EPS, "", item.pos,
                                        item.neg, (), False, origin))
                exits.append(item.fork(state=x))
        falls = self._run_block(node.body, [body_item], ctx, returns,
                                breaks, continues)
        for it in falls + continues:
            self._flush_pending(it, origin)
            self.auto.add_edge(Edge(it.state, header, EPS, "", it.pos,
                                    it.neg, (), False, origin))
        return exits + breaks

    def _catches_eos(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        names: list[str] = []
        if t is None:
            return False
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        for e in elts:
            chain = attr_chain(e)
            if chain:
                names.append(chain[-1])
        return bool(set(names) & _EOS_EXC_NAMES)

    def _do_try(self, node: ast.Try, item: _Item, ctx: "_Ctx",
                returns: list, breaks: list,
                continues: list) -> list[_Item]:
        eos_handler = next((h for h in node.handlers
                            if self._catches_eos(h)), None)
        h_entry: Optional[int] = None
        if eos_handler is not None:
            h_entry = self.auto.memo_state(
                ("on-eof", ctx.relpath, node.lineno),
                f"{ctx.func}:L{node.lineno}:on-eof")
        body_item = item.fork(
            eos=h_entry if h_entry is not None else item.eos)
        falls = self._run_block(node.body, [body_item], ctx, returns,
                                breaks, continues)
        out = [it.fork(eos=item.eos) for it in falls]
        if eos_handler is not None:
            hitem = item.fork(state=h_entry)
            out += self._run_block(eos_handler.body, [hitem], ctx,
                                   returns, breaks, continues)
        return out

    def _do_assign(self, target: ast.expr, value: ast.expr, item: _Item,
                   ctx: "_Ctx") -> list[_Item]:
        names: list[Optional[str]] = []
        if isinstance(target, ast.Name):
            names = [target.id]
        elif isinstance(target, ast.Tuple):
            names = [e.id if isinstance(e, ast.Name) else None
                     for e in target.elts]
        if self._recv_assign(value, names, item, ctx):
            for i, n in enumerate(names):
                if n and not (i == 0 and isinstance(item.env.get(n),
                                                    RxSel)):
                    item.env.pop(n, None)
            return [item]
        v = self._unwrap(value)
        if isinstance(v, ast.Call):
            chain = attr_chain(v.func)
            if chain and chain[-1] == "unpack" and len(chain) > 1 \
                    and v.args and isinstance(v.args[0], ast.Name) \
                    and isinstance(item.env.get(v.args[0].id), RxSel):
                sel = item.env.pop(v.args[0].id)
                if names and names[0]:
                    item.env[names[0]] = sel
                return [item]
            if chain and chain[-1] == "get" and len(chain) == 2 \
                    and len(v.args) >= 1 and isinstance(v.args[0],
                                                        ast.Name) \
                    and names and names[0]:
                keys = self._module_dict_keys(chain[0], ctx)
                if keys is not None:
                    item.env[names[0]] = Probe(v.args[0].id, keys)
                    return [item]
            spliced = self._try_splice(v, item, ctx)
            if spliced is not None:
                out: list[_Item] = []
                for ex, rv in spliced:
                    self._bind(ex, names, rv)
                    out.append(ex)
                return out
        val = self._eval(value, item)
        if isinstance(val, Ctr):
            origin = self._origin(ctx.relpath, value)
            dst = self.auto.memo_state(
                ("reset", item.state, val.index),
                f"{ctx.func}:L{getattr(value, 'lineno', 0)}:reset")
            self.auto.add_edge(Edge(item.state, dst, EPS, "", item.pos,
                                    item.neg, (("reset", val.index),),
                                    False, origin))
            item.state = dst
        self._bind(item, names, val if len(names) == 1 else None)
        if len(names) > 1:
            for n in names:
                if n:
                    item.env.pop(n, None)
        return [item]

    def _bind(self, item: _Item, names: list, rv) -> None:
        if len(names) == 1 and names[0]:
            item.env[names[0]] = rv
        elif len(names) > 1 and isinstance(rv, Tup) \
                and len(rv.items) == len(names):
            for n, v in zip(names, rv.items):
                if n:
                    item.env[n] = v

    def _module_dict_keys(self, dict_name: str,
                          ctx: "_Ctx") -> Optional[frozenset]:
        sf = self.project.file(ctx.relpath)
        if sf is None:
            return None
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == dict_name \
                    and isinstance(node.value, ast.Dict):
                keys = set()
                for k in node.value.keys:
                    name = self._const_name(k) if k is not None else None
                    if name is None:
                        return None
                    keys.add(name)
                return frozenset(keys)
        return None

    def _do_expr(self, value: ast.expr, item: _Item,
                 ctx: "_Ctx") -> list[_Item]:
        v = self._unwrap(value)
        if not isinstance(v, ast.Call):
            return [item]
        chain = attr_chain(v.func)
        name = chain[-1] if chain else None
        origin = self._origin(ctx.relpath, v)
        if name in _SEND_BYTE:
            self._do_send_byte(v, item, origin)
            return [item]
        if name in _SEND_MANY:
            self._do_send_many(v, item, origin)
            return [item]
        if name == "write" and len(chain) >= 2 \
                and chain[-2] in ("writer", "w"):
            self._do_send_many(v, item, origin)
            return [item]
        if name in _RECV_BYTE | _RECV_EXACT:
            self._recv_assign(value, [], item, ctx)
            return [item]
        if name in _IGNORED_WIRE or name in ("drain", "close", "hit",
                                             "sleep", "record", "inc",
                                             "observe", "info", "debug",
                                             "warning"):
            return [item]
        if name in ("append", "extend") and len(chain) >= 2:
            ctr = item.env.get(chain[-2])
            if isinstance(ctr, Ctr):
                # count BEFORE any wire op in the argument: the inc
                # guard then bounds the window before the send fires,
                # keeping send/ack counts matched under the bound.
                dst = self.auto.memo_state(
                    ("inc", item.state, ctr.index),
                    f"{ctx.func}:L{getattr(v, 'lineno', 0)}:+1")
                self.auto.add_edge(Edge(item.state, dst, EPS, "",
                                        item.pos, item.neg,
                                        (("inc", ctr.index),),
                                        False, origin))
                item.state = dst
            items = [item]
            for a in v.args:
                aa = self._unwrap(a)
                if isinstance(aa, ast.Call):
                    nxt: list[_Item] = []
                    for it in items:
                        sp = self._try_splice(aa, it, ctx)
                        if sp is not None:
                            nxt.extend(ex for ex, _ in sp)
                        else:
                            self._do_expr(a, it, ctx)
                            nxt.append(it)
                    items = nxt
            return items
        spliced = self._try_splice(v, item, ctx)
        if spliced is not None:
            return [ex for ex, _ in spliced]
        return [item]

    # -- helper splicing --------------------------------------------------

    def _try_splice(self, call: ast.Call, item: _Item,
                    ctx: "_Ctx") -> Optional[list]:
        if ctx.depth <= 0:
            return None
        qual = self.graph.resolve_node(call)
        if qual is None:
            return None
        info = self.graph.function(qual)
        if info is None or qual in ctx.active:
            return None
        return self._call_function(info, qual, call, item, ctx)

    def _call_function(self, info, qual: str, call: Optional[ast.Call],
                       item: _Item, ctx: "_Ctx") -> list:
        self._flush_pending(item, (info.relpath, info.node.lineno))
        params = [a.arg for a in info.node.args.args]
        if info.cls and params and params[0] in ("self", "cls"):
            params = params[1:]
        env: dict = {}
        if call is not None:
            pos_args = [a for a in call.args
                        if not isinstance(a, ast.Starred)]
            for p, a in zip(params, pos_args):
                env[p] = self._eval(a, item)
            for kw in call.keywords:
                if kw.arg:
                    env[kw.arg] = self._eval(kw.value, item)
        cctx = _Ctx(info.relpath, info.cls, info.name, ctx.depth - 1,
                    ctx.active | {qual})
        entry = item.fork(env=env, pending=None)
        returns: list = []
        falls = self._run_block(info.node.body, [entry], cctx, returns,
                                [], [])
        out: list = []
        end_origin = (info.relpath, info.node.lineno)
        for it in falls:
            self._flush_pending(it, end_origin)
            out.append((self._restore(it, item), frozenset({"None"})))
        for it, rv in returns:
            self._flush_pending(it, end_origin)
            out.append((self._restore(it, item), rv))
        return out

    def _restore(self, ex: _Item, caller: _Item) -> _Item:
        return caller.fork(state=ex.state, pos=ex.pos, neg=ex.neg,
                           pending=None)

    def splice_qualname(self, qual: str, item: _Item,
                        depth: int = _SPLICE_DEPTH) -> Optional[list]:
        info = self.graph.function(qual)
        if info is None:
            return None
        ctx = _Ctx(info.relpath, info.cls, info.name, depth,
                   frozenset({qual}))
        return self._call_function(info, qual, None, item, ctx)


@dataclass(frozen=True)
class _Ctx:
    relpath: str
    cls: Optional[str]
    func: str
    depth: int
    active: frozenset = frozenset()


def _target_names(target: ast.expr) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, ast.Tuple):
        out: list[str] = []
        for e in target.elts:
            out.extend(_target_names(e))
        return out
    return []

# -- endpoint builders ------------------------------------------------------

_CLIENT_SKIP_METHODS = {"connect", "close", "connected"}


def _class_methods(project: Project, relpath: str,
                   cls_name: str) -> list[ast.FunctionDef]:
    sf = project.file(relpath)
    if sf is None:
        return []
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return [n for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))]
    return []


def _is_property(fn: ast.AST) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in getattr(fn, "decorator_list", []))


def build_session_pair(project: Project) -> Optional[EndpointPair]:
    """The persistent-session exchange: ``DistributerSession`` (every
    public wire method reachable from a hub state, modelling the owner
    thread's free interleaving) vs ``Distributer._handle_session``."""
    graph = callgraph.graph_for(project)
    client_rel = f"{PACKAGE}/worker/client.py"
    connect_qual = f"{CLIENT_SESSION_CLASS}.connect"
    if graph.function(connect_qual) is None \
            or graph.function(SERVER_SESSION_HANDLER) is None:
        return None

    # client: connect -> hub -> {public methods} -> hub -> EOS
    a = Automaton("session", "client")
    ex = Extractor(project, a)
    item0 = _Item(a.start, {}, frozenset(), frozenset())
    res = ex.splice_qualname(connect_qual, item0) or []
    hub = a.new_state("session-hub")
    closed = a.new_state("closed")
    legacy = a.new_state("legacy-fallback")
    a.done |= {closed, legacy}
    cinfo = graph.function(connect_qual)
    syn = (cinfo.relpath, cinfo.node.lineno)
    for it, rv in res:
        vals = rv if isinstance(rv, frozenset) else frozenset({"True",
                                                               "False"})
        if "False" in vals:
            a.add_edge(Edge(it.state, legacy, EPS, "", it.pos, it.neg,
                            (), False, syn))
        if vals - {"False", "None"}:
            a.add_edge(Edge(it.state, hub, EPS, "", it.pos, it.neg,
                            (), False, syn))
    for fn in _class_methods(project, client_rel, "DistributerSession"):
        if fn.name.startswith("_") or fn.name in _CLIENT_SKIP_METHODS \
                or _is_property(fn):
            continue
        qual = f"{CLIENT_SESSION_CLASS}.{fn.name}"
        mres = ex.splice_qualname(qual, _Item(hub, {}, frozenset(),
                                              frozenset())) or []
        for it, _rv in mres:
            a.add_edge(Edge(it.state, hub, EPS, "", it.pos, it.neg,
                            (), False, (client_rel, fn.lineno)))
    a.add_edge(Edge(hub, closed, SEND, EOS, origin=syn))

    # server: accept-loop purpose byte, then the session handler
    s = Automaton("session", "server")
    sx = Extractor(project, s)
    sinfo = graph.function(SERVER_SESSION_HANDLER)
    sorigin = (sinfo.relpath, sinfo.node.lineno)
    h0 = s.new_state("session-accepted")
    s.add_edge(Edge(s.start, h0, RECV, "PURPOSE_SESSION", origin=sorigin))
    sdone = s.new_state("session-done")
    s.done.add(sdone)
    s.add_edge(Edge(s.start, sdone, RECV, EOS, fault=True, origin=sorigin))
    sres = sx.splice_qualname(SERVER_SESSION_HANDLER,
                              _Item(h0, {}, frozenset(), frozenset())) or []
    for it, _rv in sres:
        s.add_edge(Edge(it.state, sdone, EPS, "", it.pos, it.neg,
                        (), False, sorigin))
    return EndpointPair("session", "session", a, s)


def build_query_pairs(project: Project) -> list[EndpointPair]:
    """One pair per :data:`rules_proto.QUERY_EXCHANGES` row whose two
    endpoints both exist in the project."""
    from distributedmandelbrot_tpu_torch.analysis.rules_proto import \
        QUERY_EXCHANGES
    graph = callgraph.graph_for(project)
    pairs: list[EndpointPair] = []
    for label, client_qual, server_qual in QUERY_EXCHANGES:
        cinfo = graph.function(client_qual)
        sinfo = graph.function(server_qual)
        if cinfo is None or sinfo is None:
            continue
        a = Automaton(label, "client")
        ex = Extractor(project, a)
        corigin = (cinfo.relpath, cinfo.node.lineno)
        res = ex.splice_qualname(client_qual,
                                 _Item(a.start, {}, frozenset(),
                                       frozenset())) or []
        pre = a.new_state("exchange-done")
        closed = a.new_state("closed")
        a.done.add(closed)
        for it, _rv in res:
            a.add_edge(Edge(it.state, pre, EPS, "", it.pos, it.neg,
                            (), False, corigin))
        a.add_edge(Edge(pre, closed, SEND, EOS, origin=corigin))

        s = Automaton(label, "server")
        sx = Extractor(project, s)
        sorigin = (sinfo.relpath, sinfo.node.lineno)
        sdone = s.new_state("served")
        s.done.add(sdone)
        s.add_edge(Edge(s.start, sdone, RECV, EOS, fault=True,
                        origin=sorigin))
        sres = sx.splice_qualname(server_qual,
                                  _Item(s.start, {}, frozenset(),
                                        frozenset())) or []
        for it, _rv in sres:
            s.add_edge(Edge(it.state, sdone, EPS, "", it.pos, it.neg,
                            (), False, sorigin))
        pairs.append(EndpointPair(label, "query", a, s))
    return pairs


def build_pairs(project: Project) -> list[EndpointPair]:
    """Every extractable exchange of the project, session pair first."""
    pairs: list[EndpointPair] = []
    session = build_session_pair(project)
    if session is not None:
        pairs.append(session)
    pairs.extend(build_query_pairs(project))
    return pairs


# -- DOT export -------------------------------------------------------------

def _dot_edge_label(e: Edge) -> str:
    if e.kind == SEND:
        lab = f"!{e.label}"
    elif e.kind == RECV:
        lab = f"?{e.label}"
    else:
        lab = "eps"
    guards = [f"+{g}" for g in sorted(e.pos)]
    guards += [f"-{g}" for g in sorted(e.neg)]
    guards += [f"{op} c{k}" for op, k in e.cops]
    if guards:
        lab += " [" + " ".join(guards) + "]"
    return lab


def to_dot(pairs: Sequence[EndpointPair]) -> str:
    """Graphviz digraph of every automaton, one cluster per endpoint.
    ``!X`` are sends, ``?X`` receives, dashed edges fault transitions."""
    lines = ["digraph fsm {", "  rankdir=LR;", "  node [shape=circle];"]
    for pi, pair in enumerate(pairs):
        for auto in (pair.client, pair.server):
            cid = f"cluster_{pi}_{auto.role}"
            lines.append(f"  subgraph {cid} {{")
            lines.append(f'    label="{pair.name} {auto.role}";')
            prefix = f"p{pi}{auto.role[0]}"
            used = {auto.start} | auto.done
            for e in auto.edges:
                used |= {e.src, e.dst}
            for st in sorted(used):
                name = auto.state_names.get(st, str(st)).replace('"', "'")
                shape = ("doublecircle" if st in auto.done else "circle")
                lines.append(f'    {prefix}_{st} [label="{name}" '
                             f'shape={shape}];')
            for e in auto.edges:
                style = ' style=dashed' if e.fault else ''
                lines.append(
                    f'    {prefix}_{e.src} -> {prefix}_{e.dst} '
                    f'[label="{_dot_edge_label(e)}"{style}];')
            lines.append("  }")
    lines.append("}")
    return "\n".join(lines) + "\n"
