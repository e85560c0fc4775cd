"""``proto-*`` rules: wire-exchange conformance over the call graph.

Every exchange in this system is implemented twice — a client emitter
(``worker/client.py``, ``viewer/client.py``) and a coordinator handler
(``coordinator/distributer.py``, ``coordinator/dataserver.py``) — plus
a legacy-degradation branch per side.  PR 3's ``wire-*`` family checks
the *struct formats* agree; this family checks the *conversation*
agrees:

- ``proto-dispatch``: every ``PURPOSE_*`` constant in the canonical
  protocol module has exactly one server dispatch arm
  (``purpose == proto.PURPOSE_X`` in an ``if`` test) and at least one
  client emitter (``send_byte(sock, proto.PURPOSE_X)``).  A new purpose
  byte with no dispatch arm is exactly the bug that silently drops the
  connection on a legacy coordinator.
- ``proto-frames``: the ordered frame sequence a client emits/awaits
  for an exchange must mirror what the matched dispatch arm
  reads/writes.  Sequences are extracted by walking each side's
  function body in source order — splicing resolvable callees via the
  call graph (``_handle_response`` is just ``_ingest_one``) — and
  normalizing each framing op to a symbol: ``BYTE``, ``U32``, a
  canonical struct name (``QUERY``, ``SPANS_HEADER``, …, via
  ``X_WIRE_SIZE`` / ``X.size`` / ``X.pack`` / ``.to_wire()``), or
  ``?`` for payloads whose size is data-dependent (``?`` matches
  anything).  Repeated symbols collapse to first occurrence, so loops
  and retry branches compare cleanly.
- ``proto-exact-read``: every ``X.unpack(...)`` / ``iter_unpack`` /
  ``unpack_from`` of a canonical struct must be fed by an exact-length
  framing read (``recv_exact`` / ``read_exact``) of that same struct's
  size — a raw ``sock.recv(n)`` feed is the classic short-read bug,
  and a read sized by a *different* struct is cross-copy drift.

Stream upgrades: a purpose byte listed in :data:`STREAM_FRAME_SYMBOLS`
turns the connection into a long-lived multiplexed frame stream after
its hello (``PURPOSE_SESSION``).  Source order stops modeling wire
order there — the server loops over interleaved frame types while the
client interleaves pipelined uploads with acks — so sequence parity
checks the hello prefix only: both sides' op lists are truncated at
the first op carrying the stream's frame-header struct
(``SESSION_FRAME``).  Everything inside the stream remains covered by
``proto-exact-read`` and the ``wire-*`` size checks.

Known resolution limit (documented in README): the gateway's
magic-sniffing dual framing (``serve/gateway.py`` reads a bare u32 and
*then* decides legacy-vs-batch) has no purpose byte, so it takes part
in ``proto-exact-read`` and the ``wire-*`` checks but not in sequence
parity.  The viewer<->dataserver query exchange has no purpose byte
either; it is paired explicitly via :data:`QUERY_EXCHANGES`.
"""

from __future__ import annotations

import ast
import struct as struct_mod
from dataclasses import dataclass, field
from typing import Iterator, Optional

from distributedmandelbrot_tpu_torch.analysis import callgraph
from distributedmandelbrot_tpu_torch.analysis.astutil import (attr_chain,
                                                        cached_walk)
from distributedmandelbrot_tpu_torch.analysis.engine import (PACKAGE, Finding,
                                                       Project, Rule)

RULES = (
    Rule("proto-dispatch", "proto", "error",
         "every PURPOSE_* constant needs exactly one server dispatch arm "
         "and at least one client emitter"),
    Rule("proto-frames", "proto", "error",
         "client and server frame sequences of a wire exchange must agree"),
    Rule("proto-exact-read", "proto", "error",
         "fixed-size struct unpack must be fed by an exact-length framing "
         "read of the same struct"),
)

PROTOCOL_SUFFIX = "net/protocol.py"

# Exchanges with no purpose byte, paired by hand: (label, client emitter
# qualname, server handler qualname).  Checked only when both sides
# exist in the project, so fixture projects are unaffected.
QUERY_EXCHANGES = (
    ("query",
     f"{PACKAGE}/viewer/client.py::DataClient._fetch_once",
     f"{PACKAGE}/coordinator/dataserver.py::DataServer._handle_connection"),
    # The rendered-tile framing: both qualnames cover the post-magic
    # exchange (the client's magic u32 is sent by its caller, mirroring
    # the server, whose accept loop consumes the magic before
    # dispatching to the handler).
    ("render_query",
     f"{PACKAGE}/viewer/client.py::DataClient._render_exchange",
     f"{PACKAGE}/serve/gateway.py::TileGateway._serve_render"),
    # The session framing: same magic-sent-by-caller convention as the
    # rendered exchange; the reply header (SESSION_REPLY) precedes the
    # standard status byte on both sides.
    ("session_query",
     f"{PACKAGE}/viewer/client.py::DataClient._session_exchange",
     f"{PACKAGE}/serve/gateway.py::TileGateway._serve_session"),
)

# Purpose bytes that upgrade the connection to a multiplexed frame
# stream after their hello, mapped to the stream's frame-header struct.
# Sequence parity for these compares the hello prefix only: both sides
# truncate at the first op carrying the frame-header symbol.
STREAM_FRAME_SYMBOLS = {"PURPOSE_SESSION": "SESSION_FRAME"}

# Exchanges INSIDE a multiplexed stream, paired by hand like
# QUERY_EXCHANGES: (label, client exchange method, server frame
# handler, frame-header struct).  The stream's frame header is read by
# the server's session loop but written by the client's exchange
# method, so ops carrying the header symbol are filtered from BOTH
# sides before comparison — the header itself stays covered by
# ``proto-exact-read`` and the ``wire-*`` size checks.  This is what
# extends full sequence parity to the batched lease frames
# (FRAME_LEASE_REQN/GRANTN), which the hello-prefix truncation above
# would otherwise leave unchecked.
SESSION_EXCHANGES = (
    ("lease_reqn",
     f"{PACKAGE}/worker/client.py::DistributerSession._request_batchn",
     f"{PACKAGE}/coordinator/distributer.py::"
     f"Distributer._session_lease_reqn",
     "SESSION_FRAME"),
    # The sharded control plane's ring exchange (FRAME_RING_REQ ->
    # FRAME_RING_INFO): the client's skew probe against the shard's
    # authoritative slice identity.
    ("ring_req",
     f"{PACKAGE}/worker/client.py::DistributerSession.ring_info",
     f"{PACKAGE}/coordinator/distributer.py::"
     f"Distributer._session_ring_req",
     "SESSION_FRAME"),
)

# Frame-sequence wildcard: a payload whose length is data-dependent.
WILD = "?"

_RECV_EXACT = {"recv_exact", "read_exact"}
_RECV_U32 = {"recv_u32", "read_u32"}
_RECV_BYTE = {"recv_byte", "read_byte"}
_SEND_U32 = {"send_u32", "write_u32"}
_SEND_BYTE = {"send_byte", "write_byte"}


@dataclass
class ProtoTable:
    """Canonical symbols parsed (never imported) from net/protocol.py."""

    relpath: str
    structs: dict[str, str] = field(default_factory=dict)  # name -> format
    purposes: dict[str, int] = field(default_factory=dict)  # name -> line

    def size_of(self, symbol: str) -> Optional[int]:
        if symbol == "BYTE":
            return 1
        if symbol == "U32":
            return 4
        fmt = self.structs.get(symbol)
        if fmt is None:
            return None
        try:
            return struct_mod.calcsize(fmt)
        except struct_mod.error:
            return None


def _load_table(project: Project) -> Optional[ProtoTable]:
    for rel in sorted(project.files):
        if rel.endswith(PROTOCOL_SUFFIX):
            break
    else:
        return None
    table = ProtoTable(rel)
    for node in project.files[rel].tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        value = node.value
        if (isinstance(value, ast.Call)
                and (attr_chain(value.func) or [""])[-1] == "Struct"
                and value.args
                and isinstance(value.args[0], ast.Constant)
                and isinstance(value.args[0].value, str)):
            table.structs[name] = value.args[0].value
        elif name.startswith("PURPOSE_"):
            table.purposes[name] = node.lineno
    return table


# -- frame-op extraction ---------------------------------------------------

@dataclass(frozen=True)
class Op:
    direction: str  # "send" | "recv"
    symbol: str


def _last(chain: Optional[list[str]]) -> str:
    return chain[-1] if chain else ""


def _purpose_arg(call: ast.Call, table: ProtoTable) -> Optional[str]:
    for arg in call.args:
        chain = attr_chain(arg)
        if chain and chain[-1] in table.purposes:
            return chain[-1]
    return None


class _Extractor:
    """Ordered frame ops per function, splicing resolvable callees."""

    def __init__(self, graph: callgraph.CallGraph, table: ProtoTable) -> None:
        self.graph = graph
        self.table = table
        self._memo: dict[str, tuple[list[Op], set[str]]] = {}
        self._stack: set[str] = set()
        self.emitters: dict[str, set[str]] = {}  # purpose -> emitter quals

    def function_ops(self, qual: str) -> tuple[list[Op], set[str]]:
        """(ordered frame ops, purpose bytes emitted) for a function."""
        if qual in self._memo:
            return self._memo[qual]
        if qual in self._stack:
            return [], set()
        info = self.graph.function(qual)
        if info is None:
            return [], set()
        self._stack.add(qual)
        ops, purposes = self.body_ops(info.node.body)
        self._stack.discard(qual)
        self._memo[qual] = (ops, purposes)
        for p in purposes:
            self.emitters.setdefault(p, set()).add(qual)
        return ops, purposes

    def body_ops(self, stmts: list[ast.stmt]) -> tuple[list[Op], set[str]]:
        ops: list[Op] = []
        purposes: set[str] = set()
        packbufs = self._packbufs(stmts)

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.Call):
                verdict = self._classify(node, packbufs)
                if verdict == "opaque":
                    return  # payload already counted (pack / purpose byte)
                if isinstance(verdict, str) and verdict in self.table.purposes:
                    purposes.add(verdict)
                    return
                if isinstance(verdict, Op):
                    ops.append(verdict)
                    return
                # Not a frame op: arguments evaluate first, then the
                # callee body runs — splice in that order.
                for child in ast.iter_child_nodes(node):
                    visit(child)
                callee = self.graph.resolve_node(node)
                if callee is not None:
                    # Splice the callee's frame ops, but NOT its emitted
                    # purposes: an emitter is the function whose own body
                    # sends the purpose byte, not every caller above it.
                    inner_ops, _ = self.function_ops(callee)
                    ops.extend(inner_ops)
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in stmts:
            visit(stmt)
        return ops, purposes

    @staticmethod
    def _packbufs(stmts: list[ast.stmt]) -> set[str]:
        """Local names built up via ``buf = bytearray(); buf += X.pack()``
        — their eventual ``send_all`` is skipped because each ``pack``
        already produced a send op in source order."""
        out: set[str] = set()
        for stmt in stmts:
            for node in cached_walk(stmt):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Call)
                        and _last(attr_chain(node.value.func)) == "bytearray"):
                    out.add(node.targets[0].id)
        return out

    def _classify(self, call: ast.Call, packbufs: set[str]):
        """Op for a frame call, a purpose name for a purpose-byte send,
        ``"opaque"`` for already-counted payloads, None otherwise."""
        chain = attr_chain(call.func)
        last = _last(chain)
        if last in _RECV_EXACT:
            size = call.args[1] if len(call.args) > 1 else None
            return Op("recv", self._symbol(size))
        if last in _RECV_U32:
            return Op("recv", "U32")
        if last in _RECV_BYTE:
            return Op("recv", "BYTE")
        if last in _SEND_U32:
            return Op("send", "U32")
        if last in _SEND_BYTE:
            purpose = _purpose_arg(call, self.table)
            return purpose if purpose is not None else Op("send", "BYTE")
        if last == "send_all":
            payload = call.args[1] if len(call.args) > 1 else None
            if payload is not None and self._is_packbuf(payload, packbufs):
                return "opaque"
            return Op("send", self._symbol(payload))
        if (last == "write" and chain is not None and len(chain) >= 2
                and "writer" in chain[-2]):
            payload = call.args[0] if call.args else None
            if payload is not None and self._is_packbuf(payload, packbufs):
                return "opaque"
            return Op("send", self._symbol(payload))
        if (last == "pack" and chain is not None and len(chain) >= 2
                and chain[-2] in self.table.structs):
            return Op("send", chain[-2])
        return None

    @staticmethod
    def _is_packbuf(expr: ast.expr, packbufs: set[str]) -> bool:
        if (isinstance(expr, ast.Call)
                and _last(attr_chain(expr.func)) == "bytes" and expr.args):
            expr = expr.args[0]
        return isinstance(expr, ast.Name) and expr.id in packbufs

    def _symbol(self, expr: Optional[ast.expr]) -> str:
        """Normalize a size/payload expression to a frame symbol."""
        if expr is None:
            return WILD
        if isinstance(expr, ast.Await):
            return self._symbol(expr.value)
        if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
            if expr.value == 1:
                return "BYTE"
            if expr.value == 4:
                return "U32"
            return f"BYTES:{expr.value}"
        if isinstance(expr, ast.BinOp):
            for side in (expr.right, expr.left):
                sym = self._symbol(side)
                if sym != WILD and not sym.startswith("BYTES:") \
                        and sym not in ("BYTE", "U32"):
                    return sym
            return WILD
        if isinstance(expr, ast.Call):
            chain = attr_chain(expr.func)
            last = _last(chain)
            if last == "to_wire":
                return "WORKLOAD"
            if (last == "pack" and chain is not None and len(chain) >= 2
                    and chain[-2] in self.table.structs):
                return chain[-2]
            return WILD
        chain = attr_chain(expr)
        if chain:
            last = chain[-1]
            if last.endswith("_WIRE_SIZE"):
                return last[:-len("_WIRE_SIZE")]
            if last == "size" and len(chain) >= 2 \
                    and chain[-2] in self.table.structs:
                return chain[-2]
            if last.isupper() and any(c.isalpha() for c in last):
                return last  # opaque named size (e.g. CHUNK_PIXELS)
        return WILD


# -- sequence comparison ---------------------------------------------------

def _stream_prefix(ops: list[Op], symbol: str) -> list[Op]:
    """Ops up to (excluding) the first one carrying a stream's
    frame-header struct — the point where source order stops modeling
    wire order (see :data:`STREAM_FRAME_SYMBOLS`)."""
    for i, op in enumerate(ops):
        if op.symbol == symbol:
            return ops[:i]
    return ops


def _first_occurrence(ops: list[Op], direction: str) -> list[str]:
    seen: list[str] = []
    for op in ops:
        if op.direction == direction and op.symbol not in seen:
            seen.append(op.symbol)
    return seen


def _compatible(a: str, b: str, table: ProtoTable) -> bool:
    if a == b or WILD in (a, b):
        return True
    for x, y in ((a, b), (b, a)):
        if x.startswith("BYTES:"):
            size = table.size_of(y)
            if size is not None:
                return int(x.split(":", 1)[1]) == size
            return True  # unknown named size: cannot judge, stay quiet
    sa, sb = table.size_of(a), table.size_of(b)
    if sa is None or sb is None:
        return True  # at least one side opaque — conservative
    return sa == sb


def _sequence_mismatch(client: list[str], server: list[str],
                       table: ProtoTable) -> bool:
    if len(client) != len(server):
        return True
    return any(not _compatible(c, s, table)
               for c, s in zip(client, server))


# -- dispatch-arm discovery ------------------------------------------------

def _purpose_tests(test: ast.expr, table: ProtoTable) -> set[str]:
    """PURPOSE_* names an ``if`` test dispatches on (handles the
    ``purpose == proto.PURPOSE_X and self.accept_spans`` shape and
    membership tests over tuples)."""
    out: set[str] = set()
    for node in cached_walk(test):
        if isinstance(node, ast.Compare):
            for expr in [node.left, *node.comparators]:
                for sub in cached_walk(expr):
                    chain = attr_chain(sub) if isinstance(
                        sub, (ast.Name, ast.Attribute)) else None
                    if chain and chain[-1] in table.purposes:
                        out.add(chain[-1])
    return out


@dataclass
class _Arm:
    purpose: str
    relpath: str
    line: int
    body: list[ast.stmt]


def _dispatch_arms(graph: callgraph.CallGraph,
                   table: ProtoTable) -> list[_Arm]:
    arms: list[_Arm] = []
    for info in graph.functions.values():
        for node in cached_walk(info.node):
            if not isinstance(node, ast.If):
                continue
            for purpose in sorted(_purpose_tests(node.test, table)):
                arms.append(_Arm(purpose, info.relpath, node.lineno,
                                 node.body))
    return arms


# -- proto-exact-read ------------------------------------------------------

_UNPACKERS = {"unpack", "unpack_from", "iter_unpack"}


def _find_read_call(expr: ast.expr) -> Optional[ast.Call]:
    """The framing read (or raw ``.recv``) feeding an expression."""
    for node in cached_walk(expr):
        if isinstance(node, ast.Call):
            last = _last(attr_chain(node.func))
            if last in _RECV_EXACT or last == "recv":
                return node
    return None


def _feeding_exprs(fn: callgraph.FunctionNode,
                   name: str) -> Iterator[ast.expr]:
    """Every expression assigned to a local name in a function
    (both branches of ``x = A if cond else B``)."""
    for node in cached_walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            value = node.value
            if isinstance(value, ast.IfExp):
                yield value.body
                yield value.orelse
            else:
                yield value


def _exact_read_findings(graph: callgraph.CallGraph, table: ProtoTable,
                         extractor: _Extractor) -> Iterator[Finding]:
    rule = RULES[2]
    for info in graph.functions.values():
        for node in cached_walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if not (chain and len(chain) >= 2
                    and chain[-1] in _UNPACKERS
                    and chain[-2] in table.structs and node.args):
                continue
            struct_name = chain[-2]
            arg = node.args[0]
            feeds = ([arg] if not isinstance(arg, ast.Name)
                     else list(_feeding_exprs(info.node, arg.id)))
            for feed in feeds:
                read = _find_read_call(feed)
                if read is None:
                    continue  # param-fed or sliced — conservative
                if _last(attr_chain(read.func)) == "recv":
                    yield Finding(
                        rule.id, rule.severity, info.relpath, node.lineno,
                        f"{struct_name}.{chain[-1]} fed by raw .recv() — "
                        f"use an exact-length framing read "
                        f"(recv_exact/read_exact)")
                    continue
                size_expr = read.args[1] if len(read.args) > 1 else None
                sym = extractor._symbol(size_expr)
                if sym in (WILD, struct_name):
                    continue
                expected = table.size_of(struct_name)
                got = (int(sym.split(":", 1)[1])
                       if sym.startswith("BYTES:") else table.size_of(sym))
                if got is not None and expected is not None \
                        and got == expected:
                    continue
                yield Finding(
                    rule.id, rule.severity, info.relpath, node.lineno,
                    f"{struct_name}.{chain[-1]} fed by a read sized as "
                    f"{sym}, not {struct_name}")


# -- entry point -----------------------------------------------------------

def check(project: Project) -> list[Finding]:
    table = _load_table(project)
    if table is None:
        return []
    graph = callgraph.graph_for(project)
    extractor = _Extractor(graph, table)
    # Walk every function once so emitter registration is complete.
    for qual in list(graph.functions):
        extractor.function_ops(qual)

    findings: list[Finding] = []
    dispatch_rule, frames_rule = RULES[0], RULES[1]
    arms = _dispatch_arms(graph, table)
    arms_by_purpose: dict[str, list[_Arm]] = {}
    for arm in arms:
        arms_by_purpose.setdefault(arm.purpose, []).append(arm)

    for purpose, line in sorted(table.purposes.items()):
        n_arms = len(arms_by_purpose.get(purpose, []))
        if n_arms == 0:
            findings.append(Finding(
                dispatch_rule.id, dispatch_rule.severity, table.relpath,
                line, f"{purpose} has no server dispatch arm"))
        elif n_arms > 1:
            findings.append(Finding(
                dispatch_rule.id, "warning", table.relpath, line,
                f"{purpose} has {n_arms} server dispatch arms "
                f"(expected exactly one)"))
        if not extractor.emitters.get(purpose):
            findings.append(Finding(
                dispatch_rule.id, dispatch_rule.severity, table.relpath,
                line, f"{purpose} has no client emitter"))

    # Frame-sequence parity: each emitter against each dispatch arm.
    for purpose, emitter_quals in sorted(extractor.emitters.items()):
        stream_symbol = STREAM_FRAME_SYMBOLS.get(purpose)
        for arm in arms_by_purpose.get(purpose, []):
            server_ops, _ = extractor.body_ops(arm.body)
            if stream_symbol is not None:
                server_ops = _stream_prefix(server_ops, stream_symbol)
            for emitter in sorted(emitter_quals):
                client_ops, _ = extractor.function_ops(emitter)
                if stream_symbol is not None:
                    client_ops = _stream_prefix(client_ops, stream_symbol)
                findings.extend(_frame_findings(
                    purpose, emitter, client_ops, arm.relpath, arm.line,
                    server_ops, table, frames_rule))

    for label, client_qual, server_qual in QUERY_EXCHANGES:
        if graph.function(client_qual) is None \
                or graph.function(server_qual) is None:
            continue
        client_ops, _ = extractor.function_ops(client_qual)
        server_ops, _ = extractor.function_ops(server_qual)
        server_info = graph.function(server_qual)
        findings.extend(_frame_findings(
            label, client_qual, client_ops, server_info.relpath,
            server_info.node.lineno, server_ops, table, frames_rule))

    for label, client_qual, server_qual, frame_symbol in SESSION_EXCHANGES:
        if graph.function(client_qual) is None \
                or graph.function(server_qual) is None:
            continue
        client_ops = [op for op in extractor.function_ops(client_qual)[0]
                      if op.symbol != frame_symbol]
        server_ops = [op for op in extractor.function_ops(server_qual)[0]
                      if op.symbol != frame_symbol]
        server_info = graph.function(server_qual)
        findings.extend(_frame_findings(
            label, client_qual, client_ops, server_info.relpath,
            server_info.node.lineno, server_ops, table, frames_rule))

    findings.extend(_exact_read_findings(graph, table, extractor))
    return findings


def _frame_findings(label: str, emitter: str, client_ops: list[Op],
                    server_relpath: str, server_line: int,
                    server_ops: list[Op], table: ProtoTable,
                    rule: Rule) -> Iterator[Finding]:
    emitter_name = emitter.rsplit("::", 1)[-1]
    pairs = (("send", "recv", "client sends", "server reads"),
             ("recv", "send", "client awaits", "server writes"))
    for cdir, sdir, clabel, slabel in pairs:
        cseq = _first_occurrence(client_ops, cdir)
        sseq = _first_occurrence(server_ops, sdir)
        if _sequence_mismatch(cseq, sseq, table):
            yield Finding(
                rule.id, rule.severity, server_relpath, server_line,
                f"{label}: {clabel} [{', '.join(cseq) or '-'}] "
                f"({emitter_name}) but {slabel} "
                f"[{', '.join(sseq) or '-'}]")
