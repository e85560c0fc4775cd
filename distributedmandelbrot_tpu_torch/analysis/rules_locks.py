"""Lock-discipline rules for the threaded layers.

``lock-guard`` — per-class inference: an attribute accessed under a
``with self.<lock>:`` block anywhere in the class is *guarded* by that
lock; a mutation of a guarded attribute while NOT holding its lock
(outside ``__init__`` — construction is single-threaded) is flagged.
The inference is deliberately evidence-based rather than annotation-
based: the codebase's convention IS the spec, and the rule catches the
one call site that forgets it.

``lock-order`` — a global lock-acquisition-order graph: acquiring lock B
while holding lock A adds edge ``A -> B``.  Edges come from lexical
``with`` nesting AND from the call graph: a call made under lock A
contributes edges from A to every lock the callee acquires
*transitively* (``analysis/callgraph.py``), so a cross-class inversion
hidden behind two helper hops is still a cycle.  Any cycle is a
deadlock risk.  Nodes are ``ClassName.lockattr``.

``lock-held-blocking`` — a call that can block indefinitely (queue
``get``/``put``, thread ``join``, semaphore ``acquire``, client
request/submit network exchanges, ``time.sleep``, event ``wait``) made
while a lock is held.  Since v2 the rule is interprocedural: a call
site under a lock is also flagged when the *callee* — or anything the
callee transitively reaches through resolvable calls — performs one of
the blocking operations, with the call path named in the message.  A
one-level wrapper no longer defeats the rule.  The stage-queue
pipeline's discipline is that every blocking wait happens OUTSIDE the
window lock — one queue ``get`` under it and the whole executor
convoys.  Calls on the held lock itself (``cond.wait`` / ``notify`` —
which release it) are sanctioned; unresolvable calls (callbacks,
``getattr``) are not searched, which keeps the rule quiet rather than
paranoid.

Scope: coordinator/, storage/, serve/, obs/, worker/ — the modules
where the asyncio loop and worker/pipeline threads genuinely share
state.
"""

from __future__ import annotations

import ast
from collections import Counter as _TallyCounter
from typing import Optional

from distributedmandelbrot_tpu_torch.analysis import callgraph
from distributedmandelbrot_tpu_torch.analysis.astutil import (FunctionNode,
                                                        cached_walk,
                                                        call_chain,
                                                        class_defs,
                                                        methods_of, self_attr,
                                                        subscript_base_self_attr)
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project, Rule,
                                                       SourceFile)

RULES = (
    Rule("lock-guard", "locks", "error",
         "mutation of a lock-guarded attribute without holding its lock"),
    Rule("lock-order", "locks", "warning",
         "cycle in the lock acquisition-order graph (deadlock risk)"),
    Rule("lock-held-blocking", "locks", "error",
         "potentially unbounded blocking call while holding a lock"),
)

SCOPE_DIRS = ("coordinator", "storage", "serve", "obs", "worker")

# Method calls that mutate their receiver in place.
MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "move_to_end", "sort", "reverse",
})


def _blocking_under_lock(chain: list[str]) -> Optional[str]:
    """Message when the call chain is a recognizably blocking operation
    (receiver-name heuristics keep ``dict.get`` and scheduler
    ``acquire`` — pure in-memory — out of it); None otherwise."""
    if chain == ["time", "sleep"]:
        return "time.sleep() under a lock stalls every other holder"
    if len(chain) < 2:
        return None
    recv = chain[-2].lower()
    last = chain[-1]
    if last in ("get", "put") and (
            recv in ("q", "queue") or recv.endswith("_q")
            or "queue" in recv):
        return (f"queue .{last}() can block indefinitely; move it "
                f"outside the lock")
    if last == "join" and "thread" in recv:
        return "thread .join() under a lock invites a deadlock"
    if last == "acquire" and "sem" in recv:
        return ("semaphore .acquire() under a lock blocks every other "
                "holder until a permit frees")
    if last == "wait" and ("stop" in recv or "event" in recv):
        return ("event .wait() under a lock stalls every other holder "
                "for the full wait")
    if last in ("request", "request_batch", "submit", "submit_batch") \
            and "client" in recv:
        return (f"network exchange .{last}() under a lock serializes "
                f"the pipeline on the round-trip")
    return None


class _ClassAnalysis:
    """Everything the two rules need from one class body."""

    def __init__(self, sf: SourceFile, cls: ast.ClassDef) -> None:
        self.sf = sf
        self.cls = cls
        self.lock_attrs = self._find_lock_attrs()
        # attr -> tally of the lock(s) held when it was accessed under one
        self.guard_evidence: dict[str, _TallyCounter] = {}
        # (attr, line, held, method) for every mutation site
        self.mutations: list[tuple[str, int, tuple[str, ...], str]] = []
        # lock -> lock lexical acquisition edges, with first line seen
        self.edges: dict[tuple[str, str], int] = {}
        # locks each method acquires directly
        self.method_locks: dict[str, set[str]] = {}
        # (held locks, call node) — every call made under a lock that was
        # neither flagged directly nor sanctioned; the interprocedural
        # pass resolves these through the call graph
        self.calls_held: list[tuple[tuple[str, ...], ast.Call]] = []
        # (line, innermost lock, message) — blocking call under a lock
        self.blocking: list[tuple[int, str, str]] = []
        for meth in methods_of(cls):
            self.method_locks.setdefault(meth.name, set())
            self._walk(meth, meth)

    def _find_lock_attrs(self) -> set[str]:
        """An attribute used as a bare ``with self.X:`` context anywhere
        in the class is a lock (covers both ``self._lock = Lock()`` and
        locks injected through ``__init__`` parameters)."""
        locks: set[str] = set()
        for node in cached_walk(self.cls):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = self_attr(item.context_expr)
                    if attr is not None:
                        locks.add(attr)
        return locks

    # -- the walk ---------------------------------------------------------

    def _walk(self, meth: FunctionNode, root: FunctionNode) -> None:
        def visit(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner_held = held
                for item in node.items:
                    attr = self_attr(item.context_expr)
                    if attr is not None and attr in self.lock_attrs:
                        for outer in inner_held:
                            self.edges.setdefault(
                                (outer, attr), item.context_expr.lineno)
                        self.method_locks[meth.name].add(attr)
                        inner_held = inner_held + (attr,)
                    else:
                        visit(item.context_expr, held)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held)
                for stmt in node.body:
                    visit(stmt, inner_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not root:
                # A nested def's body runs at some later call, not under
                # the locks lexically around its definition — analyzing
                # it here would produce both false hits and false passes.
                return
            self._inspect(node, held, meth.name)
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in meth.body:
            visit(stmt, ())

    def _inspect(self, node: ast.AST, held: tuple[str, ...],
                 method: str) -> None:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                self._mutation_target(target, held, method)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if getattr(node, "value", None) is not None \
                    or isinstance(node, ast.AugAssign):
                self._mutation_target(node.target, held, method)
        elif isinstance(node, ast.Delete):
            for target in node.targets:
                self._mutation_target(target, held, method)
        elif isinstance(node, ast.Call):
            chain = call_chain(node)
            if chain and held:
                # Calls on a lock we HOLD are the sanctioned Condition
                # protocol (wait/notify release-and-reacquire).
                on_held_lock = (chain[0] == "self" and len(chain) >= 3
                                and chain[1] in held)
                msg = None if on_held_lock else _blocking_under_lock(chain)
                if msg is not None:
                    self.blocking.append((node.lineno, held[-1], msg))
                elif not on_held_lock:
                    self.calls_held.append((held, node))
            if chain and chain[0] == "self" and len(chain) >= 3 \
                    and chain[-1] in MUTATORS:
                self._record_mutation(chain[1], node.lineno, held, method)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) and held:
            attr = self_attr(node)
            if attr is not None and attr not in self.lock_attrs:
                tally = self.guard_evidence.setdefault(attr, _TallyCounter())
                tally[held[-1]] += 0  # presence only; reads don't pick a lock
                tally.update([held[-1]])

    def _mutation_target(self, target: ast.expr, held: tuple[str, ...],
                         method: str) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mutation_target(elt, held, method)
            return
        attr = self_attr(target)
        if attr is None:
            attr = subscript_base_self_attr(target)
        if attr is not None and attr not in self.lock_attrs:
            self._record_mutation(attr, target.lineno, held, method)

    def _record_mutation(self, attr: str, line: int, held: tuple[str, ...],
                         method: str) -> None:
        self.mutations.append((attr, line, held, method))
        if held:
            self.guard_evidence.setdefault(
                attr, _TallyCounter()).update([held[-1]])


class _Summaries:
    """Per-function facts the interprocedural pass propagates: blocking
    operations a function performs directly, and locks it acquires
    directly — computed for EVERY function in the package (a scope-dir
    method may reach its blocking op through a helper anywhere)."""

    def __init__(self, project: Project) -> None:
        self.graph = callgraph.graph_for(project)
        self.own_blocking: dict[str, list[tuple[int, str]]] = {}
        self.own_locks: dict[str, set[str]] = {}
        self._reach: dict[str, dict[str, tuple[str, ...]]] = {}
        class_locks: dict[tuple[str, Optional[str]], set[str]] = {}
        for qual, fi in self.graph.functions.items():
            key = (fi.relpath, fi.cls)
            if key not in class_locks:
                info = self.graph.class_info(fi.relpath, fi.cls) \
                    if fi.cls else None
                class_locks[key] = _bare_with_attrs(info.node) \
                    if info is not None else set()
            locks = class_locks[key]
            blocking: list[tuple[int, str]] = []
            acquired: set[str] = set()
            for node in _walk_own(fi.node):
                if isinstance(node, ast.Call):
                    chain = call_chain(node)
                    msg = _blocking_under_lock(chain) if chain else None
                    if msg is not None:
                        blocking.append((node.lineno, msg))
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        attr = self_attr(item.context_expr)
                        if attr is not None and attr in locks:
                            acquired.add(f"{fi.cls}.{attr}")
            if blocking:
                self.own_blocking[qual] = blocking
            if acquired:
                self.own_locks[qual] = acquired

    def reach(self, qual: str) -> dict[str, tuple[str, ...]]:
        if qual not in self._reach:
            self._reach[qual] = self.graph.reachable(qual)
        return self._reach[qual]

    def blocking_via(self, callee: str
                     ) -> Optional[tuple[tuple[str, ...], str]]:
        """(call path ending at the blocking function, message) for the
        nearest blocking operation reachable from ``callee``."""
        if callee in self.own_blocking:
            return (callee,), self.own_blocking[callee][0][1]
        for qual, path in self.reach(callee).items():  # BFS order
            if qual in self.own_blocking:
                return path + (qual,), self.own_blocking[qual][0][1]
        return None

    def locks_via(self, callee: str) -> set[str]:
        """Every ``Class.lock`` acquired by ``callee`` or anything it
        transitively reaches."""
        out = set(self.own_locks.get(callee, ()))
        for qual in self.reach(callee):
            out.update(self.own_locks.get(qual, ()))
        return out


def _walk_own(fn: FunctionNode) -> tuple:
    """Walk a function body without descending into nested defs or
    lambdas (their bodies run at some later call).  Built as a filter
    over :func:`cached_walk`'s preorder tuples — a nested def's subtree
    is the contiguous run of its own cached walk, so skipping it is an
    index jump instead of a re-traversal."""
    cached = getattr(fn, "_dmtpu_walk_own", None)
    if cached is not None:
        return cached
    skip = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    out: list = []
    for stmt in fn.body:
        nodes = cached_walk(stmt)
        i, n = 0, len(nodes)
        while i < n:
            node = nodes[i]
            if isinstance(node, skip):
                i += len(node._dmtpu_walk)
                continue
            out.append(node)
            i += 1
    fn._dmtpu_walk_own = tuple(out)
    return fn._dmtpu_walk_own


def _bare_with_attrs(cls: ast.ClassDef) -> set[str]:
    """Same lock-attr evidence as :meth:`_ClassAnalysis._find_lock_attrs`
    but usable for classes outside the findings scope."""
    locks: set[str] = set()
    for node in cached_walk(cls):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                attr = self_attr(item.context_expr)
                if attr is not None:
                    locks.add(attr)
    return locks


def _display(qual: str) -> str:
    return qual.rsplit("::", 1)[-1]


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    summaries = _Summaries(project)
    # Global acquisition-order graph: node "Class.lock" -> successors,
    # with the (path, line) of the first edge for reporting.
    graph: dict[str, set[str]] = {}
    edge_site: dict[tuple[str, str], tuple[str, int]] = {}

    for sf in project.in_dirs(*SCOPE_DIRS):
        for cls in class_defs(sf.tree):
            info = _ClassAnalysis(sf, cls)
            if not info.lock_attrs:
                continue
            findings.extend(_guard_findings(sf, cls, info))
            for line, lock, msg in info.blocking:
                findings.append(Finding(
                    "lock-held-blocking", "error", sf.relpath, line,
                    f"{msg} (holding {cls.name}.{lock})"))
            for (outer, inner), line in info.edges.items():
                a, b = f"{cls.name}.{outer}", f"{cls.name}.{inner}"
                graph.setdefault(a, set()).add(b)
                edge_site.setdefault((a, b), (sf.relpath, line))
            # Interprocedural: resolve every call made under a held lock
            # and search what it reaches for blocking ops + acquisitions.
            for held, call in info.calls_held:
                callee = summaries.graph.resolve_node(call)
                if callee is None:
                    continue
                hit = summaries.blocking_via(callee)
                if hit is not None:
                    path, msg = hit
                    findings.append(Finding(
                        "lock-held-blocking", "error", sf.relpath,
                        call.lineno,
                        f"{msg} — reached via "
                        f"{' -> '.join(_display(q) for q in path)}() "
                        f"(holding {cls.name}.{held[-1]})"))
                for b in summaries.locks_via(callee):
                    for outer in held:
                        a = f"{cls.name}.{outer}"
                        if a != b:
                            graph.setdefault(a, set()).add(b)
                            edge_site.setdefault((a, b),
                                                 (sf.relpath, call.lineno))

    findings.extend(_order_findings(graph, edge_site))
    return findings


def _guard_findings(sf: SourceFile, cls: ast.ClassDef,
                    info: _ClassAnalysis) -> list[Finding]:
    out: list[Finding] = []
    guard_lock = {attr: tally.most_common(1)[0][0]
                  for attr, tally in info.guard_evidence.items() if tally}
    for attr, line, held, method in info.mutations:
        if method == "__init__":
            continue
        lock = guard_lock.get(attr)
        if lock is None or lock in held:
            continue
        out.append(Finding(
            "lock-guard", "error", sf.relpath, line,
            f"{cls.name}.{attr} is guarded by self.{lock} elsewhere in the "
            f"class but mutated in {method}() without holding it"))
    return out


def _order_findings(graph: dict[str, set[str]],
                    edge_site: dict[tuple[str, str], tuple[str, int]]
                    ) -> list[Finding]:
    """Report each strongly connected component with a cycle once."""
    out: list[Finding] = []
    for scc in _sccs(graph):
        nodes = sorted(scc)
        has_cycle = len(nodes) > 1 or (
            nodes and nodes[0] in graph.get(nodes[0], ()))
        if not has_cycle:
            continue
        site = min((edge_site[(a, b)] for a in nodes
                    for b in graph.get(a, ()) if b in scc
                    and (a, b) in edge_site), default=("<unknown>", 1))
        out.append(Finding(
            "lock-order", "warning", site[0], site[1],
            "lock acquisition-order cycle (deadlock risk): "
            + " -> ".join(nodes + [nodes[0]])))
    return out


def _sccs(graph: dict[str, set[str]]) -> list[set[str]]:
    """Tarjan's strongly connected components, iterative."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[set[str]] = []
    counter = [0]
    all_nodes = set(graph) | {b for succ in graph.values() for b in succ}

    for start in sorted(all_nodes):
        if start in index:
            continue
        work: list[tuple[str, Optional[str], int]] = [(start, None, 0)]
        while work:
            node, parent, child_i = work.pop()
            if child_i == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            recurse = False
            successors = sorted(graph.get(node, ()))
            for i in range(child_i, len(successors)):
                succ = successors[i]
                if succ not in index:
                    work.append((node, parent, i + 1))
                    work.append((succ, node, 0))
                    recurse = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if recurse:
                continue
            if low[node] == index[node]:
                scc: set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
            if parent is not None:
                low[parent] = min(low[parent], low[node])
    return sccs
