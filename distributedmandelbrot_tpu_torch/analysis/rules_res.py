"""``res-*`` rules: resource lifecycle (threads, sockets, queues, servers).

The farm's availability bugs are rarely logic errors — they are leaked
lifecycles: a non-daemon thread that pins the interpreter after the
worker crashes, a socket dialed outside ``with`` that survives an
exception, an unbounded stage queue that absorbs a stalled consumer
until the host OOMs, a server object nothing ever closes.  These rules
encode the project's lifecycle conventions:

- ``res-thread-join``: every ``threading.Thread(...)`` is either
  ``daemon=True`` or joined — on the name it was assigned to (locals
  and ``self.*`` attrs), through a list iterated by a ``for`` loop
  (``for t in threads: t.join()``), or built via ``threads.append``.
  A thread with no handle at all (``Thread(...).start()``) can never be
  joined and is flagged unless daemonized.
- ``res-socket-close``: a socket / file assigned to a local
  (``create_connection``, ``socket.socket``, ``open``) must be closed
  on some path, used as a context manager, or escape the function
  (returned, stored on ``self``, or passed onward — the caller then
  owns the lifecycle, as ``DistributerClient._connect`` does).
- ``res-queue-unbounded``: a ``queue.Queue()`` with no ``maxsize`` in
  the runtime dirs.  Unbounded queues are legal only when some *other*
  mechanism bounds what producers enqueue (the pipeline executor's
  in-flight window) — that claim belongs next to the queue as an
  audited suppression, not in a reviewer's head.
- ``res-shutdown``: a class that stores a ``ThreadPoolExecutor`` or an
  ``asyncio.start_server`` result on ``self`` must also call
  ``.shutdown()`` / ``.close()`` on it somewhere — no server object
  without a stop path.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from distributedmandelbrot_tpu_torch.analysis.astutil import (FunctionNode,
                                                        attr_chain,
                                                        cached_walk,
                                                        class_defs,
                                                        methods_of)
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project,
                                                       Rule, SourceFile)

RULES = (
    Rule("res-thread-join", "res", "error",
         "threads must be daemonized or joined on every handle"),
    Rule("res-socket-close", "res", "warning",
         "sockets/files acquired outside a context manager must be "
         "closed or handed off"),
    Rule("res-queue-unbounded", "res", "warning",
         "queue.Queue() without maxsize needs an audited bounding story"),
    Rule("res-shutdown", "res", "warning",
         "executors and servers stored on self need a shutdown path"),
)

SCOPE_DIRS = ("coordinator", "storage", "serve", "obs", "worker", "viewer",
              "net")


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.in_dirs(*SCOPE_DIRS):
        findings.extend(_thread_findings(sf))
        findings.extend(_socket_findings(sf))
        findings.extend(_queue_findings(sf))
        findings.extend(_shutdown_findings(sf))
    return findings


def _functions(sf: SourceFile) -> Iterator[tuple[Optional[ast.ClassDef],
                                                 FunctionNode]]:
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
    for cls in class_defs(sf.tree):
        for meth in methods_of(cls):
            yield cls, meth


# -- res-thread-join -------------------------------------------------------

def _is_thread_call(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and (attr_chain(node.func) or [""])[-1] == "Thread")


def _daemonized(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon":
            # daemon=False is an explicit "I will join this"; anything
            # non-constant is someone else's decision — stay quiet.
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    return False


def _joined_names(scope: ast.AST) -> set[str]:
    """Names (``"t"`` / ``"self.t"``) that see a ``.join()`` in a scope,
    resolving one level of ``for v in <name>`` loop aliasing so joining
    the loop variable joins the iterated list."""
    loop_alias: dict[str, str] = {}
    for node in cached_walk(scope):
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and isinstance(node.target, ast.Name):
            src = attr_chain(node.iter)
            if src:
                loop_alias[node.target.id] = ".".join(src)
    joined: set[str] = set()
    for node in cached_walk(scope):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] == "join" and len(chain) >= 2:
                owner = ".".join(chain[:-1])
                joined.add(owner)
                if owner in loop_alias:
                    joined.add(loop_alias[owner])
    return joined


def _thread_targets(fn: FunctionNode) -> Iterator[tuple[ast.Call,
                                                        Optional[str]]]:
    """(Thread-constructor call, handle name or None) pairs.  The handle
    is the dotted name the thread — or the list containing it — lives
    under; None means the thread has no joinable handle at all."""
    claimed: set[int] = set()
    for node in cached_walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = attr_chain(node.targets[0])
            name = ".".join(target) if target else None
            values = [node.value]
            if isinstance(node.value, (ast.List, ast.Tuple)):
                values = list(node.value.elts)
            elif isinstance(node.value, ast.ListComp):
                values = [node.value.elt]
            for value in values:
                if _is_thread_call(value):
                    claimed.add(id(value))
                    yield value, name
        elif isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] == "append" and len(chain) >= 2:
                for arg in node.args:
                    if _is_thread_call(arg):
                        claimed.add(id(arg))
                        yield arg, ".".join(chain[:-1])
    for node in cached_walk(fn):
        if _is_thread_call(node) and id(node) not in claimed:
            yield node, None


def _thread_findings(sf: SourceFile) -> Iterator[Finding]:
    rule = RULES[0]
    # A class scope is shared by all its methods — compute its joined
    # set once, not once per method (classes can be large).
    joined_cache: dict[int, set[str]] = {}
    for cls, fn in _functions(sf):
        scope: ast.AST = cls if cls is not None else fn
        if id(scope) not in joined_cache:
            joined_cache[id(scope)] = _joined_names(scope)
        joined = joined_cache[id(scope)]
        for call, handle in _thread_targets(fn):
            if _daemonized(call):
                continue
            if handle is not None and handle in joined:
                continue
            what = (f"thread assigned to {handle}" if handle
                    else "thread with no handle")
            yield Finding(rule.id, rule.severity, sf.relpath, call.lineno,
                          f"{what} is neither daemon=True nor joined")


# -- res-socket-close ------------------------------------------------------

_ACQUIRERS = ("create_connection", "open")


def _is_acquire_call(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    if not chain:
        return False
    if chain[-1] in _ACQUIRERS:
        return True
    return chain[-1] == "socket" and len(chain) >= 2 \
        and chain[-2] == "socket"


def _socket_findings(sf: SourceFile) -> Iterator[Finding]:
    rule = RULES[1]
    for _cls, fn in _functions(sf):
        acquired: dict[str, int] = {}
        for node in cached_walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _is_acquire_call(node.value)):
                acquired.setdefault(node.targets[0].id, node.lineno)
        if not acquired:
            continue
        released: set[str] = set()
        for node in cached_walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Name):
                        released.add(expr.id)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and len(chain) == 2 and chain[-1] in ("close",
                                                              "shutdown"):
                    released.add(chain[0])
                # Passing the handle onward transfers ownership.
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        released.add(arg.id)
            elif isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Name):
                released.add(node.value.id)
            elif isinstance(node, ast.Assign):
                target = attr_chain(node.targets[0]) if node.targets else None
                if target and target[0] == "self" \
                        and isinstance(node.value, ast.Name):
                    released.add(node.value.id)
        for name, line in sorted(acquired.items(), key=lambda kv: kv[1]):
            if name not in released:
                yield Finding(
                    rule.id, rule.severity, sf.relpath, line,
                    f"{name} acquired outside a context manager and "
                    f"never closed, returned, or handed off")


# -- res-queue-unbounded ---------------------------------------------------

def _queue_findings(sf: SourceFile) -> Iterator[Finding]:
    rule = RULES[2]
    for node in cached_walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or chain[-1] != "Queue":
            continue
        if len(chain) >= 2 and chain[-2] not in ("queue",):
            continue  # asyncio.Queue() etc. have their own semantics
        bounded = bool(node.args)
        for kw in node.keywords:
            if kw.arg == "maxsize":
                bounded = not (isinstance(kw.value, ast.Constant)
                               and isinstance(kw.value.value, int)
                               and kw.value.value <= 0)
        if not bounded:
            yield Finding(rule.id, rule.severity, sf.relpath, node.lineno,
                          "unbounded queue.Queue() — bound it or document "
                          "the external bounding mechanism")


# -- res-shutdown ----------------------------------------------------------

_SERVERISH = {
    "ThreadPoolExecutor": ("shutdown",),
    "ProcessPoolExecutor": ("shutdown",),
    "start_server": ("close",),
}


def _shutdown_findings(sf: SourceFile) -> Iterator[Finding]:
    rule = RULES[3]
    for cls in class_defs(sf.tree):
        stored: dict[str, tuple[int, str, tuple[str, ...]]] = {}
        for node in cached_walk(cls):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            target = attr_chain(node.targets[0])
            if not (target and len(target) == 2 and target[0] == "self"):
                continue
            value = node.value
            if isinstance(value, ast.Await):
                value = value.value
            if not isinstance(value, ast.Call):
                continue
            kind = (attr_chain(value.func) or [""])[-1]
            if kind in _SERVERISH:
                stored[target[1]] = (node.lineno, kind, _SERVERISH[kind])
        if not stored:
            continue
        closed: set[tuple[str, str]] = set()
        for node in cached_walk(cls):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and len(chain) == 3 and chain[0] == "self":
                    closed.add((chain[1], chain[2]))
        for attr, (line, kind, stoppers) in sorted(stored.items()):
            if not any((attr, stop) in closed for stop in stoppers):
                yield Finding(
                    rule.id, rule.severity, sf.relpath, line,
                    f"self.{attr} holds a {kind} result but {cls.name} "
                    f"never calls {' or '.join(stoppers)}() on it")
