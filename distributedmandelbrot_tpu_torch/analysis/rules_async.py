"""Async-hygiene rules for the asyncio layers.

``async-blocking`` — calls that block the event loop lexically inside an
``async def`` body: ``time.sleep``, the *sync* socket framing helpers
(``recv_*`` / ``send_*`` from :mod:`net.framing` — the async side is
``read_*`` / ``write_*``), raw socket ops, ``open()`` / file reads, a
``threading.Lock``-style ``.acquire()``, direct store/cache disk
reads (``load_payload`` / ``load`` / ``save``), and un-awaited
``.get()`` / ``.put()`` on a queue-named receiver (a sync
``queue.Queue`` — the worker pipeline's stage coupling — parks the
whole event loop; the asyncio flavor is awaited, which exempts it).
The sanctioned escape hatch — ``asyncio.to_thread(
self.store.load_payload, ...)`` — passes the function *uncalled*, so
no flagged Call node exists and it needs no special-casing.

``async-unawaited`` — a call to a coroutine function (an ``async def``
visible in the same file) used as a bare expression statement: the
coroutine is created, never scheduled, and silently garbage-collected.

``async-dropped-task`` — ``asyncio.create_task`` / ``ensure_future``
whose result is discarded (bare expression statement).  The loop keeps
only a weak reference to tasks, so a dropped result can be collected
mid-flight; the repo convention is ``self._tasks.add(task)`` plus a
``discard`` done-callback (serve/coalesce.py).

The blocking rule is scoped to coordinator/, serve/, and obs/ — the
directories that run an event loop; the other two are package-wide.
"""

from __future__ import annotations

import ast
from typing import Iterator

from distributedmandelbrot_tpu_torch.analysis.astutil import (
    cached_walk, call_chain, class_defs, walk_skipping_nested_async)
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project, Rule,
                                                       SourceFile)

RULES = (
    Rule("async-blocking", "async", "error",
         "blocking call inside an async def body"),
    Rule("async-unawaited", "async", "error",
         "coroutine call whose result is never awaited or scheduled"),
    Rule("async-dropped-task", "async", "warning",
         "create_task/ensure_future result dropped (task may be GC'd)"),
)

BLOCKING_SCOPE_DIRS = ("coordinator", "serve", "obs")

# Fully dotted calls that block.
BLOCKING_DOTTED = {
    "time.sleep": "time.sleep() blocks the event loop "
                  "(use asyncio.sleep)",
    "socket.create_connection": "synchronous socket connect blocks the "
                                "event loop",
}

# Sync framing helpers from net/framing.py (the async side is read_*/write_*).
SYNC_FRAMING = frozenset({
    "recv_exact", "recv_u32", "recv_byte",
    "send_all", "send_u32", "send_byte",
})

# Raw socket methods.
SOCKET_METHODS = frozenset({"recv", "recv_into", "sendall", "connect",
                            "accept"})

# Disk-touching store/cache methods; must go through asyncio.to_thread.
STORE_METHODS = frozenset({"load_payload", "load", "load_many", "save",
                           "read_text", "write_text", "read_bytes",
                           "write_bytes"})

# Receiver attribute names that look like a threading primitive, for the
# ``.acquire()`` check (so ``self.scheduler.acquire()`` — a workload
# grant, pure in-memory — is not confused with ``self._lock.acquire()``).
LOCKISH = ("lock", "mutex", "sem", "cond")

TASK_SPAWNERS = frozenset({"create_task", "ensure_future"})


def _async_defs(sf: SourceFile) -> Iterator[ast.AsyncFunctionDef]:
    for node in cached_walk(sf.tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


def _module_coroutine_names(sf: SourceFile) -> set[str]:
    return {n.name for n in sf.tree.body
            if isinstance(n, ast.AsyncFunctionDef)}


def _class_coroutine_methods(sf: SourceFile) -> dict[str, set[str]]:
    return {cls.name: {m.name for m in cls.body
                       if isinstance(m, ast.AsyncFunctionDef)}
            for cls in class_defs(sf.tree)}


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    blocking_files = {sf.relpath for sf in project.in_dirs(*BLOCKING_SCOPE_DIRS)}
    for rel in sorted(project.files):
        sf = project.files[rel]
        if rel in blocking_files:
            findings.extend(_check_blocking(sf))
        findings.extend(_check_unawaited(sf))
        findings.extend(_check_dropped_tasks(sf))
    return findings


# -- async-blocking ---------------------------------------------------------

def _check_blocking(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for fn in _async_defs(sf):
        awaited = {node.value for node in walk_skipping_nested_async(fn)
                   if isinstance(node, ast.Await)}
        for node in walk_skipping_nested_async(fn):
            if not isinstance(node, ast.Call):
                continue
            msg = _blocking_message(node, node in awaited)
            if msg:
                out.append(Finding(
                    "async-blocking", "error", sf.relpath, node.lineno,
                    f"{msg} (in async def {fn.name})"))
    return out


def _blocking_message(call: ast.Call, is_awaited: bool) -> str | None:
    chain = call_chain(call)
    if chain is None:
        return None
    dotted = ".".join(chain)
    if dotted in BLOCKING_DOTTED:
        return BLOCKING_DOTTED[dotted]
    if chain == ["open"]:
        return "open() does blocking file I/O on the event loop"
    last = chain[-1]
    if last in SYNC_FRAMING:
        return (f"sync framing helper {last}() blocks the event loop "
                f"(use the async read_*/write_* side)")
    if last in SOCKET_METHODS and len(chain) >= 2 \
            and ("sock" in chain[-2].lower() or chain[-2] == "socket"):
        return f"raw socket .{last}() blocks the event loop"
    if last == "acquire" and not is_awaited and len(chain) >= 2 \
            and any(k in chain[-2].lower() for k in LOCKISH):
        return (f"{chain[-2]}.acquire() blocks the event loop "
                f"(threading primitive in a coroutine)")
    if last in STORE_METHODS and len(chain) >= 2 \
            and chain[-2] in ("store", "cache", "index", "path"):
        return (f"direct {chain[-2]}.{last}() does disk I/O on the event "
                f"loop (wrap in asyncio.to_thread)")
    if last in ("get", "put") and not is_awaited and len(chain) >= 2:
        recv = chain[-2].lower()
        # Queue-named receivers only: a bare dict .get() is everywhere
        # and harmless; a sync queue.Queue .get() parks the loop until
        # a pipeline thread feeds it.
        if recv in ("q", "queue") or recv.endswith("_q") \
                or "queue" in recv:
            return (f"sync queue .{last}() blocks the event loop "
                    f"(use asyncio.Queue and await, or _nowait)")
    return None


# -- async-unawaited --------------------------------------------------------

def _check_unawaited(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    module_coros = _module_coroutine_names(sf)
    class_coros = _class_coroutine_methods(sf)

    def scan_function(fn: ast.AsyncFunctionDef | ast.FunctionDef,
                      own_class: str | None) -> None:
        coros_of_self = class_coros.get(own_class or "", set())
        for node in walk_skipping_nested_async(fn):
            if not isinstance(node, ast.Expr) \
                    or not isinstance(node.value, ast.Call):
                continue
            chain = call_chain(node.value)
            if chain is None:
                continue
            name = None
            if len(chain) == 1 and chain[0] in module_coros:
                name = chain[0]
            elif len(chain) == 2 and chain[0] == "self" \
                    and chain[1] in coros_of_self:
                name = f"self.{chain[1]}"
            if name:
                out.append(Finding(
                    "async-unawaited", "error", sf.relpath, node.lineno,
                    f"{name}() returns a coroutine that is never awaited "
                    f"or scheduled"))

    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_function(node, None)
        elif isinstance(node, ast.ClassDef):
            for meth in node.body:
                if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_function(meth, node.name)
    return out


# -- async-dropped-task -----------------------------------------------------

def _check_dropped_tasks(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for node in cached_walk(sf.tree):
        if not isinstance(node, ast.Expr) \
                or not isinstance(node.value, ast.Call):
            continue
        chain = call_chain(node.value)
        if chain and chain[-1] in TASK_SPAWNERS:
            out.append(Finding(
                "async-dropped-task", "warning", sf.relpath, node.lineno,
                f"result of {chain[-1]}() is dropped; the loop holds only "
                f"a weak reference, so keep it (repo convention: add to a "
                f"task set with a discard callback)"))
    return out
