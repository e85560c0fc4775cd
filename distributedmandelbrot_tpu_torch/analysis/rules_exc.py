"""``exc-*`` rules: exception paths that leak resources or evidence.

The taint rules guard what a peer can *send*; these guard what an
exception can *drop*.  Two failure shapes recur in serving stacks:

- ``exc-leak``: a resource is acquired (a scheduler lease via
  ``.claim()``, a socket/file via ``create_connection`` / ``open``) and
  a statement that can raise — an ``await`` or an I/O call — runs while
  the resource is held, outside any ``try`` whose handler or ``finally``
  releases it.  The raise unwinds past the release and the lease waits
  out its expiry (or the fd leaks).  A ``if x is None: ...return``
  failure guard directly after the acquisition is recognized; so is
  handing the resource off (returned, stored on ``self``, ``with``).
- ``exc-swallow``: a bare / ``except Exception`` / ``except
  BaseException`` handler that neither re-raises, logs, counts to obs
  (``.inc(``), nor binds-and-uses the exception object.  Silent
  swallows erase the only evidence a storm leaves behind; at minimum
  the handler owes a counter or a log line.

Both families walk statements in program order (the same walk order the
dataflow layer uses), so "before the try" and "inside the guard" mean
what they mean in the source.
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
    Rule("exc-leak", "exc", "error",
         "a raise while a lease/socket is held unwinds past its release"),
    Rule("exc-swallow", "exc", "warning",
         "overbroad except that neither re-raises, logs, nor counts"),
)

SCOPE_DIRS = ("net", "coordinator", "serve", "worker", "viewer")

# Acquisition shapes: (recognizer, release method names).
_CLAIM_RELEASES = ("finish_claim", "release_claim", "release")
_SOCKET_RELEASES = ("close", "shutdown")

# A statement "can raise" when it awaits or performs I/O.  Narrower than
# "any call" on purpose: setsockopt/level accessors between an acquire
# and a hand-off are not worth a finding, network reads/writes are.
_IO_PREFIXES = ("read", "recv", "send", "write", "drain", "connect",
                "flush")


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.in_dirs(*SCOPE_DIRS):
        for fn in _functions(sf):
            findings.extend(_leak_findings(sf, fn))
        findings.extend(_swallow_findings(sf))
    return findings


def _functions(sf: SourceFile) -> Iterator[FunctionNode]:
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
    for cls in class_defs(sf.tree):
        yield from methods_of(cls)


# -- exc-leak --------------------------------------------------------------

def _acquisition(stmt: ast.stmt) -> Optional[tuple[str, str, tuple]]:
    """(name, what, release method names) if stmt acquires a resource
    into a local."""
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return None
    value = stmt.value
    if isinstance(value, ast.Await):
        value = value.value
    if not isinstance(value, ast.Call):
        return None
    chain = attr_chain(value.func) or [""]
    name = stmt.targets[0].id
    if chain[-1] == "claim":
        return name, "lease claim", _CLAIM_RELEASES
    if chain[-1] in ("create_connection", "open") \
            or (chain[-1] == "socket" and len(chain) >= 2
                and chain[-2] == "socket"):
        return name, "socket/file", _SOCKET_RELEASES
    return None


def _releases(stmt: ast.stmt, name: str, methods: tuple) -> bool:
    """Does this statement release or hand off the resource ``name``?"""
    for node in cached_walk(stmt):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in methods:
                return True
        elif isinstance(node, ast.Return) and node.value is not None:
            for sub in cached_walk(node.value):
                if isinstance(sub, ast.Name) and sub.id == name:
                    return True
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name) and expr.id == name:
                    return True
        elif isinstance(node, ast.Assign):
            target = attr_chain(node.targets[0]) if node.targets else None
            if target and target[0] == "self" \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == name:
                return True
    return False


def _is_failure_guard(stmt: ast.stmt, name: str) -> bool:
    """``if name is None:`` / ``if not name:`` with an escaping body —
    the acquisition failed, so nothing is held on that edge."""
    if not isinstance(stmt, ast.If):
        return False
    test = stmt.test
    guarded = None
    if isinstance(test, ast.Compare) and isinstance(test.left, ast.Name) \
            and len(test.ops) == 1 and isinstance(test.ops[0], ast.Is):
        guarded = test.left.id
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) \
            and isinstance(test.operand, ast.Name):
        guarded = test.operand.id
    return guarded == name and _escapes(stmt.body)


def _escapes(body: list) -> bool:
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Raise, ast.Return, ast.Break, ast.Continue)):
        return True
    if isinstance(last, ast.If):
        return _escapes(last.body) and _escapes(last.orelse)
    return False


def _can_raise(stmt: ast.stmt) -> Optional[int]:
    """Line of the first await / I/O call in the statement, else None."""
    for node in cached_walk(stmt):
        if isinstance(node, ast.Await):
            return node.lineno
        if isinstance(node, ast.Call):
            name = (attr_chain(node.func) or [""])[-1]
            if name.startswith(_IO_PREFIXES):
                return node.lineno
    return None


def _try_protects(stmt: ast.Try, name: str, methods: tuple) -> bool:
    """A try whose handler or finally releases the resource covers the
    held region — from here on the raised edges release."""
    for handler in stmt.handlers:
        if any(_releases(s, name, methods) for s in handler.body):
            return True
    return any(_releases(s, name, methods) for s in stmt.finalbody)


def _leak_findings(sf: SourceFile, fn: FunctionNode) -> Iterator[Finding]:
    rule = RULES[0]
    yield from _scan_body(sf, rule, list(fn.body))


def _scan_body(sf: SourceFile, rule: Rule,
               body: list) -> Iterator[Finding]:
    for i, stmt in enumerate(body):
        acq = _acquisition(stmt)
        if acq is not None:
            name, what, methods = acq
            yield from _scan_held(sf, rule, body[i + 1:], name, what,
                                  methods, stmt.lineno)
        # Recurse into compound statements for nested acquisitions.
        for sub_body in _sub_bodies(stmt):
            yield from _scan_body(sf, rule, sub_body)


def _sub_bodies(stmt: ast.stmt) -> Iterator[list]:
    for attr in ("body", "orelse", "finalbody"):
        sub = getattr(stmt, attr, None)
        if isinstance(sub, list) and sub \
                and isinstance(sub[0], ast.stmt) \
                and not isinstance(stmt, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
            yield sub
    for handler in getattr(stmt, "handlers", ()):
        yield handler.body


def _scan_held(sf: SourceFile, rule: Rule, following: list, name: str,
               what: str, methods: tuple, acq_line: int
               ) -> Iterator[Finding]:
    for stmt in following:
        if _is_failure_guard(stmt, name):
            continue
        if isinstance(stmt, ast.Try) and _try_protects(stmt, name,
                                                       methods):
            return
        if _releases(stmt, name, methods):
            return
        line = _can_raise(stmt)
        if line is not None:
            yield Finding(
                rule.id, rule.severity, sf.relpath, line,
                f"{what} {name!r} (line {acq_line}) is still held here "
                f"and this statement can raise — release it in an "
                f"except/finally or move the I/O inside one")
            return  # one finding per acquisition is enough to fix it


# -- exc-swallow -----------------------------------------------------------

_OVERBROAD = (None, "Exception", "BaseException")

_EVIDENCE_CALLS = ("exception", "error", "warning", "info", "debug",
                   "critical", "log", "inc", "print")


def _handler_is_overbroad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    name = (attr_chain(handler.type) or [""])[-1]
    return name in _OVERBROAD


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    # Re-binding the exception and using it is handling, not swallowing
    # (``except BaseException as e: self._error = e``).
    if handler.name:
        for node in cached_walk(handler):
            if isinstance(node, ast.Name) and node.id == handler.name \
                    and isinstance(node.ctx, ast.Load):
                return False
    for node in cached_walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in _EVIDENCE_CALLS:
                return False
    return True


def _swallow_findings(sf: SourceFile) -> Iterator[Finding]:
    rule = RULES[1]
    for node in cached_walk(sf.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _handler_is_overbroad(node) and _handler_swallows(node):
            caught = ("bare except" if node.type is None else
                      f"except {(attr_chain(node.type) or ['?'])[-1]}")
            yield Finding(
                rule.id, rule.severity, sf.relpath, node.lineno,
                f"{caught} swallows the exception silently — re-raise, "
                f"log, or count it to obs")
