"""Taint dataflow over the stdlib-ast IR (the v3 engine layer).

PR 6's call graph can say *who calls whom*; nothing in the engine can
say *where a value came from*.  This module adds that axis: a
may-taint analysis whose sources are the network reads — every value
decoded from a wire frame is attacker-controlled until it passes a
sanitizer — propagated per function in program order (def-use chains
with strong updates on assignment, the reaching-definitions view a
statement-ordered walk gives) and across functions through the call
graph.

The lattice is deliberately small.  A name's abstract value is a set
of *origins*:

- ``"wire"`` — the value derives from a network read
  (``reader.readexactly`` / ``sock.recv`` / the ``framing.read_*`` /
  ``recv_*`` helpers) or a struct-unpack of bytes that do;
- ``"param:<name>"`` — the value derives from the function's own
  parameter, used to build interprocedural summaries (a caller
  substitutes its argument origins for these labels).

Empty set = untrusted by nobody = clean.  May-taint only: branches
union, loops run to a (two-pass) fixpoint, and a strong update on
assignment kills prior taint.

Sanitizers clear origins:

- a call to a ``validate_*`` / ``*_in_range`` function sanitizes its
  return value AND the argument names it was given (the validator
  raises on bad input, so the names are in-range afterwards) —
  ``net.protocol.validate_count`` and ``core.geometry.validate_indices``
  are the sanctioned spellings;
- ``min(x, bound)`` / ``max(x, bound)`` with at least one clean
  operand is a clamp: the result is clean;
- a range/clamp comparison guard: names compared inside an ``if`` test
  are clean within the guarded body and the ``else``; when the body
  unconditionally escapes (raise/return/break/continue) they are clean
  after the ``if`` too;
- ``len()`` of anything is clean (exact-length reads make a buffer's
  length the reader's choice, not the peer's).

Interprocedural summaries (fixpoint over the call graph, like the
lock rules' blocking summaries):

- *return origins*: calling a function whose return derives from the
  wire taints the call result (``framing.read_u32`` needs no special
  casing — its body reads the socket, so the fixpoint marks it);
  ``param:`` labels in a summary are substituted with the caller's
  argument origins, so a pass-through helper (``self._read(coro)``)
  forwards taint faithfully;
- *param sinks*: a function whose parameter reaches a sink without a
  sanitizer exports ``(param, sink)``; a caller passing wire-tainted
  data to that parameter is flagged at the call site with the call
  path named — a one-level helper no longer hides an allocation.

Everything here is stdlib ``ast``; the package under analysis is never
imported, and the whole pass is a bounded number of AST walks per
function — comfortably inside the tier-1 gate's five-second budget.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional

from distributedmandelbrot_tpu_torch.analysis import callgraph
from distributedmandelbrot_tpu_torch.analysis.astutil import (attr_chain,
                                                        cached_walk)
from distributedmandelbrot_tpu_torch.analysis.engine import Project

__all__ = ["Sink", "TaintSummary", "ProjectTaint", "WIRE", "analyze"]

WIRE = "wire"

# Root source methods: the value returned IS bytes straight off a
# socket.  Receiver-independent — any ``.recv`` spelled like the socket
# API counts (the conservative reading for a security source).
_ROOT_SOURCE_METHODS = frozenset({"readexactly", "recv", "recv_into"})
# Helper names recognized as sources even when the callee is outside
# the analyzed project (test fixtures stub ``framing``; the installed
# package resolves these through summaries anyway).
_NAMED_SOURCES = frozenset({
    "read_exact", "read_u32", "read_byte",
    "recv_exact", "recv_u32", "recv_byte",
})
# struct methods that forward their input's taint to their output.
_UNPACKERS = frozenset({"unpack", "unpack_from", "iter_unpack"})
# Calls whose result is never attacker-sized regardless of arguments.
_CLEAN_CALLS = frozenset({"len", "bool", "isinstance", "id", "type",
                          "enumerate", "zip", "repr", "hash"})


def _is_sanitizer_name(name: str) -> bool:
    return name.startswith("validate_") or name.endswith("_in_range")


@dataclass(frozen=True)
class Sink:
    """One sink reached by tainted data inside a single function."""

    kind: str       # "alloc" | "index" | "loop" | "struct"
    line: int
    detail: str     # human fragment, e.g. "bytes() size"
    origins: frozenset


@dataclass
class TaintSummary:
    """Per-function facts exported to callers."""

    return_origins: frozenset = frozenset()
    # (param name, sink kind, sink detail, sink relpath, sink line)
    param_sinks: tuple = ()


@dataclass
class _FnResult:
    sinks: list = field(default_factory=list)
    return_origins: frozenset = frozenset()
    # call node id -> (callee qualname, per-arg origins) for sites whose
    # arguments were tainted when visited (interprocedural extension).
    tainted_calls: dict = field(default_factory=dict)


class _Env:
    """Dotted-name -> origin set.  Missing = clean."""

    def __init__(self, taint: Optional[dict] = None) -> None:
        self.taint: dict[str, frozenset] = dict(taint or {})

    def copy(self) -> "_Env":
        return _Env(self.taint)

    def merge(self, other: "_Env") -> None:
        for name, origins in other.taint.items():
            self.taint[name] = self.taint.get(name, frozenset()) | origins

    def get(self, name: str) -> frozenset:
        return self.taint.get(name, frozenset())

    def set(self, name: str, origins: frozenset) -> None:
        if origins:
            self.taint[name] = origins
        else:
            self.taint.pop(name, None)

    def sanitize(self, name: str) -> None:
        self.taint.pop(name, None)


class _FunctionTaint:
    """One program-order taint walk over a function body."""

    def __init__(self, project_taint: "ProjectTaint", qualname: str,
                 fn: callgraph.FunctionInfo) -> None:
        self.pt = project_taint
        self.qualname = qualname
        self.fn = fn
        self.result = _FnResult()

    # -- entry -------------------------------------------------------------

    def run(self) -> _FnResult:
        env = _Env()
        node = self.fn.node
        args = node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if a.arg in ("self", "cls"):
                continue
            env.set(a.arg, frozenset({f"param:{a.arg}"}))
        self._walk_body(node.body, env)
        return self.result

    # -- statements --------------------------------------------------------

    def _walk_body(self, body: list, env: _Env) -> None:
        for stmt in body:
            self._stmt(stmt, env)

    def _stmt(self, stmt: ast.stmt, env: _Env) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested scopes run later; not part of this walk
        if isinstance(stmt, ast.Assign):
            origins = self._expr(stmt.value, env)
            for target in stmt.targets:
                self._assign(target, stmt.value, origins, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                origins = self._expr(stmt.value, env)
                self._assign(stmt.target, stmt.value, origins, env)
        elif isinstance(stmt, ast.AugAssign):
            origins = self._expr(stmt.value, env)
            name = _dotted(stmt.target)
            if name is not None:
                env.set(name, env.get(name) | origins)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.result.return_origins |= self._expr(stmt.value, env)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value, env)
        elif isinstance(stmt, ast.If):
            self._if(stmt, env)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._for(stmt, env)
        elif isinstance(stmt, ast.While):
            self._while(stmt, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                origins = self._expr(item.context_expr, env)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, item.context_expr,
                                 origins, env)
            self._walk_body(stmt.body, env)
        elif isinstance(stmt, ast.Try):
            # Handlers/finally may run from any prefix of the body: walk
            # the body on the live env, then handlers on a union of the
            # pre-body and post-body states.
            pre = env.copy()
            self._walk_body(stmt.body, env)
            handler_env = env.copy()
            handler_env.merge(pre)
            for handler in stmt.handlers:
                h_env = handler_env.copy()
                self._walk_body(handler.body, h_env)
                env.merge(h_env)
            self._walk_body(stmt.orelse, env)
            self._walk_body(stmt.finalbody, env)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._expr(stmt.exc, env)
        elif isinstance(stmt, (ast.Delete, ast.Assert)):
            for sub in cached_walk(stmt):
                if isinstance(sub, ast.expr):
                    self._expr_shallow_sinks(sub, env)
        # pass/break/continue/global/import: nothing to do

    def _if(self, stmt: ast.If, env: _Env) -> None:
        guarded = _compared_names(stmt.test)
        self._expr(stmt.test, env)
        body_env = env.copy()
        for name in guarded:
            body_env.sanitize(name)
        self._walk_body(stmt.body, body_env)
        else_env = env.copy()
        for name in guarded:
            else_env.sanitize(name)
        self._walk_body(stmt.orelse, else_env)
        if _escapes(stmt.body):
            # Only the else edge survives: the guard proved the names
            # in-range on every path that continues.
            env.taint = else_env.taint
        else:
            body_env.merge(else_env)
            env.taint = body_env.taint

    def _for(self, stmt: ast.For | ast.AsyncFor, env: _Env) -> None:
        iter_origins = self._expr(stmt.iter, env)
        self._check_loop_sink(stmt.iter, env)
        # Two passes: the second sees taint created on the first (loop-
        # carried flows); may-taint only grows, so two suffice in
        # practice and keep the walk linear.
        for _ in range(2):
            self._assign(stmt.target, None, iter_origins, env)
            self._walk_body(stmt.body, env)
        self._walk_body(stmt.orelse, env)

    def _while(self, stmt: ast.While, env: _Env) -> None:
        test_origins = frozenset()
        for sub in cached_walk(stmt.test):
            name = _dotted(sub) if isinstance(sub, ast.expr) else None
            if name is not None:
                test_origins |= env.get(name)
        if test_origins:
            self._sink("loop", stmt.lineno, "while-loop bound",
                       test_origins)
        for _ in range(2):
            self._walk_body(stmt.body, env)
        self._walk_body(stmt.orelse, env)

    def _assign(self, target: ast.expr, value: Optional[ast.expr],
                origins: frozenset, env: _Env) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            elements = list(target.elts)
            values: list[Optional[ast.expr]] = [None] * len(elements)
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(elements):
                values = list(value.elts)
            for elt, sub_value in zip(elements, values):
                sub_origins = (self._expr(sub_value, env)
                               if sub_value is not None else origins)
                self._assign(elt, sub_value, sub_origins, env)
            return
        if isinstance(target, ast.Starred):
            self._assign(target.value, None, origins, env)
            return
        if isinstance(target, ast.Subscript):
            self._check_index_sink(target, env)
            return  # container poisoning is out of scope
        name = _dotted(target)
        if name is not None:
            env.set(name, origins)

    # -- expressions -------------------------------------------------------

    def _expr(self, expr: ast.expr, env: _Env) -> frozenset:
        """Origin set of an expression; records sinks seen on the way."""
        if isinstance(expr, ast.Constant):
            return frozenset()
        if isinstance(expr, (ast.Name, ast.Attribute)):
            name = _dotted(expr)
            return env.get(name) if name is not None else frozenset()
        if isinstance(expr, ast.Await):
            return self._expr(expr.value, env)
        if isinstance(expr, ast.NamedExpr):
            origins = self._expr(expr.value, env)
            self._assign(expr.target, expr.value, origins, env)
            return origins
        if isinstance(expr, ast.Call):
            return self._call(expr, env)
        if isinstance(expr, ast.BinOp):
            return self._expr(expr.left, env) | self._expr(expr.right, env)
        if isinstance(expr, ast.UnaryOp):
            return self._expr(expr.operand, env)
        if isinstance(expr, ast.BoolOp):
            out = frozenset()
            for v in expr.values:
                out |= self._expr(v, env)
            return out
        if isinstance(expr, ast.Compare):
            self._expr(expr.left, env)
            for c in expr.comparators:
                self._expr(c, env)
            return frozenset()  # a boolean is not a size
        if isinstance(expr, ast.IfExp):
            self._expr(expr.test, env)
            return self._expr(expr.body, env) | self._expr(expr.orelse, env)
        if isinstance(expr, ast.Subscript):
            self._check_index_sink(expr, env)
            return self._expr(expr.value, env)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out = frozenset()
            for elt in expr.elts:
                out |= self._expr(elt, env)
            return out
        if isinstance(expr, ast.Dict):
            out = frozenset()
            for k, v in zip(expr.keys, expr.values):
                if k is not None:
                    out |= self._expr(k, env)
                out |= self._expr(v, env)
            return out
        if isinstance(expr, ast.JoinedStr):
            out = frozenset()
            for part in expr.values:
                if isinstance(part, ast.FormattedValue):
                    out |= self._expr(part.value, env)
            return out
        if isinstance(expr, ast.FormattedValue):
            return self._expr(expr.value, env)
        if isinstance(expr, ast.Starred):
            return self._expr(expr.value, env)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self._comprehension(expr, env)
        if isinstance(expr, ast.Slice):
            out = frozenset()
            for part in (expr.lower, expr.upper, expr.step):
                if part is not None:
                    out |= self._expr(part, env)
            return out
        if isinstance(expr, ast.Lambda):
            return frozenset()  # runs later, like a nested def
        return frozenset()

    def _expr_shallow_sinks(self, expr: ast.expr, env: _Env) -> None:
        if isinstance(expr, ast.Subscript):
            self._check_index_sink(expr, env)

    def _comprehension(self, expr, env: _Env) -> frozenset:
        inner = env.copy()
        for gen in expr.generators:
            origins = self._expr(gen.iter, inner)
            self._check_loop_sink(gen.iter, inner)
            self._assign(gen.target, None, origins, inner)
            for cond in gen.ifs:
                self._expr(cond, inner)
        if isinstance(expr, ast.DictComp):
            return self._expr(expr.key, inner) | self._expr(expr.value,
                                                            inner)
        return self._expr(expr.elt, inner)

    # -- calls: sources, sanitizers, sinks, summaries ----------------------

    def _call(self, call: ast.Call, env: _Env) -> frozenset:
        chain = attr_chain(call.func) or []
        name = chain[-1] if chain else ""
        arg_origins = [self._expr(a, env) for a in call.args]
        kw_origins = {kw.arg: self._expr(kw.value, env)
                      for kw in call.keywords}
        all_args = frozenset().union(*arg_origins, *kw_origins.values()) \
            if (arg_origins or kw_origins) else frozenset()

        # Sinks first: the arguments' taint is judged pre-sanitization.
        self._call_sinks(call, chain, name, arg_origins, kw_origins, env)

        # Sanitizers.
        if _is_sanitizer_name(name):
            for arg in call.args:
                dotted = _dotted(arg)
                if dotted is not None:
                    env.sanitize(dotted)
            return frozenset()
        if name in ("min", "max"):
            if any(not o for o in arg_origins):
                return frozenset()  # clamped against a clean bound
            return all_args
        if name in _CLEAN_CALLS:
            return frozenset()

        # Sources.
        if name in _ROOT_SOURCE_METHODS and len(chain) >= 2:
            return frozenset({WIRE})
        if name in _NAMED_SOURCES:
            return frozenset({WIRE})
        if name in _UNPACKERS:
            return all_args

        # Project callees: substitute the summary.
        callee = self.pt.graph.resolve_node(call)
        if callee is not None:
            summary = self.pt.summaries.get(callee)
            if summary is not None:
                if all_args:
                    self._note_tainted_call(call, callee, arg_origins,
                                            kw_origins)
                return self._substitute(summary.return_origins, call,
                                        arg_origins, kw_origins)
        # Unknown call: taint flows through (str/int casts, arithmetic
        # helpers); a clean result requires a recognized sanitizer.
        return all_args

    def _note_tainted_call(self, call: ast.Call, callee: str,
                           arg_origins, kw_origins) -> None:
        info = self.pt.graph.function(callee)
        if info is None:
            return
        by_param = _map_args_to_params(info.node, call, arg_origins,
                                       kw_origins)
        if by_param:
            self.result.tainted_calls[id(call)] = (callee, call.lineno,
                                                   by_param)

    def _substitute(self, origins: frozenset, call: ast.Call,
                    arg_origins, kw_origins) -> frozenset:
        out = set()
        callee = self.pt.graph.resolve_node(call)
        info = self.pt.graph.function(callee) if callee else None
        by_param = (_map_args_to_params(info.node, call, arg_origins,
                                        kw_origins)
                    if info is not None else {})
        for origin in origins:
            if origin == WIRE:
                out.add(WIRE)
            elif origin.startswith("param:"):
                out |= by_param.get(origin[len("param:"):], frozenset())
        return frozenset(out)

    def _call_sinks(self, call: ast.Call, chain: list, name: str,
                    arg_origins, kw_origins, env: _Env) -> None:
        def arg(i: int) -> frozenset:
            return arg_origins[i] if i < len(arg_origins) else frozenset()

        if name in ("bytes", "bytearray") and arg_origins:
            if arg(0):
                self._sink("alloc", call.lineno, f"{name}() size", arg(0))
        elif name in ("zeros", "empty", "ones", "full") and arg_origins:
            if arg(0):
                self._sink("alloc", call.lineno,
                           f"np.{name}() shape", arg(0))
        elif name == "frombuffer":
            count = kw_origins.get("count", frozenset())
            if count:
                self._sink("alloc", call.lineno, "np.frombuffer() count",
                           count)
        elif name in ("read_exact", "recv_exact"):
            if arg(1):
                self._sink("alloc", call.lineno,
                           f"{name}() length", arg(1))
        elif name == "readexactly":
            if arg(0):
                self._sink("alloc", call.lineno, "readexactly() length",
                           arg(0))
        elif name == "range":
            tainted = frozenset().union(*arg_origins) if arg_origins \
                else frozenset()
            if tainted:
                self._sink("loop", call.lineno, "range() bound", tainted)
        elif name in ("Struct", "calcsize", "pack", "pack_into") \
                or name in _UNPACKERS:
            fmt_origins = arg(0)
            if name == "pack_into":
                fmt_origins = frozenset()  # fmt precompiled on receiver
            if chain[:1] == ["struct"] or name in ("Struct", "calcsize"):
                if fmt_origins:
                    self._sink("struct", call.lineno,
                               f"struct {name}() format", fmt_origins)

    def _check_index_sink(self, sub: ast.Subscript, env: _Env) -> None:
        origins = self._expr(sub.slice, env)
        if origins:
            detail = ("slice bound" if isinstance(sub.slice, ast.Slice)
                      else "container index")
            self._sink("index", sub.lineno, detail, origins)

    def _check_loop_sink(self, iter_expr: ast.expr, env: _Env) -> None:
        # ``for _ in range(n)`` is caught by the range() call sink while
        # evaluating the iterable; nothing extra here.
        return None

    def _sink(self, kind: str, line: int, detail: str,
              origins: frozenset) -> None:
        self.result.sinks.append(Sink(kind, line, detail,
                                      frozenset(origins)))


# -- helpers ---------------------------------------------------------------

def _dotted(expr: ast.expr) -> Optional[str]:
    chain = attr_chain(expr)
    return ".".join(chain) if chain else None


def _compared_names(test: ast.expr) -> set[str]:
    """Dotted names that appear inside comparison operations in a guard
    test — the 'range/clamp comparison' sanitizer shape.  ``if flag:``
    sanitizes nothing; ``if n == 0 or n > MAX:`` sanitizes ``n``."""
    names: set[str] = set()
    for node in cached_walk(test):
        if isinstance(node, ast.Compare):
            for side in [node.left] + list(node.comparators):
                name = _dotted(side)
                if name is not None:
                    names.add(name)
    return names


def _escapes(body: list) -> bool:
    """True when the branch unconditionally leaves the enclosing flow."""
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Raise, ast.Return, ast.Break, ast.Continue)):
        return True
    if isinstance(last, ast.If):
        return _escapes(last.body) and _escapes(last.orelse)
    return False


def _map_args_to_params(fn_node, call: ast.Call, arg_origins,
                        kw_origins) -> dict[str, frozenset]:
    """Param name -> origins of the argument the call passes it."""
    args = fn_node.args
    params = [a.arg for a in (args.posonlyargs + args.args)]
    if params and params[0] in ("self", "cls"):
        params = params[1:]
    out: dict[str, frozenset] = {}
    for i, origins in enumerate(arg_origins):
        if origins and i < len(params):
            out[params[i]] = out.get(params[i], frozenset()) | origins
    kwonly = {a.arg for a in args.kwonlyargs}
    for name, origins in kw_origins.items():
        if origins and name is not None \
                and (name in params or name in kwonly):
            out[name] = out.get(name, frozenset()) | origins
    return out


# -- project-level analysis ------------------------------------------------

class ProjectTaint:
    """Per-function taint results + interprocedural summaries."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.graph = callgraph.graph_for(project)
        self.summaries: dict[str, TaintSummary] = {
            qual: TaintSummary() for qual in self.graph.functions}
        self.results: dict[str, _FnResult] = {}
        self._fixpoint()

    def _fixpoint(self, max_rounds: int = 4) -> None:
        for _ in range(max_rounds):
            changed = False
            for qual, info in self.graph.functions.items():
                result = _FunctionTaint(self, qual, info).run()
                self.results[qual] = result
                summary = self._summarize(info, result)
                old = self.summaries[qual]
                if (summary.return_origins != old.return_origins
                        or summary.param_sinks != old.param_sinks):
                    self.summaries[qual] = summary
                    changed = True
            if not changed:
                return

    def _summarize(self, info: callgraph.FunctionInfo,
                   result: _FnResult) -> TaintSummary:
        param_sinks = []
        for sink in result.sinks:
            for origin in sorted(sink.origins):
                if origin.startswith("param:"):
                    param_sinks.append((origin[len("param:"):], sink.kind,
                                        sink.detail, info.relpath,
                                        sink.line))
        # Inherit the callees' param sinks through pass-through calls so
        # a two-hop helper chain still reaches the caller.
        for callee, line, by_param in result.tainted_calls.values():
            callee_summary = self.summaries.get(callee)
            if callee_summary is None:
                continue
            for (p, kind, detail, relpath, sline) in \
                    callee_summary.param_sinks:
                for origin in sorted(by_param.get(p, frozenset())):
                    if origin.startswith("param:"):
                        param_sinks.append((origin[len("param:"):], kind,
                                            detail, relpath, sline))
        return TaintSummary(result.return_origins,
                            tuple(sorted(set(param_sinks))))

    # -- rule-facing queries ----------------------------------------------

    def wire_sinks(self, qualname: str) -> Iterator[Sink]:
        """Sinks in ``qualname`` reached by wire-tainted data."""
        result = self.results.get(qualname)
        if result is None:
            return
        for sink in result.sinks:
            if WIRE in sink.origins:
                yield sink

    def wire_call_sinks(self, qualname: str
                        ) -> Iterator[tuple[int, str, str, str, str, int]]:
        """(line, callee, kind, detail, sink relpath, sink line) for calls
        in ``qualname`` that pass wire-tainted data to a parameter the
        callee's summary says reaches a sink unsanitized."""
        result = self.results.get(qualname)
        if result is None:
            return
        for callee, line, by_param in result.tainted_calls.values():
            summary = self.summaries.get(callee)
            if summary is None:
                continue
            for (p, kind, detail, relpath, sline) in summary.param_sinks:
                if WIRE in by_param.get(p, frozenset()):
                    yield line, callee, kind, detail, relpath, sline


def analyze(project: Project) -> ProjectTaint:
    """Build (or reuse) the project's taint analysis; cached alongside
    the call graph so the rule families share one pass."""
    cached = getattr(project, "_taint", None)
    if isinstance(cached, ProjectTaint) and cached.project is project:
        return cached
    taint = ProjectTaint(project)
    project._taint = taint
    return taint
