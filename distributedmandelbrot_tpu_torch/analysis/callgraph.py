"""Intra-package call graph over stdlib ``ast`` (the v2 engine layer).

PR 3's rules are intra-function: a one-level helper defeats the lock
rules, and the wire rules can only compare symbols, not the actual
send/recv sequence a handler reaches through ``self._handle_x()``.
This module gives every rule family the missing piece: a conservative,
resolution-by-name call graph built purely from the parsed sources —
the package under analysis is NEVER imported (the tier-1 gate measures
that), and the whole build is one AST walk per file, well inside the
sub-second budget.

What resolves (and nothing more):

- ``self.m()``            -> the enclosing class's method ``m`` (MRO by
  lexical base-class names, project classes only);
- ``self.attr.m()``       -> ``m`` on ``attr``'s inferred class.  Types
  come from ``__init__``-parameter annotations assigned to ``self.attr``
  (``scheduler: TileScheduler``), direct construction
  (``self.x = ClassName(...)``), the guard idiom
  (``x if x is not None else ClassName()``), and one propagation pass
  for ``self.x = self.y`` / ``self.x = self.y.z`` chains;
- ``f()``                 -> a module-level function of the same module
  or an imported project function; ``ClassName()`` -> its ``__init__``;
- ``mod.f()``             -> a function in an imported project module
  (``framing.read_u32`` style), or a method on a local variable whose
  class was inferred from an annotation / construction;
- ``ClassName.m()``       -> static/class-method style calls.

Everything else — callbacks, ``getattr``, lambdas, calls through
containers, stdlib/third-party targets — stays *unresolved*: the graph
reports the call site with ``callee=None`` and rule families must treat
it as "unknown", never as "safe to assume absent".  Nested ``def``s and
lambdas are not walked as part of their enclosing function (their bodies
run at some later call, exactly like the lock walk's reasoning).

Qualified names are ``"<relpath>::Class.method"`` /
``"<relpath>::function"`` — stable across runs, unique per project.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator, Optional

from distributedmandelbrot_tpu_torch.analysis.astutil import (FunctionNode,
                                                        attr_chain,
                                                        cached_walk)
from distributedmandelbrot_tpu_torch.analysis.engine import PACKAGE, Project

__all__ = ["CallGraph", "CallSite", "ClassInfo", "FunctionInfo",
           "graph_for"]


@dataclass
class FunctionInfo:
    """One module-level function or method in the project."""

    qualname: str
    relpath: str
    name: str
    cls: Optional[str]  # enclosing class name, None for module functions
    node: FunctionNode


@dataclass
class CallSite:
    """One textual call inside a function body, in source order."""

    line: int
    chain: Optional[list[str]]  # lexical dotted chain; None if non-lexical
    callee: Optional[str]       # resolved qualname, None when unresolved
    node: ast.Call


@dataclass
class ClassInfo:
    name: str
    relpath: str
    node: ast.ClassDef
    methods: dict[str, FunctionNode] = field(default_factory=dict)
    bases: list[str] = field(default_factory=list)
    # self.<attr> -> inferred class name (project classes only)
    attr_types: dict[str, str] = field(default_factory=dict)


class _ModuleEnv:
    """Per-module name environment: local defs + project imports."""

    def __init__(self, relpath: str) -> None:
        self.relpath = relpath
        self.functions: dict[str, FunctionNode] = {}
        self.classes: dict[str, ClassInfo] = {}
        # local alias -> (module relpath, symbol or None for module alias)
        self.imports: dict[str, tuple[str, Optional[str]]] = {}


def _annotation_class(ann: Optional[ast.expr]) -> Optional[str]:
    """Best-effort class name out of an annotation expression: ``X``,
    ``mod.X``, ``Optional[X]``, ``X | None``, ``"X"`` all yield ``X``."""
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
        return _annotation_class(ann)
    if isinstance(ann, ast.Name):
        return None if ann.id == "None" else ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):
        base = attr_chain(ann.value)
        if base and base[-1] == "Optional":
            return _annotation_class(ann.slice)
        return None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_annotation_class(ann.left)
                or _annotation_class(ann.right))
    return None


def _module_relpath(project: Project, dotted: str) -> Optional[str]:
    """Project relpath for a dotted module name, or None if external."""
    parts = dotted.split(".")
    if parts[0] != PACKAGE:
        return None
    for candidate in ("/".join(parts) + ".py",
                      "/".join(parts) + "/__init__.py"):
        if project.file(candidate) is not None:
            return candidate
    return None


class CallGraph:
    """Functions, classes, and resolved call sites for one project."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.functions: dict[str, FunctionInfo] = {}
        self.calls: dict[str, list[CallSite]] = {}
        # class name -> every definition (duplicates legal across modules)
        self.classes: dict[str, list[ClassInfo]] = {}
        self._envs: dict[str, _ModuleEnv] = {}
        self._by_node: dict[int, Optional[str]] = {}
        for sf in sorted(project.files.values(), key=lambda s: s.relpath):
            self._index_module(sf.relpath, sf.tree)
        self._infer_attr_types()
        for env in self._envs.values():
            self._resolve_module(env)

    # -- indexing ----------------------------------------------------------

    def _index_module(self, relpath: str, tree: ast.Module) -> None:
        env = _ModuleEnv(relpath)
        self._envs[relpath] = env
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                env.functions[node.name] = node
                self._add_function(relpath, None, node)
            elif isinstance(node, ast.ClassDef):
                info = ClassInfo(node.name, relpath, node)
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        info.methods[sub.name] = sub
                        self._add_function(relpath, node.name, sub)
                for base in node.bases:
                    chain = attr_chain(base)
                    if chain:
                        info.bases.append(chain[-1])
                env.classes[node.name] = info
                self.classes.setdefault(node.name, []).append(info)
            elif isinstance(node, ast.ImportFrom):
                self._index_import_from(env, node)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    mod = _module_relpath(self.project, alias.name)
                    if mod is not None:
                        local = alias.asname or alias.name.split(".")[0]
                        env.imports[local] = (mod, None)

    def _index_import_from(self, env: _ModuleEnv,
                           node: ast.ImportFrom) -> None:
        if node.level:
            # Relative import: anchor on this module's own package dir.
            base = env.relpath.rsplit("/", 1)[0].split("/")
            base = base[:len(base) - (node.level - 1)]
            dotted = ".".join(base + ([node.module] if node.module else []))
        else:
            dotted = node.module or ""
        for alias in node.names:
            local = alias.asname or alias.name
            # `from pkg.net import framing` — the name itself may be a
            # submodule rather than a symbol.
            as_module = _module_relpath(self.project,
                                        f"{dotted}.{alias.name}")
            if as_module is not None:
                env.imports[local] = (as_module, None)
                continue
            mod = _module_relpath(self.project, dotted)
            if mod is not None:
                env.imports[local] = (mod, alias.name)

    def _add_function(self, relpath: str, cls: Optional[str],
                      node: FunctionNode) -> None:
        qual = (f"{relpath}::{cls}.{node.name}" if cls
                else f"{relpath}::{node.name}")
        self.functions[qual] = FunctionInfo(qual, relpath, node.name,
                                            cls, node)

    # -- attribute-type inference ------------------------------------------

    def _infer_attr_types(self) -> None:
        # Pass 1: direct evidence (construction, annotated params).
        for env in self._envs.values():
            for info in env.classes.values():
                self._direct_attr_types(env, info)
        # Pass 2: one propagation round for self.x = self.y(.z) chains.
        for env in self._envs.values():
            for info in env.classes.values():
                self._propagated_attr_types(env, info)

    def _direct_attr_types(self, env: _ModuleEnv, info: ClassInfo) -> None:
        for meth in info.methods.values():
            params = {a.arg: _annotation_class(a.annotation)
                      for a in (meth.args.posonlyargs + meth.args.args
                                + meth.args.kwonlyargs)}
            for node in cached_walk(meth):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target = attr_chain(node.targets[0])
                    typ = self._expr_class(env, node.value, params)
                elif isinstance(node, ast.AnnAssign):
                    # `self.b: "B" = b` — the annotation IS the evidence.
                    target = attr_chain(node.target)
                    typ = _annotation_class(node.annotation)
                else:
                    continue
                if not (target and len(target) == 2
                        and target[0] == "self"):
                    continue
                if typ is not None and target[1] not in info.attr_types:
                    info.attr_types[target[1]] = typ

    def _propagated_attr_types(self, env: _ModuleEnv,
                               info: ClassInfo) -> None:
        for meth in info.methods.values():
            for node in cached_walk(meth):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                target = attr_chain(node.targets[0])
                if not (target and len(target) == 2
                        and target[0] == "self"
                        and target[1] not in info.attr_types):
                    continue
                value = attr_chain(node.value)
                if not value or value[0] != "self":
                    continue
                typ: Optional[str] = info.name
                for attr in value[1:]:
                    owner = self._class_named(env, typ) if typ else None
                    typ = owner.attr_types.get(attr) if owner else None
                    if typ is None:
                        break
                if typ is not None:
                    info.attr_types[target[1]] = typ

    def _expr_class(self, env: _ModuleEnv, expr: ast.expr,
                    params: dict[str, Optional[str]]) -> Optional[str]:
        """Class name an expression evaluates to, or None.  Guard idioms
        (``x if x is not None else Cls()``, ``x or Cls()``) resolve when
        every candidate agrees."""
        if isinstance(expr, ast.Call):
            chain = attr_chain(expr.func)
            if chain:
                resolved = self._resolve_name_to_class(env, chain)
                if resolved is not None:
                    return resolved.name
            return None
        if isinstance(expr, ast.Name):
            return params.get(expr.id)
        if isinstance(expr, ast.IfExp):
            cands = {self._expr_class(env, e, params)
                     for e in (expr.body, expr.orelse)}
            cands.discard(None)
            return cands.pop() if len(cands) == 1 else None
        if isinstance(expr, ast.BoolOp):
            cands = {self._expr_class(env, e, params)
                     for e in expr.values}
            cands.discard(None)
            return cands.pop() if len(cands) == 1 else None
        return None

    # -- name resolution ---------------------------------------------------

    def _class_named(self, env: Optional[_ModuleEnv],
                     name: Optional[str]) -> Optional[ClassInfo]:
        """Resolve a bare class name: same module, then imports, then a
        globally unique definition."""
        if name is None:
            return None
        if env is not None:
            local = env.classes.get(name)
            if local is not None:
                return local
            imp = env.imports.get(name)
            if imp is not None:
                mod, symbol = imp
                target = self._envs.get(mod)
                if target is not None and symbol is not None:
                    found = target.classes.get(symbol)
                    if found is not None:
                        return found
        defs = self.classes.get(name, [])
        return defs[0] if len(defs) == 1 else None

    def _resolve_name_to_class(self, env: _ModuleEnv,
                               chain: list[str]) -> Optional[ClassInfo]:
        if len(chain) == 1:
            return self._class_named(env, chain[0])
        if len(chain) == 2:
            imp = env.imports.get(chain[0])
            if imp is not None and imp[1] is None:  # module alias
                target = self._envs.get(imp[0])
                if target is not None:
                    return target.classes.get(chain[1])
        return None

    def resolve_method(self, cls_name: Optional[str], method: str,
                       *, env: Optional[_ModuleEnv] = None,
                       _seen: Optional[set[str]] = None) -> Optional[str]:
        """Qualname of ``cls.method``, walking lexical bases."""
        info = self._class_named(env, cls_name)
        if info is None or cls_name is None:
            return None
        if method in info.methods:
            return f"{info.relpath}::{info.name}.{method}"
        seen = _seen if _seen is not None else set()
        if info.name in seen:
            return None
        seen.add(info.name)
        owner_env = self._envs.get(info.relpath)
        for base in info.bases:
            found = self.resolve_method(base, method, env=owner_env,
                                        _seen=seen)
            if found is not None:
                return found
        return None

    # -- call-site resolution ----------------------------------------------

    def _resolve_module(self, env: _ModuleEnv) -> None:
        for name, node in env.functions.items():
            qual = f"{env.relpath}::{name}"
            self.calls[qual] = self._function_calls(env, None, node)
        for info in env.classes.values():
            for name, node in info.methods.items():
                qual = f"{env.relpath}::{info.name}.{name}"
                self.calls[qual] = self._function_calls(env, info, node)

    def _function_calls(self, env: _ModuleEnv, cls: Optional[ClassInfo],
                        fn: FunctionNode) -> list[CallSite]:
        locals_types = self._local_types(env, cls, fn)
        sites: list[CallSite] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # a nested def runs later, not as part of fn
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                callee = self._resolve_call(env, cls, chain, locals_types)
                sites.append(CallSite(node.lineno, chain, callee, node))
                self._by_node[id(node)] = callee
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)
        return sites

    def _local_types(self, env: _ModuleEnv, cls: Optional[ClassInfo],
                     fn: FunctionNode) -> dict[str, str]:
        """Local name -> class, from annotations and construction."""
        out: dict[str, str] = {}
        for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs):
            typ = _annotation_class(a.annotation)
            if typ is not None and self._class_named(env, typ) is not None:
                out[a.arg] = typ
        for node in cached_walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                chain = attr_chain(node.value.func)
                if chain:
                    found = self._resolve_name_to_class(env, chain)
                    if found is not None:
                        out.setdefault(name, found.name)
            elif cls is not None:
                value = attr_chain(node.value)
                if value and len(value) == 2 and value[0] == "self":
                    typ = cls.attr_types.get(value[1])
                    if typ is not None:
                        out.setdefault(name, typ)
        return out

    def _resolve_call(self, env: _ModuleEnv, cls: Optional[ClassInfo],
                      chain: Optional[list[str]],
                      locals_types: dict[str, str]) -> Optional[str]:
        if not chain:
            return None
        if chain[0] == "self":
            if cls is None:
                return None
            if len(chain) == 2:
                return self.resolve_method(cls.name, chain[1], env=env)
            if len(chain) == 3:
                typ = cls.attr_types.get(chain[1])
                return self.resolve_method(typ, chain[2], env=env)
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in env.functions:
                return f"{env.relpath}::{name}"
            found = self._class_named(env, name)
            if found is not None:
                return self.resolve_method(found.name, "__init__",
                                           env=self._envs[found.relpath])
            imp = env.imports.get(name)
            if imp is not None and imp[1] is not None:
                target = self._envs.get(imp[0])
                if target is not None and imp[1] in target.functions:
                    return f"{imp[0]}::{imp[1]}"
            return None
        if len(chain) == 2:
            base, meth = chain
            imp = env.imports.get(base)
            if imp is not None and imp[1] is None:  # module alias call
                target = self._envs.get(imp[0])
                if target is not None:
                    if meth in target.functions:
                        return f"{imp[0]}::{meth}"
                    if meth in target.classes:
                        return self.resolve_method(meth, "__init__",
                                                   env=target)
                return None
            typ = locals_types.get(base)
            if typ is not None:
                return self.resolve_method(typ, meth, env=env)
            found = self._class_named(env, base)
            if found is not None:
                return self.resolve_method(found.name, meth, env=env)
        return None

    # -- queries -----------------------------------------------------------

    def callees(self, qualname: str) -> list[CallSite]:
        return self.calls.get(qualname, [])

    def resolve_node(self, call: ast.Call) -> Optional[str]:
        """Resolved callee for a call node seen during the build (rules
        walking the same ASTs use this to splice callees in their own
        traversal order)."""
        return self._by_node.get(id(call))

    def function(self, qualname: str) -> Optional[FunctionInfo]:
        return self.functions.get(qualname)

    def class_info(self, relpath: str, name: str) -> Optional[ClassInfo]:
        env = self._envs.get(relpath)
        return env.classes.get(name) if env else None

    def method_qualnames(self, relpath: str, cls: str) -> Iterator[str]:
        info = self.class_info(relpath, cls)
        if info is not None:
            for name in info.methods:
                yield f"{relpath}::{cls}.{name}"

    def reachable(self, qualname: str, *, max_depth: int = 32
                  ) -> dict[str, tuple[str, ...]]:
        """Every function transitively reachable from ``qualname``
        through RESOLVED calls, mapped to one exemplar call path
        (tuple of qualnames, caller first).  Cycle-safe; unresolved
        calls contribute nothing (the conservative reading is the rule
        family's job)."""
        out: dict[str, tuple[str, ...]] = {}
        frontier: list[tuple[str, tuple[str, ...]]] = [(qualname, ())]
        depth = 0
        while frontier and depth < max_depth:
            depth += 1
            nxt: list[tuple[str, tuple[str, ...]]] = []
            for qual, path in frontier:
                for site in self.calls.get(qual, ()):
                    callee = site.callee
                    if callee is None or callee in out \
                            or callee == qualname:
                        continue
                    out[callee] = path + (qual,)
                    nxt.append((callee, path + (qual,)))
            frontier = nxt
        return out


def graph_for(project: Project) -> CallGraph:
    """Build (or reuse) the project's call graph.  Rule modules run in
    sequence over the same Project instance; one build serves all."""
    cached = getattr(project, "_callgraph", None)
    if isinstance(cached, CallGraph) and cached.project is project:
        return cached
    graph = CallGraph(project)
    project._callgraph = graph
    return graph
