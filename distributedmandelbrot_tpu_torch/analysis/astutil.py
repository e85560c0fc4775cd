"""Small ``ast`` helpers shared by the rule modules (stdlib only)."""

from __future__ import annotations

import ast
from typing import Iterator, Optional

FunctionNode = ast.FunctionDef | ast.AsyncFunctionDef


def cached_walk(node: ast.AST) -> tuple:
    """Memoized :func:`ast.walk`: the flat subtree tuple is cached on
    every node, built bottom-up so a walk of a function reuses the
    cached walks of its statements and a walk of the module reuses the
    functions'.  The many rule families that each re-scan the same file
    trees (and the dataflow fixpoint, which re-walks the same statements
    every pass) then pay one child traversal per node for the whole run
    instead of one subtree traversal per scan.  Yields the same node
    set as ``ast.walk`` in depth-first preorder (no rule depends on
    ``ast.walk``'s breadth-first order).  Safe because the analyzer
    never mutates parsed trees."""
    cached = getattr(node, "_dmtpu_walk", None)
    if cached is not None:
        return cached
    stack = [(node, False)]
    while stack:
        n, expanded = stack.pop()
        if expanded:
            parts = [n]
            for c in ast.iter_child_nodes(n):
                parts.extend(c._dmtpu_walk)
            n._dmtpu_walk = tuple(parts)
        else:
            stack.append((n, True))
            for c in ast.iter_child_nodes(n):
                if getattr(c, "_dmtpu_walk", None) is None:
                    stack.append((c, False))
    return node._dmtpu_walk


def attr_chain(node: ast.expr) -> Optional[list[str]]:
    """Dotted name parts of a Name/Attribute chain, outermost first:
    ``self.store.load_payload`` -> ``["self", "store", "load_payload"]``.
    None when the chain passes through anything else (a call, a
    subscript), because then the receiver's identity isn't lexical.
    Memoized on the node (callers only read the result); 0 is the
    unset sentinel since the answer is a list or None."""
    root = node
    cached = getattr(root, "_dmtpu_chain", 0)
    if cached != 0:
        return cached
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        root._dmtpu_chain = parts
        return parts
    root._dmtpu_chain = None
    return None


def call_chain(call: ast.Call) -> Optional[list[str]]:
    return attr_chain(call.func)


def self_attr(node: ast.expr) -> Optional[str]:
    """``attr`` when the expression is exactly ``self.<attr>``."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def subscript_base_self_attr(node: ast.expr) -> Optional[str]:
    """``attr`` when the expression is ``self.<attr>[...][...]``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return self_attr(node)


def dotted_names(node: ast.AST) -> Iterator[str]:
    """Every dotted name mentioned anywhere inside ``node`` (decorator
    matching: ``partial(jax.jit, ...)`` yields ``partial`` and
    ``jax.jit``)."""
    for sub in cached_walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)):
            chain = attr_chain(sub)
            if chain:
                yield ".".join(chain)


def class_defs(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            yield node


def methods_of(cls: ast.ClassDef) -> Iterator[FunctionNode]:
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def walk_skipping_nested_async(node: ast.AST) -> tuple:
    """Like ``ast.walk`` over a function body, but does not descend into
    nested ``async def``s (each async def is analyzed as its own scope).
    Nested *sync* defs and lambdas ARE descended into: lexically they run
    wherever they are called from, which for our rules is the enclosing
    coroutine unless shipped off-loop (and then the call node we flag
    does not appear — ``asyncio.to_thread(f, x)`` passes ``f`` uncalled).
    Memoized on the node like :func:`cached_walk` — the lock and async
    analyses re-walk the same statements every fixpoint pass."""
    cached = getattr(node, "_dmtpu_walk_na", None)
    if cached is not None:
        return cached
    out = []
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.AsyncFunctionDef):
            continue
        out.append(sub)
        stack.extend(ast.iter_child_nodes(sub))
    node._dmtpu_walk_na = tuple(out)
    return node._dmtpu_walk_na
