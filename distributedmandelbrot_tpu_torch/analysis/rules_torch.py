"""Kernel-launch rules for ops/ and parallel/ (the ``torch`` family).

A function is *launching* when it is a module-level function or a
method of a module-level class and its body — the functions nested in
it included — calls an entry of the kernel library: an attribute call
``<lib>.dm_<name>(...)``, the idiom every wrapper of ``ops/_build``'s
library uses.  The library's queries (``dm_error_string``,
``dm_persistent_*``, ``dm_mega_max_tiles``) launch nothing and do not
make a function launching.  A nested function is checked as part of the
launching function that holds it and is not a launching function of its
own: it runs inside the launching call all the same (K9's host loop
launches from a nested ``launch`` and reads its census from a nested
``segments``).  :func:`launching_functions` exposes the scope.

A wrapper enqueues its launch on the device's current stream and
returns; the worker's dispatch/materialize split overlaps the next
launch with the last one's copy-out on exactly that asynchrony.  So:

``torch-host-sync`` — a device read inside a launching function:
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``torch.cuda.synchronize()`` and ``<stream>.synchronize()`` wait for the
card and destroy the asynchronous dispatch.  ``int()``, ``float()`` and
``np.asarray`` are not flagged: in a wrapper they marshal host
arguments into the launch's C parameters and never touch the device.

``torch-dtype-mix`` — half-precision literals (``torch.bfloat16``,
``torch.float16``, ``torch.half``, ``.half()``, ``.bfloat16()``) in a
launching function: a half value that leaks into an output costs ~3
decimal digits, and escape counts are a bit-exact contract.  The
warning is silenced in modules that import from ``ops/mixed_precision``
— the reviewed opt-in for the census's bf16 shadow.

``jax-impure`` and ``jax-dtype`` have no counterpart here.  Eager
PyTorch runs a wrapper's Python on every call, so there is no trace for
a side effect to vanish from; and it computes in f64 without a global
switch, so the port has no ``utils/precision`` to route through.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator

from distributedmandelbrot_tpu_torch.analysis.astutil import (FunctionNode,
                                                              cached_walk,
                                                              class_defs,
                                                              dotted_names,
                                                              methods_of)
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding,
                                                             Project, Rule,
                                                             SourceFile)

RULES = (
    Rule("torch-host-sync", "torch", "error",
         "device read inside a kernel-launching function"),
    Rule("torch-dtype-mix", "torch", "warning",
         "half-precision dtype literal in a kernel-launching function "
         "bypassing ops/mixed_precision"),
)

SCOPE_DIRS = ("ops", "parallel")

ENTRY_PREFIX = "dm_"

QUERY_PREFIXES = ("dm_error_string", "dm_persistent_", "dm_mega_max_tiles")

DEVICE_READS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})

DTYPE_HALF = frozenset({"bfloat16", "float16", "half"})

HALF_METHODS = frozenset({"half", "bfloat16"})


@dataclass(frozen=True)
class Launcher:
    """One launching function: its file, qualified name, line and the
    kernel-library entries it calls."""

    path: str
    name: str
    line: int
    entries: tuple[str, ...]


def _kernel_entry(node: ast.AST) -> str | None:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr.startswith(ENTRY_PREFIX) \
                and not attr.startswith(QUERY_PREFIXES):
            return attr
    return None


def _candidates(sf: SourceFile) -> Iterator[tuple[str, FunctionNode]]:
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
    for cls in class_defs(sf.tree):
        for fn in methods_of(cls):
            yield f"{cls.name}.{fn.name}", fn


def _launchers_in(sf: SourceFile) -> Iterator[tuple[Launcher, FunctionNode]]:
    for name, fn in _candidates(sf):
        entries = {e for stmt in fn.body for node in cached_walk(stmt)
                   if (e := _kernel_entry(node)) is not None}
        if entries:
            yield Launcher(sf.relpath, name, fn.lineno,
                           tuple(sorted(entries))), fn


def launching_functions(project: Project) -> list[Launcher]:
    """Every launching function under the scope directories."""
    return [launcher for sf in project.in_dirs(*SCOPE_DIRS)
            for launcher, _ in _launchers_in(sf)]


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.in_dirs(*SCOPE_DIRS):
        has_mixed = _imports_mixed_precision(sf)
        for launcher, fn in _launchers_in(sf):
            findings.extend(_check_launching(sf, launcher.name, fn,
                                             has_mixed))
    return findings


def _imports_mixed_precision(sf: SourceFile) -> bool:
    """The half-precision opt-in: any import from ops/mixed_precision
    (or a dotted use of its helpers) marks the module as a reviewed
    mixed-precision site."""
    for node in cached_walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith("mixed_precision"):
            return True
    return any(".mixed_precision." in d or d.startswith("mixed_precision.")
               for d in dotted_names(sf.tree))


def _reads_device(call: ast.Call) -> str | None:
    """The read's spelling when the call waits for the card."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in DEVICE_READS:
        return f".{attr}()"
    if attr == "to":
        targets = list(call.args[:1]) + [kw.value for kw in call.keywords
                                          if kw.arg == "device"]
        if any(isinstance(t, ast.Constant) and t.value == "cpu"
               for t in targets):
            return '.to("cpu")'
    return None


def _check_launching(sf: SourceFile, name: str, fn: FunctionNode,
                     has_mixed: bool) -> list[Finding]:
    out: list[Finding] = []

    def flag(rule: str, severity: str, line: int, msg: str) -> None:
        out.append(Finding(rule, severity, sf.relpath, line,
                           f"{msg} (in launching function {name})"))

    # Nested defs are part of the launching function -> full walk of the
    # body (the decorator list runs at def time, outside any launch).
    for stmt in fn.body:
        for node in cached_walk(stmt):
            if isinstance(node, ast.Call):
                read = _reads_device(node)
                if read is not None:
                    flag("torch-host-sync", "error", node.lineno,
                         f"{read} waits for the device and ends the "
                         f"launch's asynchrony")
                elif not has_mixed and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in HALF_METHODS:
                    flag("torch-dtype-mix", "warning", node.lineno,
                         f".{node.func.attr}() without the "
                         f"ops/mixed_precision opt-in in the module")
            elif not has_mixed and isinstance(node, ast.Attribute) \
                    and node.attr in DTYPE_HALF \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                flag("torch-dtype-mix", "warning", node.lineno,
                     f"dtype literal torch.{node.attr} without the "
                     f"ops/mixed_precision opt-in in the module")
    return out
