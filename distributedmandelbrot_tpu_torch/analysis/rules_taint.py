"""``taint-*`` rules: untrusted wire input reaching a dangerous sink.

Every integer a peer sends is a suggestion until a sanitizer proves it
in-range.  The dataflow layer (``analysis/dataflow.py``) tracks values
from the network reads — ``reader.readexactly`` / ``sock.recv`` / the
``framing`` helpers / struct-unpacks of wire bytes — to the places a
hostile value does damage:

- ``taint-alloc``: a tainted value sizes an allocation — ``bytes(n)`` /
  ``bytearray(n)``, an exact-length read's byte count, a numpy shape or
  ``frombuffer`` count.  A 4 GiB ``count`` field should cost the peer a
  dropped connection, not the coordinator its heap.
- ``taint-index``: a tainted value indexes or slices a container.  The
  scheduler's dicts and the store's level arrays are keyed by validated
  geometry; raw wire integers must pass ``validate_indices`` /
  ``net.protocol`` bounds first.
- ``taint-loop``: a tainted value bounds a loop (``range(n)`` or a
  ``while`` condition) — the unbounded-iteration flavor of the same
  attack.
- ``taint-struct``: a tainted value reaches a ``struct`` format string
  (repeat counts compile attacker-chosen buffer sizes).

Sanitizers: ``net.protocol.validate_*`` (the sanctioned decode path),
``core.geometry.validate_indices``, any ``*_in_range`` predicate, a
range/clamp comparison guard, and ``min()`` against a clean bound.
Alloc/loop/struct sinks are also checked interprocedurally: passing a
tainted value to a helper whose parameter reaches such a sink
unsanitized fires at the call site, naming the flow.  Index sinks stay
intra-procedural — helpers like the scheduler guard keys dynamically,
and the boundary surfaces must sanitize before handing values inward
anyway.
"""

from __future__ import annotations

from distributedmandelbrot_tpu_torch.analysis import dataflow
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project,
                                                       Rule)

RULES = (
    Rule("taint-alloc", "taint", "error",
         "wire-tainted value sizes an allocation without a sanitizer"),
    Rule("taint-index", "taint", "error",
         "wire-tainted value indexes/slices a container without a "
         "sanitizer"),
    Rule("taint-loop", "taint", "error",
         "wire-tainted value bounds a loop without a sanitizer"),
    Rule("taint-struct", "taint", "error",
         "wire-tainted value reaches a struct format string"),
)

# Network surfaces only: these dirs speak to anonymous peers.  storage/,
# obs/, ops/ see data the coordinator already validated.
SCOPE_DIRS = ("net", "coordinator", "serve", "worker", "viewer")

_RULE_BY_KIND = {
    "alloc": RULES[0],
    "index": RULES[1],
    "loop": RULES[2],
    "struct": RULES[3],
}

# Interprocedural param-sink findings are limited to the resource-shaped
# sinks; see the module docstring for why index stays local.
_CALL_SINK_KINDS = frozenset({"alloc", "loop", "struct"})


def _in_scope(relpath: str) -> bool:
    # relpath carries the package prefix: "distributedmandelbrot_tpu_torch/net/…"
    parts = relpath.split("/")
    return len(parts) >= 2 and parts[-2] in SCOPE_DIRS


def check(project: Project) -> list[Finding]:
    taint = dataflow.analyze(project)
    findings: list[Finding] = []
    for qual, info in taint.graph.functions.items():
        if not _in_scope(info.relpath):
            continue
        for sink in taint.wire_sinks(qual):
            rule = _RULE_BY_KIND[sink.kind]
            findings.append(Finding(
                rule.id, rule.severity, info.relpath, sink.line,
                f"wire-tainted value reaches {sink.detail} in "
                f"{info.name}() without a validate_* sanitizer"))
        seen_lines = {(s.kind, s.line) for s in taint.wire_sinks(qual)}
        for (line, callee, kind, detail, sink_rel, sink_line) \
                in taint.wire_call_sinks(qual):
            if kind not in _CALL_SINK_KINDS:
                continue
            if (kind, line) in seen_lines:
                continue  # already reported as a direct sink on this line
            rule = _RULE_BY_KIND[kind]
            callee_name = callee.rsplit("::", 1)[-1]
            findings.append(Finding(
                rule.id, rule.severity, info.relpath, line,
                f"wire-tainted value passed to {callee_name}() reaches "
                f"{detail} ({sink_rel}:{sink_line}) without a validate_* "
                f"sanitizer"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
