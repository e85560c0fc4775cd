"""``fsm-*`` rules: explicit-state checking of the extracted protocol
automata (v4 of the analysis stack).

``rules_proto``'s frame-parity model is linear: it mirrors the source
order of reads and writes and cannot follow the session tier's loops,
capability-gated arms, or piggybacked grants.  This family closes that
blind spot by model checking instead of mirroring: :mod:`.fsm` lifts
each wire exchange's endpoints into nondeterministic send/recv automata
and :mod:`.explore` exhaustively walks the asynchronous client x server
product under every realistic capability configuration.

- ``fsm-dual`` — a send with no matching receive arm on the peer,
  either statically (no arm for the label at all) or dynamically (a
  reachable product state wedges with an unconsumable queue head).
  The crash-interleaving model's exactly-once assertion reports here
  too: a double commit is the persistence pipeline's dual failure.
- ``fsm-deadlock`` — a reachable product state where both endpoints
  wait forever, a state that cannot reach end-of-stream (liveness), or
  a crash interleaving that quiesces with the tile lost.
- ``fsm-cap-gate`` — hello-mask asymmetry: a receive arm demands a
  capability the sender does not guarantee when emitting that label.
- ``fsm-dead-arm`` — a receive arm no explored configuration of any
  exchange ever exercises (the PR 13 redirect refactor's leftovers),
  or a ``faults.hit`` crashpoint seam the crash model does not cover.

Like the rest of the package: stdlib ``ast`` only, never imports the
modules under analysis, and skips silently on fixture projects that
lack the endpoint qualnames.
"""

from __future__ import annotations

import ast
from typing import Optional

from distributedmandelbrot_tpu_torch.analysis import explore, fsm
from distributedmandelbrot_tpu_torch.analysis.astutil import attr_chain, cached_walk
from distributedmandelbrot_tpu_torch.analysis.engine import (PACKAGE, Finding,
                                                       Project, Rule)

RULES = (
    Rule("fsm-dual", "fsm", "error",
         "every reachable send needs a matching receive arm on the peer "
         "(product exploration; crash model's exactly-once)"),
    Rule("fsm-deadlock", "fsm", "error",
         "no reachable product state may wait forever or lose "
         "liveness-to-EOS (crash model's no-lost-tile)"),
    Rule("fsm-cap-gate", "fsm", "error",
         "a receive arm must not demand capabilities the sender does "
         "not guarantee for that label"),
    Rule("fsm-dead-arm", "fsm", "warning",
         "receive arms never exercised in any explored configuration, "
         "and crashpoint seams outside the crash model"),
)

_BY_KIND = {
    "dual": "fsm-dual",
    "crash-dual": "fsm-dual",
    "deadlock": "fsm-deadlock",
    "liveness": "fsm-deadlock",
    "crash-lost": "fsm-deadlock",
    "cap-gate": "fsm-cap-gate",
}

_SEVERITY = {r.id: r.severity for r in RULES}

FAULTS_SUFFIX = "utils/faults.py"


def _fallback_origin(pair: fsm.EndpointPair) -> tuple:
    for auto in (pair.client, pair.server):
        for e in auto.edges:
            if e.origin[0]:
                return e.origin
    return ("", 0)


def _mk(rule: str, origin: tuple, message: str) -> Finding:
    path, line = origin
    return Finding(rule, _SEVERITY[rule], path, line or 1, message)


def _violation_findings(rep: explore.ExploreReport) -> list[Finding]:
    out: list[Finding] = []
    seen: set = set()
    for pr in rep.pairs:
        fb = _fallback_origin(pr.pair)
        for v in pr.violations:
            rule = _BY_KIND.get(v.kind)
            if rule is None:
                continue
            origin = v.origin if v.origin[0] else fb
            key = (rule, origin, v.message)
            if key in seen:
                continue
            seen.add(key)
            out.append(_mk(rule, origin, v.message))
    return out


def _dead_arm_findings(rep: explore.ExploreReport) -> list[Finding]:
    return [
        _mk("fsm-dead-arm", origin,
            f"receive arm for {label} is never exercised in any "
            f"explored configuration of any exchange")
        for origin, label in rep.dead_arms()]


def _crash_findings(project: Project) -> list[Finding]:
    """The persistence-pipeline model check, anchored at the faults
    module that registers the crash seams.  Only meaningful on the real
    tree (fixture projects carry no faults module)."""
    faults_rel: Optional[str] = None
    for rel in sorted(project.files):
        if rel.endswith(FAULTS_SUFFIX):
            faults_rel = rel
            break
    if faults_rel is None:
        return []
    out: list[Finding] = []
    rep = explore.explore_crash_model()
    for v in rep.violations:
        rule = _BY_KIND.get(v.kind)
        if rule is not None:
            out.append(_mk(rule, (faults_rel, 1), v.message))
    for seam in sorted(set(explore.CRASH_SEAMS) - rep.seams_fired):
        out.append(_mk(
            "fsm-dead-arm", (faults_rel, 1),
            f"crash seam {seam!r} never fired in the interleaving "
            f"model — its window predicate is unreachable"))
    # Coverage the other way: every crashpoint the code registers via
    # faults.hit("...") must be a seam the model crashes at, or the
    # model's exactly-once proof silently excludes that window.
    for rel in sorted(project.files):
        sf = project.files[rel]
        for node in cached_walk(sf.tree):
            if not (isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            chain = attr_chain(node.func)
            if not chain or chain[-1] != "hit" \
                    or "faults" not in chain[:-1]:
                continue
            point = node.args[0].value
            if point not in explore.CRASH_SEAMS:
                out.append(_mk(
                    "fsm-dead-arm", (rel, node.args[0].lineno),
                    f"crashpoint seam {point!r} is not covered by the "
                    f"crash-interleaving model (register it in "
                    f"analysis/explore.py CRASH_SEAMS)"))
    return out


def check(project: Project) -> list[Finding]:
    pairs = fsm.build_pairs(project)
    out: list[Finding] = []
    if pairs:
        rep = explore.explore_all(pairs)
        out.extend(_violation_findings(rep))
        out.extend(_dead_arm_findings(rep))
    out.extend(_crash_findings(project))
    return out
