"""``obs-*`` rules: instrumentation names and the registry stay in sync.

``obs-name`` checks the forward direction (every instrumentation
literal is registered); ``obs-dead`` checks the reverse (every
registration is instrumented or at least referenced) — the registry
must describe the fleet's actual telemetry, not its aspirations.

The ``results_accepted`` collision (PR 2) happened because two call
sites spelled the same metric differently and nothing arbitrated.
``obs/names.py`` is the arbiter; this rule is its enforcement — every
string literal passed to an instrumentation method
(``counters.inc("...")``, ``registry.observe("...")``,
``spans.record("...", ...)``) must be a constant registered there or a
legacy alias spelling.

This used to live in ``tools/check_metrics.py --names`` (a side tool
the gate had to remember to run); folding it into ``dmtpu check``
makes name drift a tier-1 failure.  The tool still delegates here so
its ``--names`` flag keeps working.

Like every rule in this package, the known-name set is extracted from
the AST of ``obs/names.py`` — the module is never imported.  Projects
without a names module (rule fixtures) produce no findings.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from distributedmandelbrot_tpu_torch.analysis.astutil import (attr_chain,
                                                        cached_walk)
from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project,
                                                       Rule, SourceFile)

RULES = (
    Rule("obs-name", "obs", "error",
         "metric/span name literals at instrumentation sites must be "
         "registered in obs/names.py"),
    Rule("obs-dead", "obs", "warning",
         "names registered in obs/names.py must be instrumented (or "
         "referenced) somewhere — unused registrations are drift"),
    Rule("obs-event", "obs", "error",
         "flight-recorder event literals must be registered in "
         "obs/events.py, and every registered event must be emitted "
         "(or referenced) somewhere"),
)

NAMES_SUFFIX = "obs/names.py"
EVENTS_SUFFIX = "obs/events.py"

# The flight recorder's emit surface: ``flight.note("...")`` (module
# call) — the same receiver-hint gating the metric tables use, so a
# dict's or notebook's unrelated ``.note`` never trips the scan.
EVENT_METHODS = {"note": ("flight",)}

# Method -> receiver spellings that identify the instrumented object
# (gating hints keep dict.get("key") from tripping the scan — same
# tables check_metrics --names used).
_METRIC_RECEIVERS = ("counter", "registry", "reg")
INSTRUMENT_METHODS = {
    "inc": _METRIC_RECEIVERS, "get": _METRIC_RECEIVERS,
    "observe": _METRIC_RECEIVERS, "set_gauge": _METRIC_RECEIVERS,
    "timed": _METRIC_RECEIVERS, "counter": _METRIC_RECEIVERS,
    "gauge": _METRIC_RECEIVERS, "histogram": _METRIC_RECEIVERS,
    "record": ("span",),
}


def _names_file(project: Project) -> Optional[str]:
    for rel in sorted(project.files):
        if rel.endswith(NAMES_SUFFIX):
            return rel
    return None


def known_names(project: Project) -> Optional[set[str]]:
    """Registered names from the names module's AST: every uppercase
    top-level string constant plus the LEGACY_ALIASES dict's legacy
    spellings.  None when the project has no names module."""
    rel = _names_file(project)
    if rel is None:
        return None
    known: set[str] = set()
    for node in project.files[rel].tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value = node.target.id, node.value
        else:
            continue
        if target.isupper() and isinstance(value, ast.Constant) \
                and isinstance(value.value, str):
            known.add(value.value)
        elif target == "LEGACY_ALIASES" and isinstance(value, ast.Dict):
            for v in value.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    known.add(v.value)
    return known


def iter_sites(project: Project) -> Iterator[tuple[SourceFile, int, str]]:
    """(file, line, literal) for every instrumentation site whose first
    argument is a string literal."""
    for rel in sorted(project.files):
        sf = project.files[rel]
        for node in cached_walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in INSTRUMENT_METHODS):
                continue
            recv_chain = attr_chain(node.func.value)
            if not recv_chain:
                continue
            recv = recv_chain[-1].lower()
            if not any(h in recv for h in INSTRUMENT_METHODS[node.func.attr]):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            yield sf, node.args[0].lineno, node.args[0].value


def registered_consts(project: Project
                      ) -> Optional[dict[str, tuple[str, int]]]:
    """Constant target -> (wire name, definition line) for every
    uppercase top-level string constant in the names module (legacy
    alias spellings are read-side compatibility, not registrations,
    so LEGACY_ALIASES is excluded here)."""
    rel = _names_file(project)
    if rel is None:
        return None
    out: dict[str, tuple[str, int]] = {}
    for node in project.files[rel].tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value = node.target.id, node.value
        else:
            continue
        if target.isupper() and isinstance(value, ast.Constant) \
                and isinstance(value.value, str):
            out[target] = (value.value, node.lineno)
    return out


def _dead_findings(project: Project) -> list[Finding]:
    """obs-dead: a registered constant nobody instruments.  'Used'
    means an ``<...names>.CONST`` attribute reference or a
    ``from ...obs.names import CONST`` anywhere outside the names
    module, or the wire spelling appearing as an instrumentation-site
    literal — anything else is a name the registry promises but no
    layer ever emits."""
    consts = registered_consts(project)
    if not consts:
        return []
    names_rel = _names_file(project)
    used: set[str] = set()
    for rel in sorted(project.files):
        if rel == names_rel:
            continue
        for node in cached_walk(project.files[rel].tree):
            if isinstance(node, ast.Attribute) and node.attr.isupper():
                chain = attr_chain(node)
                if chain and len(chain) >= 2 \
                        and "names" in chain[-2].lower():
                    used.add(node.attr)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.endswith("obs.names"):
                used.update(alias.name for alias in node.names)
    lit_used = {name for _, _, name in iter_sites(project)}
    rule = RULES[1]
    sf = project.files[names_rel]
    return [
        Finding(rule.id, rule.severity, sf.relpath, line,
                f"registered name {target} ({wire!r}) is never "
                f"instrumented or referenced outside obs/names.py")
        for target, (wire, line) in sorted(consts.items())
        if target not in used and wire not in lit_used]


def _events_file(project: Project) -> Optional[str]:
    for rel in sorted(project.files):
        if rel.endswith(EVENTS_SUFFIX):
            return rel
    return None


def known_events(project: Project) -> Optional[dict[str, tuple[str, int]]]:
    """Constant target -> (event name, definition line) from the events
    module's AST (uppercase top-level string constants, same extraction
    as the names module).  None when the project has no events module."""
    rel = _events_file(project)
    if rel is None:
        return None
    out: dict[str, tuple[str, int]] = {}
    for node in project.files[rel].tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            target, value = node.target.id, node.value
        else:
            continue
        if target.isupper() and isinstance(value, ast.Constant) \
                and isinstance(value.value, str):
            out[target] = (value.value, node.lineno)
    return out


def iter_event_sites(project: Project
                     ) -> Iterator[tuple[SourceFile, int, str]]:
    """(file, line, literal) for every ``flight.note("...")`` whose
    first argument is a string literal."""
    for rel in sorted(project.files):
        sf = project.files[rel]
        for node in cached_walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in EVENT_METHODS):
                continue
            recv_chain = attr_chain(node.func.value)
            if not recv_chain:
                continue
            recv = recv_chain[-1].lower()
            if not any(h in recv for h in EVENT_METHODS[node.func.attr]):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            yield sf, node.args[0].lineno, node.args[0].value


def _event_findings(project: Project) -> list[Finding]:
    """obs-event, both directions: a ``flight.note`` literal outside
    the registry, and a registered event no layer ever emits.  'Used'
    means an ``<...events>.CONST`` attribute reference or a
    ``from ...obs.events import CONST`` outside the events module, or
    the event spelling appearing as a note-site literal — same
    semantics as obs-dead, because an event postmortem can never see
    is exactly as much drift as a metric nobody increments."""
    consts = known_events(project)
    if consts is None:
        return []
    rule = RULES[2]
    events_rel = _events_file(project)
    registered = {wire for wire, _ in consts.values()}
    out = [
        Finding(rule.id, rule.severity, sf.relpath, line,
                f"flight event {name!r} is not registered in "
                f"obs/events.py")
        for sf, line, name in iter_event_sites(project)
        if name not in registered]
    used: set[str] = set()
    for rel in sorted(project.files):
        if rel == events_rel:
            continue
        for node in cached_walk(project.files[rel].tree):
            if isinstance(node, ast.Attribute) and node.attr.isupper():
                chain = attr_chain(node)
                if chain and len(chain) >= 2 \
                        and "events" in chain[-2].lower():
                    used.add(node.attr)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.endswith("obs.events"):
                used.update(alias.name for alias in node.names)
    lit_used = {name for _, _, name in iter_event_sites(project)}
    sf = project.files[events_rel]
    out.extend(
        Finding(rule.id, rule.severity, sf.relpath, line,
                f"registered event {target} ({wire!r}) is never emitted "
                f"or referenced outside obs/events.py")
        for target, (wire, line) in sorted(consts.items())
        if target not in used and wire not in lit_used)
    return out


def check(project: Project) -> list[Finding]:
    out: list[Finding] = []
    known = known_names(project)
    if known is not None:
        rule = RULES[0]
        out.extend(
            Finding(rule.id, rule.severity, sf.relpath, line,
                    f"metric name {name!r} is not registered in "
                    f"obs/names.py")
            for sf, line, name in iter_sites(project)
            if name not in known)
        out.extend(_dead_findings(project))
    out.extend(_event_findings(project))
    return out
