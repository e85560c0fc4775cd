"""Validate the exporter's /metrics text with a minimal Prometheus parser.

The exporter hand-writes text exposition format v0.0.4 (obs/exporter.py)
rather than depending on a client library, so nothing in the test suite
would catch a malformed line a real Prometheus scraper rejects.  This
tool is that check: a from-the-spec line parser plus the format's
structural invariants, run against

1. a synthetic registry exercising every instrument shape (counters,
   callback gauges, NaN gauges, labeled and unlabeled histograms,
   sanitized names), and
2. (default; ``--offline`` skips it) a live embedded coordinator on
   loopback — the same bytes ``dmtpu serve``'s exporter emits, fetched
   over real HTTP.

Tier-1 runnable: JAX_PLATFORMS=cpu, loopback only, no new deps.

Usage: python tools/check_metrics.py [--offline] [--url http://...:P/metrics]
"""

from __future__ import annotations

import argparse
import math
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

# One sample line: name{labels} value  (no timestamps — the exporter
# never emits them; a timestamp here is a bug, not an option).
_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = rf'{_NAME}="(?:[^"\\]|\\.)*"'
SAMPLE_RE = re.compile(
    rf"^(?P<name>{_NAME})"
    rf"(?:\{{(?P<labels>{_LABEL}(?:,{_LABEL})*)?\}})?"
    rf" (?P<value>[0-9eE+.\-]+|NaN|\+Inf|-Inf)$")
LABEL_RE = re.compile(rf'({_NAME})="((?:[^"\\]|\\.)*)"')


class MetricsFormatError(AssertionError):
    pass


def _value(text: str) -> float:
    if text == "NaN":
        return math.nan
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    return float(text)


def parse_exposition(text: str) -> dict:
    """Parse text exposition v0.0.4 into
    ``{family: {"type": str, "help": str|None, "samples": [...]}}`` where
    each sample is ``(name, labels_dict, value)``.  Raises
    :class:`MetricsFormatError` on any line a spec-following scraper
    would reject."""
    if not text.endswith("\n"):
        raise MetricsFormatError("exposition must end with a newline")
    families: dict[str, dict] = {}
    current: str | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not re.fullmatch(_NAME, parts[2]):
                raise MetricsFormatError(f"line {lineno}: bad HELP: {line!r}")
            families.setdefault(parts[2], {"type": None, "samples": []})[
                "help"] = parts[3]
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise MetricsFormatError(f"line {lineno}: bad TYPE: {line!r}")
            fam = families.setdefault(parts[2], {"samples": []})
            if fam.get("type") is not None:
                raise MetricsFormatError(
                    f"line {lineno}: duplicate TYPE for {parts[2]}")
            if fam["samples"]:
                raise MetricsFormatError(
                    f"line {lineno}: TYPE for {parts[2]} after its samples")
            fam["type"] = parts[3]
            current = parts[2]
            continue
        if line.startswith("#"):
            continue  # comment
        m = SAMPLE_RE.match(line)
        if m is None:
            raise MetricsFormatError(f"line {lineno}: bad sample: {line!r}")
        name = m.group("name")
        labels = dict(LABEL_RE.findall(m.group("labels") or ""))
        # Histogram/summary series attach to their base family.
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        fam_name = base if base in families else name
        if fam_name not in families:
            raise MetricsFormatError(
                f"line {lineno}: sample {name!r} has no TYPE line")
        if fam_name != current:
            raise MetricsFormatError(
                f"line {lineno}: sample {name!r} outside its family block")
        families[fam_name]["samples"].append(
            (name, labels, _value(m.group("value"))))
    return families


def check_invariants(families: dict) -> None:
    """Structural invariants beyond line syntax: histogram buckets are
    cumulative with a +Inf bucket equal to _count, counters are finite
    and non-negative, no family is empty."""
    for fam_name, fam in families.items():
        if not fam["samples"]:
            raise MetricsFormatError(f"{fam_name}: TYPE line but no samples")
        if fam["type"] == "counter":
            for name, _, value in fam["samples"]:
                if not (value >= 0 and math.isfinite(value)):
                    raise MetricsFormatError(
                        f"{fam_name}: counter value {value}")
        if fam["type"] != "histogram":
            continue
        # Group the series by their non-le labels (one child per set).
        children: dict[tuple, dict] = {}
        for name, labels, value in fam["samples"]:
            rest = tuple(sorted((k, v) for k, v in labels.items()
                                if k != "le"))
            child = children.setdefault(
                rest, {"buckets": [], "sum": None, "count": None})
            if name == fam_name + "_bucket":
                if "le" not in labels:
                    raise MetricsFormatError(f"{fam_name}: bucket without le")
                child["buckets"].append((_value(labels["le"]), value))
            elif name == fam_name + "_sum":
                child["sum"] = value
            elif name == fam_name + "_count":
                child["count"] = value
            else:
                raise MetricsFormatError(
                    f"{fam_name}: stray histogram series {name!r}")
        for rest, child in children.items():
            if child["sum"] is None or child["count"] is None:
                raise MetricsFormatError(
                    f"{fam_name}{dict(rest)}: missing _sum/_count")
            buckets = child["buckets"]
            if not buckets or buckets[-1][0] != math.inf:
                raise MetricsFormatError(
                    f"{fam_name}{dict(rest)}: no +Inf bucket")
            bounds = [b for b, _ in buckets]
            cums = [c for _, c in buckets]
            if bounds != sorted(bounds):
                raise MetricsFormatError(
                    f"{fam_name}{dict(rest)}: bucket bounds out of order")
            if any(b > a for a, b in zip(cums[1:], cums)):
                raise MetricsFormatError(
                    f"{fam_name}{dict(rest)}: buckets not cumulative")
            if cums[-1] != child["count"]:
                raise MetricsFormatError(
                    f"{fam_name}{dict(rest)}: +Inf bucket {cums[-1]} != "
                    f"_count {child['count']}")


def _sample_registry():
    """Every instrument shape the exporter can render.  Its names are
    synthetic, not the fleet's telemetry: each site is exempt from the
    ``obs-name`` audit that ``--names`` runs over this file too."""
    from distributedmandelbrot_tpu_torch.obs.metrics import Registry
    reg = Registry()
    # dmtpu: ignore[obs-name] — synthetic
    reg.counter("requests_total", help="plain counter").inc(3)
    # dmtpu: ignore[obs-name] — synthetic
    reg.counter("by_outcome", labels={"outcome": "tier1_hit"}).inc(2)
    # dmtpu: ignore[obs-name] — synthetic
    reg.counter("by_outcome", labels={"outcome": "computed"}).inc()
    reg.gauge("depth", help="plain gauge").set(7.5)  # dmtpu: ignore[obs-name]
    reg.gauge("ratio", fn=lambda: 0.25)  # dmtpu: ignore[obs-name]
    # renders NaN, must still parse
    reg.gauge("broken", fn=lambda: 1 / 0)  # dmtpu: ignore[obs-name]
    for v in (0.0001, 0.004, 0.25, 2.0, 1e9):  # incl. overflow bucket
        reg.observe("latency_seconds", v)  # dmtpu: ignore[obs-name]
        # dmtpu: ignore[obs-name] — synthetic
        reg.observe("latency_seconds", v, labels={"outcome": "store_hit"})
    # dmtpu: ignore[obs-name] — synthetic
    reg.counter("weird.name-x", help="sanitized on render").inc()
    return reg


def check_rendered() -> int:
    from distributedmandelbrot_tpu_torch.obs.exporter import render_prometheus
    text = render_prometheus(_sample_registry())
    families = parse_exposition(text)
    check_invariants(families)
    # The sample registry's own facts survived the round trip.
    assert families["requests_total"]["samples"][0][2] == 3
    assert families["weird_name_x"]["samples"][0][2] == 1
    lat = families["latency_seconds"]
    assert lat["type"] == "histogram"
    counts = [v for n, labels, v in lat["samples"]
              if n == "latency_seconds_count"]
    assert counts == [5, 5], counts
    print(f"offline: {len(families)} families, "
          f"{sum(len(f['samples']) for f in families.values())} samples OK")
    return len(families)


def check_live(url: str | None) -> None:
    import urllib.request
    if url is None:
        import tempfile
        from distributedmandelbrot_tpu_torch.coordinator import EmbeddedCoordinator
        from distributedmandelbrot_tpu_torch.core.workload import \
            parse_level_settings
        with tempfile.TemporaryDirectory() as tmp, \
                EmbeddedCoordinator(tmp, parse_level_settings("2:16")) as co:
            live = f"http://127.0.0.1:{co.exporter_port}/metrics"
            text = urllib.request.urlopen(live, timeout=10).read().decode()
    else:
        text = urllib.request.urlopen(url, timeout=10).read().decode()
    families = parse_exposition(text)
    check_invariants(families)
    # A coordinator exporter always carries the scheduler gauges.
    if url is None:
        assert "coord_frontier_depth" in families, sorted(families)
        assert families["coord_frontier_depth"]["samples"][0][2] == 4.0
    print(f"live: {len(families)} families OK")


# -- --names: instrumentation-site name audit ------------------------------

def _unsuppressed(project, findings, rule: str) -> list:
    """The rule's findings that no ``# dmtpu: ignore[...]`` covers, as
    ``dmtpu check`` reports them."""
    return [f for f in findings if f.rule == rule
            and not project.file(f.path).is_suppressed(f.line, f.rule)]


def check_names() -> int:
    """Cross-check every metric-name string literal at an instrumentation
    site (``counters.inc("...")``, ``registry.observe("...")``, ...)
    against the canonical registry in obs/names.py.  A literal that is
    not a registered name is exactly how the results_accepted collision
    happened — two spellings, no arbiter.

    The scan itself now lives in ``dmtpu check`` as the ``obs-name``
    rule family; this flag delegates there so the two paths can never
    disagree about what counts as an instrumentation site."""
    from distributedmandelbrot_tpu_torch import analysis
    from distributedmandelbrot_tpu_torch.analysis import rules_obs
    project = analysis.Project.from_root(REPO)
    known = rules_obs.known_names(project)
    if known is None:
        raise MetricsFormatError(
            "obs/names.py not found — cannot audit metric names")
    sites = sum(1 for _ in rules_obs.iter_sites(project))
    unknown = _unsuppressed(project, rules_obs.check(project), "obs-name")
    for f in unknown:
        print(f"{f.path}:{f.line}: {f.message}", file=sys.stderr)
    if unknown:
        raise MetricsFormatError(
            f"{len(unknown)} unregistered metric-name literal(s)")
    print(f"names: {sites} instrumentation literals OK "
          f"against {len(known)} registered names")
    return sites


def check_dead() -> int:
    """The reverse audit (``obs-dead`` in ``dmtpu check``): every name
    obs/names.py registers must be instrumented or referenced somewhere,
    or the registry is describing telemetry the fleet no longer emits."""
    from distributedmandelbrot_tpu_torch import analysis
    from distributedmandelbrot_tpu_torch.analysis import rules_obs
    project = analysis.Project.from_root(REPO)
    consts = rules_obs.registered_consts(project)
    if consts is None:
        raise MetricsFormatError(
            "obs/names.py not found — cannot audit registered names")
    dead = _unsuppressed(project, rules_obs.check(project), "obs-dead")
    for f in dead:
        print(f"{f.path}:{f.line}: {f.message}", file=sys.stderr)
    if dead:
        raise MetricsFormatError(
            f"{len(dead)} registered-but-uninstrumented name(s)")
    print(f"dead: {len(consts)} registered names all instrumented "
          f"or referenced")
    return len(consts)


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Render and validate Prometheus exposition text.")
    parser.add_argument("--offline", action="store_true",
                        help="skip the live embedded-coordinator fetch")
    parser.add_argument("--url", default=None,
                        help="validate a running exporter's /metrics "
                             "instead of spinning up an embedded one")
    parser.add_argument("--names", action="store_true",
                        help="also audit metric-name literals at "
                             "instrumentation sites against obs/names.py")
    parser.add_argument("--dead", action="store_true",
                        help="also audit obs/names.py registrations for "
                             "names nothing instruments any more")
    args = parser.parse_args()
    check_rendered()
    if args.names:
        check_names()
    if args.dead:
        check_dead()
    if not args.offline:
        check_live(args.url)
    print("check_metrics: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
