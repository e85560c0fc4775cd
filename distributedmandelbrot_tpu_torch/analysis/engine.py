"""Checker engine for ``dmtpu check``: files, findings, suppressions, baseline.

The analysis package is a project-native static analyzer over the farm's
own invariants (lock discipline, async hygiene, wire-format parity, the
kernel-launch wrappers' asynchrony) — the conventions the reference
system enforced by hand and paid for when a copy drifted
(``DataChunk.cs:14-15`` duplicated into worker and viewer).  Everything
here is stdlib ``ast``: the engine MUST run without importing torch (or
the package under analysis) so the gate test stays a cheap subprocess.

Pieces:

- :class:`Rule` / :class:`Finding` — rule catalogue entries and located
  diagnostics; a finding's :meth:`~Finding.fingerprint` omits the line
  number so baselines survive unrelated edits above a finding.
- :class:`SourceFile` / :class:`Project` — parsed sources keyed by
  repo-relative posix path.  ``Project.from_root`` scans the installed
  package; ``Project.from_sources`` builds fixture projects for tests.
- inline suppressions — ``# dmtpu: ignore[rule-id]`` (comma-separated
  ids, ``*`` for all) on the finding's line or the line above.
- baseline — a committed JSON list of fingerprints for grandfathered
  findings (``distributedmandelbrot_tpu_torch/tools/lint_baseline.json``);
  entries matching nothing are reported stale so the file can only
  shrink.
- reporters — one-line-per-finding text, and a versioned JSON document
  for tooling.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Optional, Sequence

PACKAGE = "distributedmandelbrot_tpu_torch"

SUPPRESS_RE = re.compile(r"#\s*dmtpu:\s*ignore\[([A-Za-z0-9_\-*, ]+)\]")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Rule:
    """One checkable invariant: stable id, family, severity, one-line doc."""

    id: str
    family: str
    severity: str
    doc: str


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str  # repo-relative posix path
    line: int
    message: str

    def fingerprint(self) -> str:
        """Line-independent identity for baseline matching."""
        return f"{self.rule}::{self.path}::{self.message}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")


# The engine's own diagnostic for files it cannot parse — reported as a
# finding (not raised) so one broken file doesn't hide the rest.
PARSE_ERROR = Rule("parse-error", "engine", "error",
                   "file does not parse as Python")


class SourceFile:
    """One parsed source: text, AST, and per-line suppression comments."""

    def __init__(self, relpath: str, text: str) -> None:
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=relpath)  # may raise SyntaxError
        self.suppressions: dict[int, set[str]] = {}
        for lineno, line in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions[lineno] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()}

    def is_suppressed(self, line: int, rule: str) -> bool:
        """A ``# dmtpu: ignore[...]`` on the finding's line or the line
        directly above covers it (the line above carries the one-line
        justification when the flagged line is already full)."""
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and (rule in ids or "*" in ids):
                return True
        return False


class Project:
    """The file set one check run sees, keyed by repo-relative path."""

    def __init__(self, files: Mapping[str, SourceFile],
                 parse_failures: Optional[Mapping[str, str]] = None) -> None:
        self.files = dict(files)
        self.parse_failures = dict(parse_failures or {})

    @classmethod
    def from_sources(cls, sources: Mapping[str, str]) -> "Project":
        """Fixture constructor (tests): ``{relpath: source_text}``."""
        files: dict[str, SourceFile] = {}
        failures: dict[str, str] = {}
        for rel, text in sources.items():
            try:
                files[rel] = SourceFile(rel, text)
            except SyntaxError as e:
                failures[rel] = f"line {e.lineno}: {e.msg}"
        return cls(files, failures)

    @classmethod
    def from_root(cls, root: Path | str) -> "Project":
        """Every ``*.py`` under ``root/distributedmandelbrot_tpu_torch/``."""
        root = Path(root)
        files: dict[str, SourceFile] = {}
        failures: dict[str, str] = {}
        pkg = root / PACKAGE
        for path in sorted(pkg.rglob("*.py")):
            rel = path.relative_to(root).as_posix()
            try:
                text = path.read_text(encoding="utf-8")
            except (OSError, UnicodeDecodeError) as e:
                failures[rel] = str(e)
                continue
            try:
                files[rel] = SourceFile(rel, text)
            except SyntaxError as e:
                failures[rel] = f"line {e.lineno}: {e.msg}"
        return cls(files, failures)

    def in_dirs(self, *subdirs: str) -> Iterator[SourceFile]:
        """Files under ``PACKAGE/<subdir>/`` for any named subdir."""
        prefixes = tuple(f"{PACKAGE}/{d.strip('/')}/" for d in subdirs)
        for rel in sorted(self.files):
            if rel.startswith(prefixes):
                yield self.files[rel]

    def file(self, relpath: str) -> Optional[SourceFile]:
        return self.files.get(relpath)


def default_root() -> Path:
    """The directory containing the installed package (the repo root when
    running from a checkout)."""
    return Path(__file__).resolve().parent.parent.parent


def project_at_ref(root: Path | str, ref: str) -> Project:
    """The package's file set as of a git ref, via ``git archive`` (one
    subprocess, parsed in memory — the worktree is never touched).  The
    whole tree is materialized, not just changed files, because the
    cross-file rules (wire parity, proto frames, the call graph) need
    the full old project to compute the old fingerprints faithfully."""
    import io
    import subprocess
    import tarfile
    try:
        proc = subprocess.run(["git", "archive", ref, "--", PACKAGE],
                              cwd=str(root), capture_output=True)
    except OSError as e:
        raise ValueError(f"cannot run git: {e}")
    if proc.returncode != 0:
        err = proc.stderr.decode("utf-8", "replace").strip()
        raise ValueError(f"git archive {ref} failed: {err}")
    sources: dict[str, str] = {}
    with tarfile.open(fileobj=io.BytesIO(proc.stdout)) as tf:
        for member in tf.getmembers():
            if member.isfile() and member.name.endswith(".py"):
                fobj = tf.extractfile(member)
                if fobj is not None:
                    sources[member.name] = fobj.read().decode(
                        "utf-8", "replace")
    return Project.from_sources(sources)


def fingerprints_at_ref(root: Path | str, ref: str,
                        rule_ids: Optional[Sequence[str]] = None
                        ) -> set[str]:
    """Fingerprints of every finding the given rules produce on the tree
    as of ``ref`` — ``--diff`` treats these as an ephemeral baseline so
    a check run only reports findings introduced since the ref."""
    return {f.fingerprint()
            for f in check_project(project_at_ref(root, ref), rule_ids)}


# -- rule registry ---------------------------------------------------------

def _rule_modules():
    # Imported lazily: rule modules import this module for Rule/Finding.
    from distributedmandelbrot_tpu_torch.analysis import (rules_async,
                                                          rules_exc,
                                                          rules_fsm,
                                                          rules_locks,
                                                          rules_obs,
                                                          rules_proto,
                                                          rules_res,
                                                          rules_taint,
                                                          rules_torch,
                                                          rules_wire)
    return (rules_locks, rules_async, rules_wire, rules_torch, rules_proto,
            rules_res, rules_obs, rules_taint, rules_exc, rules_fsm)


def all_rules() -> dict[str, Rule]:
    rules = {PARSE_ERROR.id: PARSE_ERROR}
    for mod in _rule_modules():
        for rule in mod.RULES:
            rules[rule.id] = rule
    return rules


def expand_rule_ids(rule_ids: Sequence[str]) -> list[str]:
    """Resolve a mix of rule ids and family names (``--rules proto res``)
    to concrete rule ids; raises ValueError on anything unknown."""
    known = all_rules()
    by_family: dict[str, list[str]] = {}
    for rule in known.values():
        by_family.setdefault(rule.family, []).append(rule.id)
    expanded: list[str] = []
    unknown: list[str] = []
    for rid in rule_ids:
        if rid in known:
            expanded.append(rid)
        elif rid in by_family:
            expanded.extend(by_family[rid])
        else:
            unknown.append(rid)
    if unknown:
        raise ValueError(
            f"unknown rule ids: {', '.join(sorted(set(unknown)))} "
            f"(known ids: {', '.join(sorted(known))}; "
            f"families: {', '.join(sorted(by_family))})")
    return expanded


def check_project(project: Project,
                  rule_ids: Optional[Sequence[str]] = None,
                  timings: Optional[dict] = None) -> list[Finding]:
    """Run every rule family; returns ALL findings (suppression and
    baseline filtering is :func:`run_check`'s job).  ``rule_ids`` may mix
    rule ids and family names.  When ``timings`` is given, per-family
    wall seconds are recorded into it keyed by module basename (the
    ``--profile`` feed: as families grow, the tier-1 gate's time budget
    stays attributable to the family that spent it)."""
    import time
    findings = [Finding(PARSE_ERROR.id, PARSE_ERROR.severity, rel, 1, msg)
                for rel, msg in sorted(project.parse_failures.items())]
    wanted = set(expand_rule_ids(rule_ids)) if rule_ids else None
    for mod in _rule_modules():
        t0 = time.perf_counter()
        findings.extend(mod.check(project))
        if timings is not None:
            name = mod.__name__.rsplit(".", 1)[-1]
            timings[name] = timings.get(name, 0.0) \
                + (time.perf_counter() - t0)
    if wanted is not None:
        findings = [f for f in findings if f.rule in wanted]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# -- run + filtering -------------------------------------------------------

@dataclass
class Report:
    """One check run, split by disposition."""

    findings: list[Finding]   # actionable: neither suppressed nor baselined
    suppressed: list[Finding]
    baselined: list[Finding]
    stale_baseline: list[str]  # baseline entries matching nothing anymore

    @property
    def clean(self) -> bool:
        return not self.findings


def run_check(project: Project,
              rule_ids: Optional[Sequence[str]] = None,
              baseline: Optional[Iterable[str]] = None,
              timings: Optional[dict] = None) -> Report:
    all_findings = check_project(project, rule_ids, timings=timings)
    base = set(baseline or ())
    actionable: list[Finding] = []
    suppressed: list[Finding] = []
    baselined: list[Finding] = []
    seen_fingerprints: set[str] = set()
    for f in all_findings:
        seen_fingerprints.add(f.fingerprint())
        sf = project.file(f.path)
        if sf is not None and sf.is_suppressed(f.line, f.rule):
            suppressed.append(f)
        elif f.fingerprint() in base:
            baselined.append(f)
        else:
            actionable.append(f)
    stale = sorted(base - seen_fingerprints)
    return Report(actionable, suppressed, baselined, stale)


# -- baseline IO -----------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: Path | str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: not a v{BASELINE_VERSION} baseline file")
    return set(doc.get("findings", []))


def save_baseline(path: Path | str, findings: Iterable[Finding]) -> None:
    doc = {"version": BASELINE_VERSION,
           "findings": sorted({f.fingerprint() for f in findings})}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


# -- reporters -------------------------------------------------------------

def render_text(report: Report) -> str:
    lines = [f.format() for f in report.findings]
    errors = sum(1 for f in report.findings if f.severity == "error")
    warnings = len(report.findings) - errors
    summary = (f"dmtpu check: {errors} error(s), {warnings} warning(s)"
               f" ({len(report.suppressed)} suppressed,"
               f" {len(report.baselined)} baselined)")
    if report.stale_baseline:
        summary += f", {len(report.stale_baseline)} stale baseline entr(y/ies)"
        lines.extend(f"stale baseline entry: {fp}"
                     for fp in report.stale_baseline)
    lines.append(summary)
    return "\n".join(lines)


JSON_VERSION = 1


def render_json(report: Report) -> str:
    """Versioned machine-readable report.  Schema (v1)::

        {"version": 1,
         "counts": {"error": N, "warning": N, "total": N,
                    "suppressed": N, "baselined": N},
         "findings": [{"rule", "severity", "path", "line", "message"}],
         "stale_baseline": [fingerprint, ...]}
    """
    errors = sum(1 for f in report.findings if f.severity == "error")
    doc = {
        "version": JSON_VERSION,
        "counts": {
            "error": errors,
            "warning": len(report.findings) - errors,
            "total": len(report.findings),
            "suppressed": len(report.suppressed),
            "baselined": len(report.baselined),
        },
        "findings": [
            {"rule": f.rule, "severity": f.severity, "path": f.path,
             "line": f.line, "message": f.message}
            for f in report.findings],
        "stale_baseline": list(report.stale_baseline),
    }
    return json.dumps(doc, indent=1, sort_keys=True)
