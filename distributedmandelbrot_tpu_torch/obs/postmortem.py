"""Cross-process postmortem: merge flight dumps into one causal timeline.

A chaos run (or a real incident) leaves a directory of per-process
flight-recorder dumps (obs/flight.py): one JSONL file per shard /
coordinator / worker, each a header plus the last-N state transitions
that process saw before it died (or before its latest autoflush — the
SIGKILL case).  This module is the assembler behind ``dmtpu postmortem``:

- **Loading is corruption-tolerant.**  Dumps from killed processes are
  routinely truncated mid-line; fuzzing adds garbage, oversized and
  mixed-version files.  Every unparseable line is *counted*, never
  raised on — a partial timeline always renders.
- **Clock alignment reuses the PR 5 span offsets.**  Every dump header
  anchors a (wall, mono) pair sampled together, so any event places on
  the wall clock; coordinator dumps additionally carry their SpanStore's
  per-worker NTP-midpoint offsets, and a worker dump whose ``worker_id``
  appears there is placed on that coordinator's clock instead
  (``align: "spans"``, with the estimator's half-RTT error bound).
  Shard-to-shard ordering rests on the shared wall clock (same host in
  the chaos farm; cross-host deployments inherit NTP skew — see the
  README caveats).
- **Anomaly detectors** walk the merged timeline: grants still in
  flight at a process's death (and their later re-grants by the
  restarted/surviving shard), lease ping-pong, redirect loops,
  double-commit evidence, retry storms.

The chaos runner attaches :meth:`Postmortem.summary` to failed scenario
reports; the CLI renders text, ``--json``, or ``--chrome`` (Perfetto).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.flight import DUMP_KIND, DUMP_VERSION

Key = tuple[int, int, int]

# A single dump line past this is hostile or corrupt, not data: skip it
# without handing it to the JSON parser (fuzz guard — json.loads on a
# multi-megabyte garbage line is where the time goes).
MAX_LINE_BYTES = 1 << 20

# Detector thresholds.  Deliberately conservative: postmortems attach to
# failure reports, and a noisy detector teaches operators to ignore it.
PING_PONG_GRANTS = 3
REDIRECT_LOOP_COUNT = 3
RETRY_STORM_COUNT = 5
RETRY_STORM_WINDOW_S = 10.0

# Events that settle an open grant for a (process, key) — the complement
# defines "in flight at time of death".
_SETTLING = (obs_events.SCHED_ACCEPT, obs_events.SCHED_EXPIRE,
             obs_events.SCHED_REQUEUE, obs_events.SCHED_RELEASE,
             obs_events.SCHED_REOPEN)


@dataclass
class ProcessDump:
    """One process's parsed dump: header, events (dump order), and the
    count of lines that failed to parse."""
    path: str
    header: dict
    events: list[dict]
    errors: int = 0

    @property
    def proc(self) -> str:
        return (f"{self.header.get('role', 'unknown')}"
                f"@{self.header.get('pid', 0)}")

    @property
    def role(self) -> str:
        return str(self.header.get("role", "unknown"))


def _parse_line(line: str) -> Optional[dict]:
    try:
        doc = json.loads(line)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def load_dump(path: str) -> ProcessDump:
    """Parse one dump file, swallowing corruption line by line.

    The header is whichever line first claims ``kind == dmtpu-flight``
    (normally line 1; garbage prefixes just count as errors).  A file
    with no header still yields its parseable events — they merge at
    raw monotonic timestamps, which is wrong in absolute terms but
    preserves the process's own ordering.  A version mismatch counts as
    one error and parsing continues best-effort.
    """
    header: dict = {}
    events: list[dict] = []
    errors = 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if len(line) > MAX_LINE_BYTES:
                    errors += 1
                    continue
                doc = _parse_line(line)
                if doc is None:
                    errors += 1
                    continue
                if doc.get("kind") == DUMP_KIND:
                    if not header:
                        header = doc
                        if doc.get("v") != DUMP_VERSION:
                            errors += 1
                    continue
                if isinstance(doc.get("name"), str) \
                        and isinstance(doc.get("t"), (int, float)):
                    events.append(doc)
                else:
                    errors += 1
    except OSError:
        errors += 1
    return ProcessDump(path=path, header=header, events=events,
                       errors=errors)


def load_dir(dump_dir: str) -> tuple[list[ProcessDump], int]:
    """Every ``*.jsonl`` under ``dump_dir`` (non-recursive), plus the
    count of files that were entirely unreadable/empty of events."""
    dumps: list[ProcessDump] = []
    file_errors = 0
    try:
        names = sorted(os.listdir(dump_dir))
    except OSError:
        return [], 1
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        dump = load_dump(os.path.join(dump_dir, name))
        if not dump.header and not dump.events:
            file_errors += 1
            continue
        dumps.append(dump)
    return dumps, file_errors


# -- alignment -------------------------------------------------------------


def _best_offset(dumps: list[ProcessDump],
                 worker_id: str) -> Optional[tuple[ProcessDump, dict]]:
    """The coordinator dump holding the tightest (min half-RTT error)
    span offset for ``worker_id``."""
    best: Optional[tuple[ProcessDump, dict]] = None
    for dump in dumps:
        offsets = dump.header.get("offsets")
        if not isinstance(offsets, dict):
            continue
        est = offsets.get(worker_id)
        if not isinstance(est, dict) \
                or not isinstance(est.get("offset"), (int, float)):
            continue
        err = est.get("error")
        err = err if isinstance(err, (int, float)) else float("inf")
        if best is None or err < best[1].get("error", float("inf")):
            best = (dump, {"offset": float(est["offset"]),
                           "error": float(err)})
    return best


def _aligner(dump: ProcessDump, dumps: list[ProcessDump]):
    """(mono -> wall) placement function for one dump's events, plus the
    alignment mode and error bound it carries."""
    wall0 = dump.header.get("wall0")
    mono0 = dump.header.get("mono0")
    worker_id = dump.header.get("worker_id")
    if isinstance(worker_id, str):
        best = _best_offset(dumps, worker_id)
        if best is not None:
            coord, est = best
            c_wall0 = coord.header.get("wall0")
            c_mono0 = coord.header.get("mono0")
            if isinstance(c_wall0, (int, float)) \
                    and isinstance(c_mono0, (int, float)):
                offset = est["offset"]

                def align_spans(t: float) -> float:
                    return c_wall0 + (t + offset - c_mono0)

                return align_spans, "spans", est["error"]
    if isinstance(wall0, (int, float)) and isinstance(mono0, (int, float)):

        def align_wall(t: float) -> float:
            return wall0 + (t - mono0)

        return align_wall, "wall", None
    return (lambda t: t), "none", None


# -- assembly --------------------------------------------------------------


@dataclass
class Postmortem:
    dumps: list[ProcessDump]
    file_errors: int = 0
    timeline: list[dict] = field(default_factory=list)
    in_flight: dict = field(default_factory=dict)
    anomalies: list[dict] = field(default_factory=list)

    @property
    def line_errors(self) -> int:
        return sum(d.errors for d in self.dumps)

    @property
    def errors(self) -> int:
        return self.file_errors + self.line_errors

    # -- outputs ------------------------------------------------------

    def summary(self) -> dict:
        """Compact dict for chaos reports: who dumped, what was in
        flight at death, what the detectors flagged."""
        return {
            "processes": [
                {"proc": d.proc, "path": os.path.basename(d.path),
                 "reason": d.header.get("reason"),
                 "events": len(d.events), "errors": d.errors,
                 "shard": d.header.get("shard")}
                for d in self.dumps],
            "events": len(self.timeline),
            "errors": self.errors,
            "in_flight": {proc: [{"key": list(e["key"]),
                                  "t": round(e["t"], 6)}
                                 for e in entries]
                          for proc, entries in self.in_flight.items()},
            "anomalies": self.anomalies,
        }

    def to_dict(self) -> dict:
        doc = self.summary()
        doc["timeline"] = [
            {**e, "key": list(e["key"]) if e.get("key") else None}
            for e in self.timeline]
        return doc

    def render_text(self, limit: Optional[int] = None) -> str:
        lines: list[str] = []
        for d in self.dumps:
            lines.append(
                f"# {d.proc}: {len(d.events)} events, "
                f"{d.errors} bad lines, reason="
                f"{d.header.get('reason', '?')} "
                f"({os.path.basename(d.path)})")
        if self.file_errors:
            lines.append(f"# {self.file_errors} unreadable dump file(s)")
        events = self.timeline
        t0 = events[0]["t"] if events else 0.0
        shown = events if limit is None else events[-limit:]
        if len(shown) < len(events):
            lines.append(f"# ... {len(events) - len(shown)} earlier "
                         f"events elided (--limit)")
        for e in shown:
            parts = [f"+{e['t'] - t0:9.3f}s", f"{e['proc']:<16}",
                     e["name"]]
            if e.get("key") is not None:
                parts.append("key=" + "/".join(str(k) for k in e["key"]))
            if e.get("lease") is not None:
                parts.append(f"lease={e['lease']}")
            if e.get("kv"):
                parts.append(" ".join(f"{k}={v}"
                                      for k, v in sorted(e["kv"].items())))
            if e.get("align") == "spans":
                parts.append(f"(±{e['align_error_s']:.3f}s)")
            lines.append(" ".join(parts))
        for proc, entries in sorted(self.in_flight.items()):
            keys = ", ".join("/".join(str(k) for k in e["key"])
                             for e in entries)
            lines.append(f"IN-FLIGHT at death of {proc}: {keys}")
        for a in self.anomalies:
            lines.append(f"ANOMALY [{a['type']}] {a['detail']}")
        return "\n".join(lines)

    def to_chrome(self) -> dict:
        """Instant events per process, Perfetto-loadable (timestamps
        relative to the first merged event, microseconds)."""
        events: list[dict] = []
        pids: dict[str, int] = {}
        t0 = self.timeline[0]["t"] if self.timeline else 0.0
        for e in self.timeline:
            pid = pids.get(e["proc"])
            if pid is None:
                pid = len(pids)
                pids[e["proc"]] = pid
                events.append({"name": "process_name", "ph": "M",
                               "pid": pid, "tid": 0,
                               "args": {"name": e["proc"]}})
            args = dict(e.get("kv") or {})
            if e.get("key") is not None:
                args["key"] = "/".join(str(k) for k in e["key"])
            if e.get("lease") is not None:
                args["lease"] = e["lease"]
            args["align"] = e["align"]
            events.append({"name": e["name"], "ph": "i", "s": "p",
                           "ts": round((e["t"] - t0) * 1e6, 3),
                           "pid": pid, "tid": 0, "cat": e["cat"],
                           "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def tile_history(self, key: Key) -> list[dict]:
        return [e for e in self.timeline if e.get("key") == tuple(key)]


def _merge_timeline(dumps: list[ProcessDump]) -> list[dict]:
    merged: list[dict] = []
    for dump in dumps:
        align, mode, err = _aligner(dump, dumps)
        for e in dump.events:
            key = e.get("key")
            if isinstance(key, list) and len(key) == 3:
                try:
                    key = tuple(int(k) for k in key)
                except (TypeError, ValueError):
                    key = None
            else:
                key = None
            entry = {
                "t": align(float(e["t"])),
                "proc": dump.proc, "role": dump.role,
                "seq": e.get("seq", 0),
                "cat": e.get("cat", str(e["name"]).partition(".")[0]),
                "name": e["name"], "key": key,
                "lease": e.get("lease"), "kv": e.get("kv") or {},
                "align": mode,
            }
            if err is not None:
                entry["align_error_s"] = round(err, 6)
            merged.append(entry)
    merged.sort(key=lambda e: (e["t"], e["proc"], e["seq"]))
    return merged


def _find_in_flight(dumps: list[ProcessDump],
                    timeline: list[dict]) -> dict:
    """Per process: grants with no settling event by the end of that
    process's dump — the leases in flight when it died (or when its
    last autoflush ran)."""
    by_proc: dict[str, dict[Key, dict]] = {}
    for e in timeline:
        if e["key"] is None:
            continue
        open_grants = by_proc.setdefault(e["proc"], {})
        if e["name"] == obs_events.SCHED_GRANT:
            open_grants[e["key"]] = e
        elif e["name"] in _SETTLING:
            open_grants.pop(e["key"], None)
    return {proc: sorted(grants.values(), key=lambda e: e["t"])
            for proc, grants in by_proc.items() if grants}


def _detect_anomalies(timeline: list[dict], in_flight: dict) -> list[dict]:
    anomalies: list[dict] = []

    # grant-without-accept: an in-flight lease at a process's death,
    # annotated with its re-grant (by whoever owned the key next) when
    # the merged timeline shows one — the chaos coord-kill signature.
    for proc, entries in sorted(in_flight.items()):
        for e in entries:
            regrant = next(
                (r for r in timeline
                 if r["name"] == obs_events.SCHED_GRANT
                 and r["key"] == e["key"] and r["t"] > e["t"]
                 and (r["proc"] != proc or r["seq"] > e["seq"])),
                None)
            detail = (f"{proc} granted "
                      f"{'/'.join(str(k) for k in e['key'])} at its end "
                      f"of record with no accept")
            doc = {"type": "grant-without-accept", "key": list(e["key"]),
                   "proc": proc, "t": round(e["t"], 6), "detail": detail}
            if regrant is not None:
                doc["regranted_by"] = regrant["proc"]
                doc["t_regrant"] = round(regrant["t"], 6)
                doc["detail"] += (f"; re-granted by {regrant['proc']} "
                                  f"{regrant['t'] - e['t']:.3f}s later")
            anomalies.append(doc)

    by_key: dict[Key, list[dict]] = {}
    for e in timeline:
        if e["key"] is not None:
            by_key.setdefault(e["key"], []).append(e)

    for key, events in sorted(by_key.items()):
        names = [e["name"] for e in events]
        grants = names.count(obs_events.SCHED_GRANT)
        expiries = (names.count(obs_events.SCHED_EXPIRE)
                    + names.count(obs_events.SCHED_REQUEUE))
        if grants >= PING_PONG_GRANTS and expiries >= grants - 1:
            anomalies.append({
                "type": "lease-ping-pong", "key": list(key),
                "grants": grants, "expiries": expiries,
                "detail": f"{'/'.join(str(k) for k in key)} granted "
                          f"{grants}x with {expiries} expiries between "
                          f"— lease timeout likely below service time"})
        redirects = names.count(obs_events.SESS_REDIRECT)
        if redirects >= REDIRECT_LOOP_COUNT:
            anomalies.append({
                "type": "redirect-loop", "key": list(key),
                "redirects": redirects,
                "detail": f"{'/'.join(str(k) for k in key)} redirected "
                          f"{redirects}x — stale ring table in some "
                          f"client"})
        accepts = [e for e in events
                   if e["name"] == obs_events.SCHED_ACCEPT]
        procs = {e["proc"] for e in accepts}
        leases = {e["lease"] for e in accepts if e["lease"] is not None}
        if len(procs) > 1 or len(leases) > 1:
            anomalies.append({
                "type": "double-commit", "key": list(key),
                "procs": sorted(procs),
                "detail": f"{'/'.join(str(k) for k in key)} accepted "
                          f"{len(accepts)}x across {sorted(procs)} — "
                          f"check index dedup held"})
        retries = [e for e in events
                   if e["name"] in (obs_events.SESS_RESULT_REJECTED,
                                    obs_events.SCHED_REQUEUE)]
        for i in range(len(retries) - RETRY_STORM_COUNT + 1):
            window = retries[i + RETRY_STORM_COUNT - 1]["t"] - \
                retries[i]["t"]
            if window <= RETRY_STORM_WINDOW_S:
                anomalies.append({
                    "type": "retry-storm", "key": list(key),
                    "count": RETRY_STORM_COUNT,
                    "window_s": round(window, 3),
                    "detail": f"{'/'.join(str(k) for k in key)}: "
                              f"{RETRY_STORM_COUNT} rejects/requeues in "
                              f"{window:.1f}s"})
                break
    return anomalies


def assemble(dump_dir: str, *, registry=None) -> Postmortem:
    """Load every dump under ``dump_dir`` and build the merged,
    clock-aligned timeline plus the anomaly report.  Never raises on
    dump content; an empty/missing directory yields an empty (but
    renderable) postmortem.  ``registry`` (optional) receives the
    ``postmortem_*`` load accounting."""
    dumps, file_errors = load_dir(dump_dir)
    pm = Postmortem(dumps=dumps, file_errors=file_errors)
    pm.timeline = _merge_timeline(dumps)
    pm.in_flight = _find_in_flight(dumps, pm.timeline)
    pm.anomalies = _detect_anomalies(pm.timeline, pm.in_flight)
    if registry is not None:
        registry.inc(obs_names.POSTMORTEM_DUMPS_LOADED, len(dumps))
        registry.inc(obs_names.POSTMORTEM_DUMP_ERRORS, pm.errors)
        registry.inc(obs_names.POSTMORTEM_ANOMALIES, len(pm.anomalies))
    return pm
