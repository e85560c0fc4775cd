"""`dmtpu top`: ANSI fleet dashboard over /fleet snapshots.

Curses-free on purpose: the renderer is a pure function from a fleet
snapshot (obs/fleet.py) to a string, so it runs identically in the live
loop (clear screen + reprint every interval), in ``--once`` mode for CI
pipelines, and in tests (assert on substrings, no pty needed).  Color
is plain SGR codes behind a flag; ``--no-color`` / non-tty output stays
grep-able.
"""

from __future__ import annotations

from typing import Optional

_RESET = "\x1b[0m"
_BOLD = "\x1b[1m"
_RED = "\x1b[31m"
_GREEN = "\x1b[32m"
_YELLOW = "\x1b[33m"
_DIM = "\x1b[2m"

CLEAR_SCREEN = "\x1b[H\x1b[2J"


def _paint(text: str, code: str, color: bool) -> str:
    return f"{code}{text}{_RESET}" if color else text


def _state_paint(state: str, color: bool) -> str:
    code = {"ok": _GREEN, "hold": _YELLOW, "firing": _RED}.get(state,
                                                               _YELLOW)
    return _paint(state, code, color)


def _num(v, nd: int = 1, unit: str = "") -> str:
    if v is None:
        return "-"
    try:
        return f"{float(v):.{nd}f}{unit}"
    except (TypeError, ValueError):
        return "-"


def _ms(v) -> str:
    if v is None:
        return "-"
    try:
        return f"{float(v) * 1e3:.1f}"
    except (TypeError, ValueError):
        return "-"


def _short_url(url: str) -> str:
    return url.replace("http://", "").replace("https://", "")


def render_top(snap: dict, *, color: bool = True) -> str:
    """One full dashboard frame from a /fleet snapshot."""
    lines: list[str] = []
    peers = snap.get("peers") or []
    totals = snap.get("totals") or {}
    healthy = sum(1 for p in peers if p.get("healthy"))
    stale = sum(1 for p in peers if p.get("stale"))
    head = (f"dmtpu top · {len(peers)} peers "
            f"({healthy} healthy, {stale} stale) · "
            f"{_num(totals.get('mpix_per_s'))} Mpix/s · "
            f"{_num(totals.get('grants_per_s'))} grants/s · "
            f"{_num(totals.get('queries_per_s'))} q/s · "
            f"{totals.get('completed', 0)}/{totals.get('total_tiles', 0)}"
            f" tiles")
    lines.append(_paint(head, _BOLD, color))

    roles = snap.get("roles") or {}
    if roles:
        parts = [f"{name}={doc.get('healthy', 0)}/{doc.get('count', 0)}"
                 for name, doc in sorted(roles.items())]
        lines.append(_paint("roles  " + "  ".join(parts), _DIM, color))

    slo = snap.get("slo") or {}
    slos = slo.get("slos") or []
    if slos:
        lines.append("")
        lines.append(_paint(
            f"{'SLO':<28} {'state':<8} {'fast burn':>10} "
            f"{'slow burn':>10} {'objective':>10}", _BOLD, color))
        for entry in slos:
            state = str(entry.get("state", "?"))
            lines.append(
                f"{str(entry.get('name', '?')):<28} "
                f"{_state_paint(f'{state:<8}', color)} "
                f"{_num(entry.get('fast_burn'), 2):>10} "
                f"{_num(entry.get('slow_burn'), 2):>10} "
                f"{_num(entry.get('objective'), 3):>10}")

    shards = snap.get("shards") or []
    if shards:
        lines.append("")
        lines.append(_paint(
            f"{'SHARD':<6} {'endpoint':<24} {'grants/s':>9} "
            f"{'tiles/s':>8} {'frontier':>9} {'leases':>7} {'queue':>6} "
            f"{'done/total':>12} {'wkrs':>5}", _BOLD, color))
        for row in shards:
            shard_id = row.get("shard")
            lines.append(
                f"{('-' if shard_id is None else str(shard_id)):<6} "
                f"{_short_url(str(row.get('url', ''))):<24} "
                f"{_num(row.get('grants_per_s')):>9} "
                f"{_num(row.get('tiles_per_s'), 2):>8} "
                f"{_num(row.get('frontier_depth'), 0):>9} "
                f"{_num(row.get('outstanding_leases'), 0):>7} "
                f"{_num(row.get('persist_queue_depth'), 0):>6} "
                f"{str(row.get('completed', 0)) + '/' + str(row.get('total', 0)):>12} "
                f"{row.get('workers', 0):>5}")

    gateways = snap.get("gateways") or []
    if gateways:
        lines.append("")
        lines.append(_paint(
            f"{'GATEWAY':<24} {'q/s':>8} {'served/s':>9} "
            f"{'p50 ms':>8} {'p99 ms':>8} {'t1 hit':>7} {'rnd hit':>8} "
            f"{'sess':>5}", _BOLD, color))
        for row in gateways:
            lines.append(
                f"{_short_url(str(row.get('url', ''))):<24} "
                f"{_num(row.get('queries_per_s')):>8} "
                f"{_num(row.get('served_per_s')):>9} "
                f"{_ms(row.get('p50_s')):>8} "
                f"{_ms(row.get('p99_s')):>8} "
                f"{_num(row.get('tier1_hit_ratio'), 2):>7} "
                f"{_num(row.get('render_hit_ratio'), 2):>8} "
                f"{_num(row.get('sessions_active'), 0):>5}")

    workers = snap.get("workers") or []
    if workers:
        lines.append("")
        lines.append(_paint(
            f"{'WORKER':<18} {'tiles':>6} {'tiles/s':>8} "
            f"{'s/tile':>8} {'lease→persist':>14} {'straggler':>10}",
            _BOLD, color))
        for row in workers:
            if row.get("straggler"):
                flag = _paint(
                    "YES " + ",".join(row.get("straggler_reasons") or []),
                    _RED, color)
            else:
                flag = _paint("-", _DIM, color)
            lines.append(
                f"{str(row.get('worker', '?')):<18} "
                f"{row.get('tiles', 0):>6} "
                f"{_num(row.get('tiles_per_s'), 2):>8} "
                f"{_num(row.get('compute_s_per_tile'), 3):>8} "
                f"{_num(row.get('lease_to_persist_s_per_tile'), 3):>14} "
                f"{flag:>10}")

    bad_peers = [p for p in peers if p.get("stale") or not
                 p.get("healthy")]
    if bad_peers:
        lines.append("")
        lines.append(_paint("UNHEALTHY PEERS", _BOLD, color))
        for p in bad_peers:
            detail = p.get("last_error") or "no successful scrape yet"
            lines.append(_paint(
                f" {_short_url(str(p.get('url', '')))} "
                f"[{p.get('role', '?')}] errors={p.get('errors', 0)} "
                f"{detail}", _RED, color))

    return "\n".join(lines) + "\n"


def render_frame(snap: dict, *, color: bool = True,
                 clear: bool = False) -> str:
    """A live-loop frame: optional clear-screen prefix + the dashboard."""
    prefix = CLEAR_SCREEN if clear else ""
    return prefix + render_top(snap, color=color)
