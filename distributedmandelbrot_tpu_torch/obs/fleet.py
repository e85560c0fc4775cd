"""Fleet aggregation: scrape every exporter, merge by role, serve /fleet.

One process's ``/varz`` answers "how is this shard doing"; nobody runs a
fleet off N browser tabs.  The aggregator is the single pane of glass:

- **discovery** — peers come from an explicit ``--peers`` list
  (``[role@]host:port`` specs), from a ``ring.json`` whose shard entries
  carry ``exporter_port`` (control/ring.py), or both; worker rows
  additionally come from the span-reported per-worker statistics every
  shard already publishes in its ``/varz`` (workers need no exporter of
  their own to be visible, though they may run one);
- **scraping** — plain bounded HTTP GETs of ``/varz`` (and, for
  gateway-bearing peers, ``/timeseries?name=gateway_request_seconds``
  for windowed latency percentiles).  All fetch failures are tolerated:
  the peer is marked stale, ``fleet_scrape_errors`` counts it, and the
  snapshot carries on with the peers that answered.  The fetch function
  is injectable, which is what the fuzz suite drives with malformed /
  truncated / oversized bodies;
- **merging** — per-role aggregates (shard grant throughput, gateway
  latency + cache hit ratios, worker tile rates), fleet totals
  (aggregate Mpix/s = tiles/s x CHUNK_PIXELS), queue depths, worst-case
  SLO burn across peers, and straggler flags (obs/slo.py detector over
  the merged worker rows);
- **serving** — ``snapshot()`` is the ``/fleet`` JSON; attach the
  aggregator to any exporter (``MetricsExporter(fleet=...)``) or run a
  standalone :class:`FleetService` (own thread + loop, the pattern of
  loadgen's replicas) when no coordinator loop is handy.

Rates are computed aggregator-side from its own scrape history
(monotonic counter deltas), so a version-skewed peer that predates
``/timeseries`` still contributes rates — only percentiles degrade.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.metrics import Registry
from distributedmandelbrot_tpu_torch.obs.slo import detect_stragglers
from distributedmandelbrot_tpu_torch.obs.timeseries import family_of

DEFAULT_RATE_WINDOW = 60.0
DEFAULT_SCRAPE_TIMEOUT = 2.0
# A /varz of a busy coordinator is a few tens of KB; 4 MiB is two orders
# of magnitude of headroom, and anything past it is a bug or an attack.
MAX_SCRAPE_BYTES = 4 << 20
# Scrape history per peer: enough for a 1h slow window at 2s scrapes
# would be 1800 entries; 512 bounds memory while covering the rate
# windows the dashboard actually renders.
_HISTORY_CAP = 512

ROLE_SHARD = "shard"
ROLE_COORDINATOR = "coordinator"
ROLE_GATEWAY = "gateway"
ROLE_WORKER = "worker"
ROLE_FLEET = "fleet"


class ScrapeError(Exception):
    """A peer fetch failed or returned something unusable."""


def http_fetch(url: str, timeout: float = DEFAULT_SCRAPE_TIMEOUT,
               max_bytes: int = MAX_SCRAPE_BYTES) -> bytes:
    """Bounded GET; the aggregator's default fetch function."""
    req = urllib.request.Request(url,
                                 headers={"User-Agent": "dmtpu-fleet"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read(max_bytes + 1)
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise ScrapeError(str(e)) from None
    if len(body) > max_bytes:
        raise ScrapeError(f"body exceeds {max_bytes} bytes")
    return body


def parse_peer_spec(spec: str) -> tuple[str, Optional[str]]:
    """``[role@]host:port`` or ``[role@]http://host:port`` ->
    ``(base_url, role_hint)``."""
    role: Optional[str] = None
    if "@" in spec and "://" not in spec.split("@", 1)[0]:
        role, spec = spec.split("@", 1)
        role = role.strip() or None
    if not spec.startswith("http://") and not spec.startswith("https://"):
        spec = "http://" + spec
    return spec.rstrip("/"), role


def _num(value) -> Optional[float]:
    """Tolerant numeric read for version-skewed payloads."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    return float(value)


@dataclass
class PeerState:
    """One scraped exporter; history feeds aggregator-side rates."""

    url: str
    role_hint: Optional[str] = None
    role: str = "unknown"
    varz: Optional[dict] = None
    latency_doc: Optional[dict] = None
    last_ok: Optional[float] = None
    scrapes: int = 0
    consecutive_errors: int = 0
    last_error: Optional[str] = None
    # (ts, counter family sums, histogram family counts, worker rows)
    history: deque = field(default_factory=lambda: deque(
        maxlen=_HISTORY_CAP))

    @property
    def healthy(self) -> bool:
        return self.last_ok is not None and self.consecutive_errors == 0

    @property
    def stale(self) -> bool:
        return self.consecutive_errors >= 2 or self.last_ok is None


def _infer_role(varz: dict) -> str:
    if not isinstance(varz, dict):
        return "unknown"
    role = varz.get("role")
    if isinstance(role, str) and role:
        return role
    if "shard" in varz:
        return ROLE_SHARD
    if "worker_id" in varz:
        return ROLE_WORKER
    if "scheduler" in varz:
        return ROLE_COORDINATOR
    counters = varz.get("counters")
    if isinstance(counters, dict) and any(
            family_of(k) == obs_names.GATEWAY_QUERIES for k in counters):
        return ROLE_GATEWAY
    return "unknown"


class FleetAggregator:
    """Scrapes peers, keeps bounded per-peer history, merges a fleet
    snapshot.  Thread contract: ``scrape_once`` runs on one scraping
    thread at a time (CLI thread, or FleetService's executor), while
    ``snapshot`` may run concurrently on an exporter loop — shared
    state is guarded by one lock, and network fetches NEVER happen
    under it."""

    def __init__(self, peers: Sequence[str] = (), *,
                 registry: Optional[Registry] = None,
                 rate_window: float = DEFAULT_RATE_WINDOW,
                 timeout: float = DEFAULT_SCRAPE_TIMEOUT,
                 fetch: Callable[..., bytes] = http_fetch,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry if registry is not None else Registry()
        self.rate_window = float(rate_window)
        self.timeout = float(timeout)
        self.fetch = fetch
        self.clock = clock
        self._lock = threading.Lock()
        self._peers: dict[str, PeerState] = {}
        for spec in peers:
            self.add_peer(spec)

    def add_peer(self, spec: str) -> None:
        url, role_hint = parse_peer_spec(spec)
        with self._lock:
            if url not in self._peers:
                self._peers[url] = PeerState(url, role_hint,
                                             role=role_hint or "unknown")

    @classmethod
    def from_ring(cls, ring, **kwargs) -> "FleetAggregator":
        """Peers from a HashRing whose shards carry exporter ports;
        shards with no exporter bound (port 0) are skipped."""
        agg = cls(**kwargs)
        for info in ring.shards:
            port = getattr(info, "exporter_port", 0)
            if port:
                agg.add_peer(f"{ROLE_SHARD}@{info.host}:{port}")
        return agg

    @property
    def peer_urls(self) -> list[str]:
        with self._lock:
            return sorted(self._peers)

    # -- scraping ----------------------------------------------------------

    def scrape_once(self) -> None:
        """One scrape round over every peer; never raises for peer
        failures (fleet_scrape_errors counts them instead)."""
        with self._lock:
            peers = list(self._peers.values())
        for peer in peers:
            t0 = time.monotonic()
            self._scrape_peer(peer)
            self.registry.observe(obs_names.HIST_FLEET_SCRAPE_SECONDS,
                                  time.monotonic() - t0)
        with self._lock:
            stale = sum(1 for p in self._peers.values() if p.stale)
        self.registry.set_gauge(obs_names.GAUGE_FLEET_PEERS,
                                len(peers))
        self.registry.set_gauge(obs_names.GAUGE_FLEET_PEERS_STALE, stale)
        self.registry.inc(obs_names.FLEET_SCRAPES)

    def _scrape_peer(self, peer: PeerState) -> None:
        try:
            body = self.fetch(peer.url + "/varz", self.timeout)
            varz = json.loads(body.decode("utf-8", errors="replace"))
            if not isinstance(varz, dict):
                raise ScrapeError(
                    f"/varz is {type(varz).__name__}, not an object")
        except (ScrapeError, UnicodeError, json.JSONDecodeError,
                OSError) as e:
            self.registry.inc(obs_names.FLEET_SCRAPE_ERRORS)
            with self._lock:
                peer.consecutive_errors += 1
                peer.last_error = str(e)[:200]
            return
        role = _infer_role(varz)
        if role == "unknown" and peer.role_hint:
            role = peer.role_hint
        latency_doc = None
        if role == ROLE_GATEWAY or (
                role in (ROLE_COORDINATOR, ROLE_SHARD)
                and obs_names.GATEWAY_QUERIES in _counter_families(varz)):
            # Windowed latency percentiles ride /timeseries — but only
            # for peers actually serving gateway traffic; a pure shard
            # has no request histogram, and fetching would double every
            # scrape's cost for nothing.  Peers that predate
            # /timeseries (version skew) just lose the percentile
            # columns.
            try:
                ts_body = self.fetch(
                    peer.url + "/timeseries?name="
                    + obs_names.HIST_GATEWAY_REQUEST_SECONDS
                    + f"&window={self.rate_window:g}", self.timeout)
                doc = json.loads(ts_body.decode("utf-8",
                                                errors="replace"))
                if isinstance(doc, dict) and "error" not in doc:
                    latency_doc = doc
            except (ScrapeError, UnicodeError, json.JSONDecodeError,
                    OSError):
                pass
        now = self.clock()
        entry = (now, _counter_families(varz), _hist_counts(varz),
                 _worker_rows(varz))
        with self._lock:
            peer.role = role
            peer.varz = varz
            peer.latency_doc = latency_doc
            peer.last_ok = now
            peer.scrapes += 1
            peer.consecutive_errors = 0
            peer.last_error = None
            peer.history.append(entry)

    # -- derived math ------------------------------------------------------

    def _peer_rate(self, peer: PeerState, family: str, *,
                   now: Optional[float] = None) -> float:
        """Counter-family rate from this peer's scrape history (first vs
        last point in the trailing rate window)."""
        if now is None:
            now = self.clock()
        cutoff = now - self.rate_window
        pts = [(ts, fams.get(family)) for ts, fams, _, _ in peer.history
               if ts >= cutoff and family in fams]
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))

    def _hist_rate(self, peer: PeerState, family: str, *,
                   now: Optional[float] = None) -> float:
        if now is None:
            now = self.clock()
        cutoff = now - self.rate_window
        pts = [(ts, hists.get(family)) for ts, _, hists, _ in peer.history
               if ts >= cutoff and family in hists]
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return max(0.0, (v1 - v0) / (t1 - t0))

    def _worker_rates(self, now: float) -> dict[str, float]:
        """Per-worker tiles/s from span-reported cumulative tile counts,
        summed across the shards a multi-homed worker reports to."""
        cutoff = now - self.rate_window
        series: dict[str, list[tuple[float, float]]] = {}
        with self._lock:
            peers = list(self._peers.values())
            histories = {p.url: list(p.history) for p in peers}
        # Merge per scrape-round: entries across peers interleave by ts.
        merged: dict[float, dict[str, float]] = {}
        for url, history in histories.items():
            for ts, _, _, workers in history:
                if ts < cutoff or not workers:
                    continue
                bucket = merged.setdefault(round(ts, 1), {})
                for wid, row in workers.items():
                    tiles = _num(row.get("tiles"))
                    if tiles is not None:
                        bucket[wid] = bucket.get(wid, 0.0) + tiles
        for ts in sorted(merged):
            for wid, tiles in merged[ts].items():
                series.setdefault(wid, []).append((ts, tiles))
        rates: dict[str, float] = {}
        for wid, pts in series.items():
            if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
                rates[wid] = 0.0
            else:
                (t0, v0), (t1, v1) = pts[0], pts[-1]
                rates[wid] = max(0.0, (v1 - v0) / (t1 - t0))
        return rates

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/fleet`` document: peers, per-role aggregates, fleet
        totals, merged worker rows with straggler flags, SLO summary."""
        now = self.clock()
        with self._lock:
            peers = list(self._peers.values())
        peer_rows = []
        shards = []
        gateways = []
        worker_rows: dict[str, dict] = {}
        slo_entries: list[dict] = []
        totals = {"tiles_per_s": 0.0, "grants_per_s": 0.0,
                  "queries_per_s": 0.0, "persist_queue_depth": 0.0,
                  "completed": 0, "total_tiles": 0}
        for peer in peers:
            with self._lock:
                role = peer.role
                varz = peer.varz
                latency_doc = peer.latency_doc
                age = None if peer.last_ok is None else now - peer.last_ok
                row = {"url": peer.url, "role": role,
                       "healthy": peer.healthy, "stale": peer.stale,
                       "scrapes": peer.scrapes,
                       "errors": peer.consecutive_errors,
                       "last_error": peer.last_error,
                       "age_s": None if age is None else round(age, 1)}
            peer_rows.append(row)
            if varz is None:
                continue
            for entry in varz.get("slo") or []:
                if isinstance(entry, dict):
                    slo_entries.append({**entry, "peer": peer.url})
            gauges = varz.get("gauges") if isinstance(
                varz.get("gauges"), dict) else {}
            if role in (ROLE_SHARD, ROLE_COORDINATOR):
                shards.append(self._shard_row(peer, varz, gauges, now))
            # Any peer serving gateway traffic gets a gateway row — a
            # dedicated replica, or a coordinator/shard with its
            # gateway enabled (single-process deployments).
            if role == ROLE_GATEWAY or \
                    obs_names.GATEWAY_QUERIES in _counter_families(varz):
                gateways.append(self._gateway_row(peer, varz, gauges,
                                                  latency_doc, now))
            for wid, raw in _worker_rows(varz).items():
                merged = worker_rows.setdefault(
                    wid, {"worker": wid, "tiles": 0, "compute_s": 0.0,
                          "upload_s": 0.0, "lease_to_persist_s": 0.0,
                          "via": []})
                merged["tiles"] += int(_num(raw.get("tiles")) or 0)
                for fld in ("compute_s", "upload_s",
                            "lease_to_persist_s"):
                    merged[fld] += _num(raw.get(fld)) or 0.0
                merged["via"].append(peer.url)
        for s_row in shards:
            totals["tiles_per_s"] += s_row["tiles_per_s"]
            totals["grants_per_s"] += s_row["grants_per_s"]
            totals["persist_queue_depth"] += s_row["persist_queue_depth"]
            totals["completed"] += s_row["completed"]
            totals["total_tiles"] += s_row["total"]
        for g_row in gateways:
            totals["queries_per_s"] += g_row["queries_per_s"]
        worker_rates = self._worker_rates(now)
        stragglers = detect_stragglers(list(worker_rows.values()))
        self.registry.set_gauge(obs_names.GAUGE_FLEET_STRAGGLERS,
                                len(stragglers))
        workers_out = []
        for wid in sorted(worker_rows):
            row = worker_rows[wid]
            tiles = row["tiles"]
            workers_out.append({
                "worker": wid, "tiles": tiles,
                "via": sorted(set(row["via"])),
                "tiles_per_s": round(worker_rates.get(wid, 0.0), 4),
                "compute_s_per_tile": round(
                    row["compute_s"] / tiles, 4) if tiles else 0.0,
                "lease_to_persist_s_per_tile": round(
                    row["lease_to_persist_s"] / tiles, 4) if tiles
                else 0.0,
                "straggler": wid in stragglers,
                "straggler_reasons": stragglers.get(wid, []),
            })
        mpix = totals["tiles_per_s"] * CHUNK_PIXELS / 1e6
        roles: dict[str, dict] = {}
        for row in peer_rows:
            r = roles.setdefault(row["role"], {"count": 0, "healthy": 0})
            r["count"] += 1
            r["healthy"] += 1 if row["healthy"] else 0
        if workers_out:
            roles.setdefault(ROLE_WORKER, {"count": 0, "healthy": 0})
            roles[ROLE_WORKER]["count"] = max(
                roles[ROLE_WORKER]["count"], len(workers_out))
            roles[ROLE_WORKER]["healthy"] = max(
                roles[ROLE_WORKER]["healthy"],
                sum(1 for w in workers_out if w["tiles_per_s"] > 0))
        return {
            "ts": round(now, 3),
            "rate_window_s": self.rate_window,
            "peers": peer_rows,
            "roles": roles,
            "totals": {
                "mpix_per_s": round(mpix, 3),
                "tiles_per_s": round(totals["tiles_per_s"], 4),
                "grants_per_s": round(totals["grants_per_s"], 4),
                "queries_per_s": round(totals["queries_per_s"], 4),
                "persist_queue_depth": totals["persist_queue_depth"],
                "completed": totals["completed"],
                "total_tiles": totals["total_tiles"],
            },
            "shards": shards,
            "gateways": gateways,
            "workers": workers_out,
            "stragglers": sorted(stragglers),
            "slo": _summarize_slo(slo_entries),
        }

    def _shard_row(self, peer: PeerState, varz: dict, gauges: dict,
                   now: float) -> dict:
        sched = varz.get("scheduler") if isinstance(
            varz.get("scheduler"), dict) else {}
        shard_doc = varz.get("shard") if isinstance(
            varz.get("shard"), dict) else {}
        return {
            "url": peer.url,
            "shard": shard_doc.get("shard"),
            "n_shards": shard_doc.get("n_shards"),
            "grants_per_s": round(self._peer_rate(
                peer, obs_names.COORD_WORKLOADS_GRANTED, now=now), 4),
            "tiles_per_s": round(self._peer_rate(
                peer, obs_names.COORD_CHUNKS_SAVED, now=now), 4),
            "frontier_depth": _num(gauges.get(
                obs_names.GAUGE_FRONTIER_DEPTH)) or 0.0,
            "outstanding_leases": _num(gauges.get(
                obs_names.GAUGE_OUTSTANDING_LEASES)) or 0.0,
            "persist_queue_depth": _num(gauges.get(
                obs_names.GAUGE_PERSIST_QUEUE_DEPTH)) or 0.0,
            "completed": int(_num(sched.get("completed")) or 0),
            "total": int(_num(sched.get("total")) or 0),
            "workers": len(_worker_rows(varz)),
        }

    def _gateway_row(self, peer: PeerState, varz: dict, gauges: dict,
                     latency_doc: Optional[dict], now: float) -> dict:
        row = {
            "url": peer.url,
            "queries_per_s": round(self._peer_rate(
                peer, obs_names.GATEWAY_QUERIES, now=now), 4),
            "served_per_s": round(self._peer_rate(
                peer, obs_names.GATEWAY_SERVED, now=now), 4),
            "tier1_hit_ratio": _num(gauges.get(
                obs_names.GAUGE_TIER1_HIT_RATIO)),
            "render_hit_ratio": _num(gauges.get(
                obs_names.GAUGE_RENDER_HIT_RATIO)),
            "sessions_active": _num(gauges.get(
                obs_names.GAUGE_SESSIONS_ACTIVE)),
            "p50_s": None, "p99_s": None,
        }
        if latency_doc is not None:
            row["p50_s"] = _num(latency_doc.get("window_p50"))
            row["p99_s"] = _num(latency_doc.get("window_p99"))
        return row


def _counter_families(varz: dict) -> dict[str, float]:
    counters = varz.get("counters")
    out: dict[str, float] = {}
    if not isinstance(counters, dict):
        return out
    for label, value in counters.items():
        v = _num(value)
        if v is None or not isinstance(label, str):
            continue
        fam = family_of(label)
        out[fam] = out.get(fam, 0.0) + v
    return out


def _hist_counts(varz: dict) -> dict[str, float]:
    hists = varz.get("histograms")
    out: dict[str, float] = {}
    if not isinstance(hists, dict):
        return out
    for label, doc in hists.items():
        if not isinstance(label, str) or not isinstance(doc, dict):
            continue
        v = _num(doc.get("count"))
        if v is None:
            continue
        fam = family_of(label)
        out[fam] = out.get(fam, 0.0) + v
    return out


def _worker_rows(varz: dict) -> dict[str, dict]:
    workers = varz.get("workers")
    out: dict[str, dict] = {}
    if not isinstance(workers, dict):
        return out
    for wid, row in workers.items():
        if isinstance(row, dict):
            out[str(wid)] = row
    return out


def _summarize_slo(entries: list[dict]) -> dict:
    """Worst-case view across peers: per SLO name, the max burns and
    the most alarmed state (firing > hold > ok)."""
    rank = {"ok": 0, "hold": 1, "firing": 2}
    by_name: dict[str, dict] = {}
    for entry in entries:
        name = entry.get("name")
        if not isinstance(name, str):
            continue
        cur = by_name.setdefault(name, {
            "name": name, "state": "ok", "fast_burn": 0.0,
            "slow_burn": 0.0, "objective": entry.get("objective"),
            "peers": 0})
        cur["peers"] += 1
        state = entry.get("state")
        if rank.get(state, 0) > rank.get(cur["state"], 0):
            cur["state"] = state
        for win, key in (("fast", "fast_burn"), ("slow", "slow_burn")):
            doc = entry.get(win)
            if isinstance(doc, dict):
                burn = _num(doc.get("burn"))
                if burn is not None:
                    cur[key] = max(cur[key], burn)
    return {"slos": [by_name[n] for n in sorted(by_name)],
            "worst_state": max((d["state"] for d in by_name.values()),
                               key=lambda s: rank.get(s, 0),
                               default="ok")}


class FleetService:
    """Standalone fleet endpoint: own thread, own loop, an exporter
    serving ``/fleet`` (+ the aggregator's own registry on ``/varz``)
    and a scrape loop driving the aggregator.  Same thread-owned-loop
    lifecycle as loadgen's gateway replicas; scrapes run through the
    loop's executor so the blocking HTTP never stalls the exporter."""

    def __init__(self, aggregator: FleetAggregator, *,
                 scrape_period: float = 2.0, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.aggregator = aggregator
        self.scrape_period = float(scrape_period)
        self.host = host
        self.port = port
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._startup_error: Optional[BaseException] = None

    def start(self, timeout: float = 10.0) -> None:
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-service", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("fleet service did not start in time")
        if self._startup_error is not None:
            raise RuntimeError("fleet service failed to start") \
                from self._startup_error

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except BaseException as e:  # surfaced by start() when early
            self._startup_error = e
            self._ready.set()

    async def _main(self) -> None:
        # Local import: exporter imports chrome/trace machinery the
        # aggregator itself never needs.
        from distributedmandelbrot_tpu_torch.obs.exporter import MetricsExporter
        exporter = MetricsExporter(
            self.aggregator.registry, fleet=self.aggregator,
            varz_extra=lambda: {"role": ROLE_FLEET},
            host=self.host, port=self.port)
        await exporter.start()
        self.port = exporter.port
        self._ready.set()
        loop = asyncio.get_running_loop()
        next_scrape = 0.0
        try:
            while not self._stop.is_set():
                now = time.monotonic()
                if now >= next_scrape:
                    await loop.run_in_executor(
                        None, self.aggregator.scrape_once)
                    next_scrape = time.monotonic() + self.scrape_period
                await asyncio.sleep(0.05)
        finally:
            await exporter.stop()
