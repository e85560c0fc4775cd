"""The port's fleet aggregation (``obs/fleet.py``, ``obs/top.py``,
carried from the JAX package), under the JAX package's own tests:
peer parsing, role merging, aggregator-side
rates, scrape-failure robustness (fuzzed bodies), the bounded fetch,
the standalone FleetService, and the `dmtpu top` renderer."""

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from distributedmandelbrot_tpu_torch.coordinator.clock import ManualClock
from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.fleet import (FleetAggregator,
                                                 FleetService, ScrapeError,
                                                 http_fetch,
                                                 parse_peer_spec)
from distributedmandelbrot_tpu_torch.obs.metrics import Registry
from distributedmandelbrot_tpu_torch.obs.top import render_top


# -- peer specs ------------------------------------------------------------


def test_parse_peer_spec():
    assert parse_peer_spec("10.0.0.1:9000") == \
        ("http://10.0.0.1:9000", None)
    assert parse_peer_spec("shard@10.0.0.1:9000") == \
        ("http://10.0.0.1:9000", "shard")
    assert parse_peer_spec("http://h:1/") == ("http://h:1", None)
    assert parse_peer_spec("gateway@https://h:1") == \
        ("https://h:1", "gateway")
    assert parse_peer_spec("@h:1") == ("http://h:1", None)


def test_from_ring_skips_exporterless_shards():
    from distributedmandelbrot_tpu_torch.control.ring import HashRing, ShardInfo

    ring = HashRing([ShardInfo("10.0.0.1", 1, exporter_port=9100),
                     ShardInfo("10.0.0.2", 1)])  # no exporter bound
    agg = FleetAggregator.from_ring(ring)
    assert agg.peer_urls == ["http://10.0.0.1:9100"]


# -- a scriptable fetch ----------------------------------------------------


def make_fetch(responses):
    """``responses[base_url][endpoint]`` -> dict/bytes to serve, an
    Exception to raise, or a zero-arg callable producing either."""

    def fetch(url, timeout=2.0, max_bytes=0):
        for endpoint in ("/varz", "/timeseries"):
            if endpoint in url:
                base = url.split(endpoint)[0]
                body = responses.get(base, {}).get(endpoint[1:])
                break
        else:
            raise AssertionError(f"unexpected scrape url {url}")
        if callable(body):
            body = body()
        if body is None:
            raise ScrapeError("connection refused")
        if isinstance(body, Exception):
            raise body
        if isinstance(body, (dict, list)):
            body = (json.dumps(body) + "\n").encode()
        return body

    return fetch


def shard_varz(grants, saved, *, shard=0, workers=None, slo=None):
    return {
        "shard": {"shard": shard, "n_shards": 2},
        "scheduler": {"completed": 5, "total": 64},
        "counters": {obs_names.COORD_WORKLOADS_GRANTED: grants,
                     obs_names.COORD_CHUNKS_SAVED: saved},
        "gauges": {obs_names.GAUGE_FRONTIER_DEPTH: 7.0,
                   obs_names.GAUGE_OUTSTANDING_LEASES: 3.0,
                   obs_names.GAUGE_PERSIST_QUEUE_DEPTH: 2.0},
        "workers": workers or {},
        "slo": slo or [],
    }


def gateway_varz(queries):
    return {
        "role": "gateway",
        "counters": {
            obs_names.GATEWAY_QUERIES: queries,
            obs_names.GATEWAY_SERVED + "{outcome=tier1_hit}": queries,
        },
        "gauges": {obs_names.GAUGE_TIER1_HIT_RATIO: 0.75,
                   obs_names.GAUGE_RENDER_HIT_RATIO: 0.5,
                   obs_names.GAUGE_SESSIONS_ACTIVE: 2},
        "histograms": {
            obs_names.HIST_GATEWAY_REQUEST_SECONDS
            + "{outcome=tier1_hit}": {"count": queries, "sum": 0.1},
        },
    }


def worker_row(tiles, compute_s, persist_s=1.0):
    return {"tiles": tiles, "compute_s": compute_s, "upload_s": 0.1,
            "lease_to_persist_s": persist_s}


# -- merging and rates -----------------------------------------------------


def test_fleet_merges_roles_rates_and_totals():
    clk = ManualClock()
    counts = {"grants": 100, "saved": 50, "queries": 10}
    responses = {
        "http://s0:1": {"varz": lambda: shard_varz(
            counts["grants"], counts["saved"], shard=0)},
        "http://s1:1": {"varz": lambda: shard_varz(
            counts["grants"], counts["saved"], shard=1)},
        "http://g0:1": {
            "varz": lambda: gateway_varz(counts["queries"]),
            "timeseries": {"name": "gateway_request_seconds",
                           "kind": "histogram",
                           "window_p50": 0.002, "window_p99": 0.05},
        },
        # http://dead:1 has no entry: every fetch raises.
    }
    agg = FleetAggregator(
        ["s0:1", "shard@s1:1", "g0:1", "worker@dead:1"],
        fetch=make_fetch(responses), clock=clk.now, rate_window=60.0)
    agg.scrape_once()
    clk.advance(10.0)
    counts.update(grants=200, saved=150, queries=110)
    agg.scrape_once()

    snap = agg.snapshot()
    assert snap["roles"]["shard"] == {"count": 2, "healthy": 2}
    assert snap["roles"]["gateway"] == {"count": 1, "healthy": 1}
    # The dead peer keeps its spec's role hint and reads unhealthy.
    assert snap["roles"]["worker"]["healthy"] == 0

    # Rates are aggregator-side counter deltas: (200-100)/10s per shard.
    totals = snap["totals"]
    assert totals["grants_per_s"] == pytest.approx(20.0)
    assert totals["tiles_per_s"] == pytest.approx(20.0)
    assert totals["queries_per_s"] == pytest.approx(10.0)
    assert totals["mpix_per_s"] == pytest.approx(
        20.0 * CHUNK_PIXELS / 1e6, rel=1e-3)
    assert totals["completed"] == 10
    assert totals["total_tiles"] == 128
    assert totals["persist_queue_depth"] == 4.0

    [s0, s1] = snap["shards"]
    assert (s0["shard"], s1["shard"]) == (0, 1)
    assert s0["grants_per_s"] == pytest.approx(10.0)
    assert s0["frontier_depth"] == 7.0

    [gw] = snap["gateways"]
    assert gw["queries_per_s"] == pytest.approx(10.0)
    assert gw["tier1_hit_ratio"] == 0.75
    # Windowed percentiles ride the peer's /timeseries document.
    assert gw["p50_s"] == 0.002
    assert gw["p99_s"] == 0.05

    dead = [p for p in snap["peers"] if "dead" in p["url"]][0]
    assert dead["stale"] and not dead["healthy"]
    assert dead["errors"] == 2
    assert agg.registry.counter_value(obs_names.FLEET_SCRAPE_ERRORS) == 2
    assert agg.registry.counter_value(obs_names.FLEET_SCRAPES) == 2


def test_fleet_merges_multihomed_workers_and_flags_stragglers():
    clk = ManualClock()
    responses = {
        # w_both reports through both shards (multi-homed): sums.
        "http://s0:1": {"varz": shard_varz(1, 1, shard=0, workers={
            "w_both": worker_row(10, 1.0),
            "w_a": worker_row(10, 1.0),
            "w_slow": worker_row(10, 100.0, persist_s=200.0)})},
        "http://s1:1": {"varz": shard_varz(1, 1, shard=1, workers={
            "w_both": worker_row(5, 0.5),
            "w_b": worker_row(10, 1.0)})},
    }
    agg = FleetAggregator(["s0:1", "s1:1"], fetch=make_fetch(responses),
                          clock=clk.now)
    agg.scrape_once()
    snap = agg.snapshot()
    rows = {w["worker"]: w for w in snap["workers"]}
    assert rows["w_both"]["tiles"] == 15
    assert rows["w_both"]["via"] == ["http://s0:1", "http://s1:1"]
    assert rows["w_both"]["compute_s_per_tile"] == pytest.approx(0.1)
    assert rows["w_slow"]["straggler"]
    assert "slow_compute" in rows["w_slow"]["straggler_reasons"]
    assert not rows["w_a"]["straggler"]
    assert snap["stragglers"] == ["w_slow"]
    assert snap["roles"]["worker"]["count"] == 4
    assert agg.registry.gauge(
        obs_names.GAUGE_FLEET_STRAGGLERS).read() == 1.0


def test_fleet_summarizes_slo_worst_case():
    slo_doc = lambda state, fast, slow: [{
        "name": "gateway_availability", "objective": 0.99,
        "state": state, "fast": {"burn": fast}, "slow": {"burn": slow}}]
    responses = {
        "http://s0:1": {"varz": shard_varz(
            1, 1, shard=0, slo=slo_doc("ok", 0.1, 0.2))},
        "http://s1:1": {"varz": shard_varz(
            1, 1, shard=1, slo=slo_doc("firing", 25.0, 12.0))},
    }
    agg = FleetAggregator(["s0:1", "s1:1"], fetch=make_fetch(responses))
    agg.scrape_once()
    slo = agg.snapshot()["slo"]
    assert slo["worst_state"] == "firing"
    [entry] = slo["slos"]
    assert entry["peers"] == 2
    assert entry["state"] == "firing"
    assert entry["fast_burn"] == 25.0
    assert entry["slow_burn"] == 12.0


# -- robustness fuzz -------------------------------------------------------


FUZZ_BODIES = [
    b"not json at all",
    b'{"truncated": ',
    b"[1, 2, 3]",             # JSON, but not an object
    b'"a string"',
    b"\xff\xfe\x00garbage",   # undecodable bytes
    b"",
    ScrapeError("body exceeds 4194304 bytes"),   # http_fetch's bound
    ScrapeError("connection refused"),
    OSError("socket burst into flames"),
]


def test_fleet_survives_fuzzed_peer_bodies():
    responses = {f"http://p{i}:1": {"varz": body}
                 for i, body in enumerate(FUZZ_BODIES)}
    agg = FleetAggregator([f"p{i}:1" for i in range(len(FUZZ_BODIES))],
                          fetch=make_fetch(responses))
    for _ in range(2):
        agg.scrape_once()   # must not raise
    snap = agg.snapshot()   # must not raise either
    assert len(snap["peers"]) == len(FUZZ_BODIES)
    assert all(p["stale"] and not p["healthy"] for p in snap["peers"])
    assert all(p["last_error"] for p in snap["peers"])
    assert snap["shards"] == [] and snap["gateways"] == []
    assert agg.registry.counter_value(
        obs_names.FLEET_SCRAPE_ERRORS) == 2 * len(FUZZ_BODIES)
    assert agg.registry.gauge(obs_names.GAUGE_FLEET_PEERS).read() == \
        len(FUZZ_BODIES)
    assert agg.registry.gauge(
        obs_names.GAUGE_FLEET_PEERS_STALE).read() == len(FUZZ_BODIES)


def test_fleet_version_skew_degrades_gracefully():
    # A gateway that predates /timeseries: rates still merge, only the
    # percentile columns go dark.
    responses = {"http://old:1": {
        "varz": gateway_varz(50),
        "timeseries": ScrapeError("404 not found"),
    }}
    agg = FleetAggregator(["old:1"], fetch=make_fetch(responses))
    agg.scrape_once()
    snap = agg.snapshot()
    [gw] = snap["gateways"]
    assert gw["p50_s"] is None and gw["p99_s"] is None
    assert snap["peers"][0]["healthy"]
    # The skewed /timeseries is not a scrape error — never registered.
    assert not agg.registry.counter_value(obs_names.FLEET_SCRAPE_ERRORS)


def test_fleet_peer_going_dark_turns_stale_not_fatal():
    state = {"alive": True}
    responses = {"http://flap:1": {
        "varz": lambda: (shard_varz(1, 1) if state["alive"]
                         else ScrapeError("connection refused"))}}
    agg = FleetAggregator(["flap:1"], fetch=make_fetch(responses))
    agg.scrape_once()
    assert agg.snapshot()["peers"][0]["healthy"]
    state["alive"] = False
    agg.scrape_once()
    peer = agg.snapshot()["peers"][0]
    # One miss: unhealthy but not yet stale (scrape jitter tolerance).
    assert not peer["healthy"] and not peer["stale"]
    agg.scrape_once()
    peer = agg.snapshot()["peers"][0]
    assert peer["stale"] and "refused" in peer["last_error"]
    # The last good varz is retained, so the role survives the outage.
    assert peer["role"] == "shard"


# -- the bounded fetch against a real socket -------------------------------


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        body = b"x" * (4096 if self.path == "/big" else 16)
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_http_fetch_bounds_and_failures():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert http_fetch(base + "/small") == b"x" * 16
        with pytest.raises(ScrapeError, match="exceeds"):
            http_fetch(base + "/big", max_bytes=1024)
        with pytest.raises(ScrapeError):
            http_fetch("http://127.0.0.1:1/varz", timeout=0.5)
    finally:
        server.shutdown()
        server.server_close()


# -- FleetService over real HTTP ------------------------------------------


def test_fleet_service_scrapes_a_live_exporter():
    from distributedmandelbrot_tpu_torch.obs.exporter import ExporterThread

    reg = Registry()
    reg.inc(obs_names.COORD_WORKLOADS_GRANTED, 3)
    peer = ExporterThread(reg, varz_extra=lambda: {
        "role": "shard", "shard": {"shard": 0, "n_shards": 1}})
    peer.start()
    service = None
    try:
        agg = FleetAggregator([f"shard@127.0.0.1:{peer.port}"],
                              timeout=5.0)
        service = FleetService(agg, scrape_period=0.05)
        service.start()
        deadline = threading.Event()
        snap = {}
        for _ in range(100):
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{service.port}/fleet",
                timeout=10).read()
            snap = json.loads(body)
            if snap.get("peers") and snap["peers"][0]["healthy"]:
                break
            deadline.wait(0.1)
        assert snap["peers"][0]["healthy"]
        assert snap["roles"]["shard"]["count"] == 1
        assert [s["shard"] for s in snap["shards"]] == [0]
        varz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{service.port}/varz", timeout=10).read())
        assert varz["role"] == "fleet"
    finally:
        if service is not None:
            service.stop()
        peer.stop()


# -- the dashboard renderer ------------------------------------------------


def _rich_snapshot():
    clk = ManualClock()
    responses = {
        "http://s0:1": {"varz": lambda: shard_varz(
            grants.get("n", 100), grants.get("n", 100), shard=0,
            workers={"w1": worker_row(10, 1.0),
                     "w2": worker_row(10, 1.0),
                     "w3": worker_row(10, 1.0),
                     "w_slow": worker_row(10, 99.0, persist_s=150.0)},
            slo=[{"name": "gateway_availability", "objective": 0.99,
                  "state": "firing", "fast": {"burn": 42.0},
                  "slow": {"burn": 17.0}}])},
        "http://g0:1": {"varz": lambda: gateway_varz(grants.get("n", 10)),
                        "timeseries": {"window_p50": 0.002,
                                       "window_p99": 0.05}},
    }
    grants = {"n": 100}
    agg = FleetAggregator(["s0:1", "g0:1", "shard@dead:1"],
                          fetch=make_fetch(responses), clock=clk.now)
    agg.scrape_once()
    clk.advance(10.0)
    grants["n"] = 200
    agg.scrape_once()
    return agg.snapshot()


def test_render_top_plain_and_color():
    snap = _rich_snapshot()
    plain = render_top(snap, color=False)
    assert "\x1b[" not in plain          # grep-able without a tty
    assert "dmtpu top" in plain
    assert "3 peers" in plain
    assert "SHARD" in plain and "GATEWAY" in plain and "WORKER" in plain
    assert "gateway_availability" in plain and "firing" in plain
    assert "w_slow" in plain
    assert "YES slow_compute,lease_to_persist_skew" in plain
    assert "UNHEALTHY PEERS" in plain and "dead:1" in plain
    color = render_top(snap, color=True)
    assert "\x1b[31m" in color           # firing / stragglers in red


def test_render_top_empty_snapshot():
    out = render_top({}, color=False)
    assert "0 peers" in out
    assert out.endswith("\n")
