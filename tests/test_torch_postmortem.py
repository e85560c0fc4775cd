"""The port's flight recorder (obs/flight.py) + postmortem assembler
(obs/postmortem.py), both carried from the JAX package, under its own
tests: virtual-clock recorder units, dump exit paths, the
corrupt-dump fuzz corpus, clock alignment and the anomaly detectors.

No sockets (the cross-process kill e2e lives in
tests/test_torch_chaos.py): everything here drives the recorder with manual
clocks and hand-built dump directories, so the suite pins the exact
semantics the chaos postmortem depends on.
"""

import json
import os
import random
import sys

import pytest

from distributedmandelbrot_tpu_torch.coordinator.clock import ManualClock
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight, postmortem
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.flight import (DUMP_KIND, DUMP_VERSION,
                                                  FlightRecorder)
from distributedmandelbrot_tpu_torch.obs.metrics import Registry


def _recorder(capacity=16, *, caps=None, cap_window=1.0, role="test"):
    clock = ManualClock(start=100.0)
    wall = ManualClock(start=1_700_000_000.0)
    rec = FlightRecorder(capacity, role=role, clock=clock.now,
                         wall=wall.now, caps=caps, cap_window=cap_window)
    return rec, clock, wall


# -- recorder ring ----------------------------------------------------------


def test_ring_is_bounded_and_seq_is_monotonic():
    rec, clock, _ = _recorder(capacity=4, caps={})
    for i in range(10):
        clock.advance(0.1)
        rec.note(obs_events.SCHED_GRANT, key=(1, 0, i), lease=i)
    assert len(rec) == 4
    assert rec.recorded == 10
    assert rec.dropped == 6  # ring overflow only; no caps armed
    events = rec.tail(10)
    assert [e["seq"] for e in events] == [7, 8, 9, 10]
    assert [e["key"][2] for e in events] == [6, 7, 8, 9]


def test_capacity_must_be_positive():
    with pytest.raises(ValueError):
        FlightRecorder(0)


def test_sampling_caps_bound_hot_category_per_window():
    rec, clock, _ = _recorder(caps={"sched": 2}, cap_window=1.0)
    for _ in range(5):
        rec.note(obs_events.SCHED_GRANT)
    assert len(rec) == 2
    assert rec.dropped == 3
    # The rare family is uncapped even while sched is saturated.
    rec.note(obs_events.CKPT_DONE)
    assert len(rec) == 3
    # A new wall-second opens a fresh budget.
    clock.advance(1.0)
    rec.note(obs_events.SCHED_GRANT)
    assert len(rec) == 4
    assert rec.dropped == 3


def test_event_doc_omits_empty_fields():
    rec, _, _ = _recorder()
    rec.note(obs_events.CKPT_DONE)
    rec.note(obs_events.SCHED_GRANT, key=(2, 1, 1), lease=7, worker=3)
    bare, full = rec.tail(2)
    assert "key" not in bare and "lease" not in bare and "kv" not in bare
    assert full["key"] == [2, 1, 1]
    assert full["lease"] == 7
    assert full["kv"] == {"worker": 3}
    assert full["cat"] == "sched"


def test_header_carries_anchor_pair_and_identity():
    rec, clock, wall = _recorder(role="shard-1")
    rec.shard = 1
    rec.worker_id = "00000000000000ab"
    rec.offsets_fn = lambda: {"00000000000000cd": {"offset": 0.5,
                                                   "error": 0.01}}
    clock.advance(3.0)
    wall.advance(3.0)
    h = rec.header(reason="unit")
    assert h["kind"] == DUMP_KIND and h["v"] == DUMP_VERSION
    assert h["role"] == "shard-1" and h["shard"] == 1
    assert h["worker_id"] == "00000000000000ab"
    assert h["mono0"] == 103.0 and h["wall0"] == 1_700_000_003.0
    assert h["offsets"]["00000000000000cd"]["offset"] == 0.5
    assert h["reason"] == "unit"


def test_header_swallows_offsets_fn_failure():
    rec, _, _ = _recorder()
    rec.offsets_fn = lambda: 1 / 0
    assert rec.header()["offsets"] == {}


def test_snapshot_window_keeps_trailing_seconds():
    rec, clock, _ = _recorder(caps={})
    rec.note(obs_events.SCHED_GRANT, key=(1, 0, 0))
    clock.advance(10.0)
    rec.note(obs_events.SCHED_ACCEPT, key=(1, 0, 0))
    snap = rec.snapshot(window=5.0)
    assert [e["name"] for e in snap["events"]] == [obs_events.SCHED_ACCEPT]
    assert len(rec.snapshot()["events"]) == 2


def test_registry_gauges_track_ring_totals():
    rec, _, _ = _recorder(caps={"sched": 1})
    reg = Registry()
    rec.bind_registry(reg)
    rec.bind_registry(reg)  # idempotent: no duplicate-gauge blowup
    rec.note(obs_events.SCHED_GRANT)
    rec.note(obs_events.SCHED_GRANT)
    snap = reg.snapshot()
    assert snap["gauges"][obs_names.GAUGE_FLIGHT_EVENTS] == 1
    assert snap["gauges"][obs_names.GAUGE_FLIGHT_EVENTS_DROPPED] == 1


# -- dumps ------------------------------------------------------------------


def test_dump_writes_header_plus_events_jsonl(tmp_path):
    rec, _, _ = _recorder(role="shard-0")
    reg = Registry()
    rec.bind_registry(reg)
    rec.note(obs_events.SCHED_GRANT, key=(2, 0, 1), lease=3)
    path = rec.dump(str(tmp_path / "d.jsonl"), reason="unit")
    lines = [json.loads(ln) for ln in
             open(path, "r", encoding="utf-8").read().splitlines()]
    assert lines[0]["kind"] == DUMP_KIND
    assert lines[0]["reason"] == "unit"
    assert lines[1]["name"] == obs_events.SCHED_GRANT
    assert lines[1]["key"] == [2, 0, 1]
    assert not os.path.exists(path + ".tmp")  # atomic: no torn temp
    assert reg.counter_value(obs_names.FLIGHT_DUMPS) == 1


def test_dump_without_a_directory_is_a_noop():
    rec, _, _ = _recorder()
    assert rec.dump() is None
    assert rec.dumps_written == 0


def test_final_dump_wins_over_late_autoflush(tmp_path):
    # CPython daemon threads outlive atexit callbacks: a last autoflush
    # racing the exit dump must not clobber the exit reason.
    rec, _, _ = _recorder()
    rec.dump_dir = str(tmp_path)
    rec.note(obs_events.SCHED_GRANT, key=(1, 0, 0))
    rec.dump(reason="atexit", final=True)
    assert rec.dump(reason="autoflush") is None
    assert postmortem.load_dump(rec.dump_path).header["reason"] == "atexit"


def test_install_dumps_on_excepthook_and_uninstall_restores(tmp_path):
    rec, _, _ = _recorder(role="proc-a")
    prev_hook = sys.excepthook
    rec.install(str(tmp_path), period=0)  # no autoflush thread
    try:
        assert sys.excepthook is not prev_hook
        rec.note(obs_events.SCHED_GRANT, key=(1, 0, 0))
        try:
            raise RuntimeError("boom")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        dump = postmortem.load_dump(rec.dump_path)
        assert dump.header["reason"] == "excepthook:RuntimeError"
        assert [e["name"] for e in dump.events] == [obs_events.SCHED_GRANT]
    finally:
        rec.uninstall()
    assert sys.excepthook is prev_hook


def test_crashpoint_callback_notes_and_dumps_on_hard_exit(tmp_path):
    rec, _, _ = _recorder()
    rec.dump_dir = str(tmp_path)
    rec._on_crashpoint("store.after_chunk_write", True)
    dump = postmortem.load_dump(rec.dump_path)
    assert dump.header["reason"] == "crashpoint:store.after_chunk_write"
    assert dump.events[0]["name"] == obs_events.FAULT_CRASHPOINT
    assert dump.events[0]["kv"]["point"] == "store.after_chunk_write"


# -- module-global recorder -------------------------------------------------


def test_ensure_respects_kill_switch_and_first_caller_wins():
    saved = flight.get()
    flight.set_recorder(None)
    try:
        assert flight.ensure("a", environ={"DMTPU_FLIGHT": "0"}) is None
        flight.note(obs_events.SCHED_GRANT)  # free no-op, must not raise
        first = flight.ensure("coordinator", environ={})
        second = flight.ensure("worker", environ={})
        assert first is second
        assert first.role == "coordinator"
        flight.note(obs_events.SCHED_GRANT, key=(1, 0, 0))
        assert first.recorded == 1
    finally:
        flight.set_recorder(saved)


def test_ensure_binds_registry_for_late_callers():
    saved = flight.get()
    flight.set_recorder(None)
    try:
        flight.ensure("coordinator", environ={})
        reg = Registry()
        flight.ensure("gateway", registry=reg, environ={})
        assert obs_names.GAUGE_FLIGHT_EVENTS in reg.snapshot()["gauges"]
    finally:
        flight.set_recorder(saved)


# -- dump loading: the fuzz corpus ------------------------------------------


def _write(path, data):
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(path, mode) as f:
        f.write(data)


def _dump_lines(role, pid, events, *, wall0=1e9, mono0=0.0, **extra):
    header = {"v": DUMP_VERSION, "kind": DUMP_KIND, "role": role,
              "pid": pid, "reason": "test", "wall0": wall0,
              "mono0": mono0, "seq": len(events), **extra}
    return "\n".join([json.dumps(header)]
                     + [json.dumps(e) for e in events]) + "\n"


def _ev(seq, t, name, key=None, lease=None, **kv):
    doc = {"seq": seq, "t": t, "cat": name.partition(".")[0], "name": name}
    if key is not None:
        doc["key"] = list(key)
    if lease is not None:
        doc["lease"] = lease
    if kv:
        doc["kv"] = kv
    return doc


def test_truncated_dump_yields_partial_timeline(tmp_path):
    body = _dump_lines("shard-0", 10, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(1, 0, 0)),
        _ev(2, 2.0, obs_events.SCHED_ACCEPT, key=(1, 0, 0))])
    _write(str(tmp_path / "a.jsonl"), body[:-25])  # cut mid-line
    pm = postmortem.assemble(str(tmp_path))
    assert len(pm.dumps) == 1
    assert pm.errors == 1
    assert [e["name"] for e in pm.timeline] == [obs_events.SCHED_GRANT]
    assert pm.render_text()  # partial timeline still renders


def test_garbage_and_binary_dumps_never_raise(tmp_path):
    rng = random.Random(20260807)
    _write(str(tmp_path / "junk.jsonl"),
           bytes(rng.randrange(256) for _ in range(4096)))
    _write(str(tmp_path / "trap.jsonl"),
           '["not", "a", "dict"]\n42\nnull\n{"kind": "wrong"}\n')
    _write(str(tmp_path / "empty.jsonl"), "")
    _write(str(tmp_path / "ignored.txt"), "not a dump at all")
    good = _dump_lines("shard-1", 11, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(1, 0, 0))])
    _write(str(tmp_path / "z-good.jsonl"), good)
    pm = postmortem.assemble(str(tmp_path))
    assert [d.proc for d in pm.dumps] == ["shard-1@11"]
    assert pm.file_errors >= 2  # junk + empty (trap may parse 0 events)
    assert len(pm.timeline) == 1
    assert pm.render_text() and pm.to_dict() and pm.to_chrome()


def test_oversized_line_is_skipped_not_parsed(tmp_path):
    big = '{"name": "sched.grant", "t": 1.0, "pad": "' \
        + "x" * postmortem.MAX_LINE_BYTES + '"}'
    body = _dump_lines("shard-0", 1, [
        _ev(1, 2.0, obs_events.SCHED_ACCEPT, key=(1, 0, 0))])
    _write(str(tmp_path / "a.jsonl"), body + big + "\n")
    dump = postmortem.load_dump(str(tmp_path / "a.jsonl"))
    assert dump.errors == 1
    assert [e["name"] for e in dump.events] == [obs_events.SCHED_ACCEPT]


def test_version_mismatch_counts_one_error_but_parses_on(tmp_path):
    body = _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(1, 0, 0))])
    body = body.replace(f'"v": {DUMP_VERSION}', f'"v": {DUMP_VERSION + 9}')
    _write(str(tmp_path / "a.jsonl"), body)
    dump = postmortem.load_dump(str(tmp_path / "a.jsonl"))
    assert dump.errors == 1
    assert len(dump.events) == 1


def test_missing_directory_yields_empty_renderable_postmortem(tmp_path):
    pm = postmortem.assemble(str(tmp_path / "never-made"))
    assert pm.dumps == [] and pm.file_errors == 1
    assert pm.render_text() is not None
    assert pm.to_chrome()["traceEvents"] == []


def test_fuzzed_event_fields_never_crash_assembly(tmp_path):
    rng = random.Random(7)
    weird = [
        {"seq": "x", "t": 1.0, "name": obs_events.SCHED_GRANT,
         "key": [1, "a", 3]},
        {"t": 2.0, "name": obs_events.SCHED_ACCEPT, "key": [1]},
        {"t": 3.0, "name": obs_events.SCHED_GRANT, "key": None,
         "lease": "not-an-int", "kv": {"deep": {"nest": [1, 2]}}},
        {"t": "4.0", "name": obs_events.SCHED_EXPIRE},  # bad t: dropped
        {"t": 5.0, "name": 9},  # bad name: dropped
    ]
    rng.shuffle(weird)
    body = _dump_lines("shard-0", 1, weird)
    _write(str(tmp_path / "a.jsonl"), body)
    pm = postmortem.assemble(str(tmp_path))
    assert pm.line_errors == 2
    assert len(pm.timeline) == 3  # malformed keys coerce to None
    assert pm.render_text() and pm.to_chrome()


def test_assemble_accounts_into_registry(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(1, 0, 0))]))
    _write(str(tmp_path / "bad.jsonl"), "garbage\n")
    reg = Registry()
    pm = postmortem.assemble(str(tmp_path), registry=reg)
    assert reg.counter_value(obs_names.POSTMORTEM_DUMPS_LOADED) == 1
    assert reg.counter_value(obs_names.POSTMORTEM_DUMP_ERRORS) == \
        pm.errors
    assert reg.counter_value(obs_names.POSTMORTEM_ANOMALIES) == \
        len(pm.anomalies)


# -- clock alignment --------------------------------------------------------


def test_worker_dump_aligns_through_coordinator_span_offsets(tmp_path):
    wid = "00000000000000ab"
    # Coordinator: wall 1000.0 at mono 50.0; knows the worker's clock
    # runs 30s behind coordinator mono (offset = +30).
    _write(str(tmp_path / "coord.jsonl"), _dump_lines(
        "shard-0", 1,
        [_ev(1, 51.0, obs_events.SCHED_GRANT, key=(1, 0, 0))],
        wall0=1000.0, mono0=50.0,
        offsets={wid: {"offset": 30.0, "error": 0.004}}))
    # Worker event at its own mono 22.0 -> coord mono 52.0 -> wall
    # 1002.0; the worker's own (bogus) wall anchor must NOT be used.
    _write(str(tmp_path / "worker.jsonl"), _dump_lines(
        "worker", 2,
        [_ev(1, 22.0, obs_events.WKR_STAGE, key=(1, 0, 0))],
        wall0=555.0, mono0=20.0, worker_id=wid))
    pm = postmortem.assemble(str(tmp_path))
    by_name = {e["name"]: e for e in pm.timeline}
    grant = by_name[obs_events.SCHED_GRANT]
    stage = by_name[obs_events.WKR_STAGE]
    assert grant["t"] == pytest.approx(1001.0)
    assert stage["t"] == pytest.approx(1002.0)
    assert stage["align"] == "spans"
    assert stage["align_error_s"] == pytest.approx(0.004)
    assert pm.timeline[0] is grant  # causal order across processes


def test_best_offset_prefers_tightest_error_bound(tmp_path):
    wid = "00000000000000ab"
    _write(str(tmp_path / "a.jsonl"), _dump_lines(
        "shard-0", 1, [], wall0=1000.0, mono0=0.0,
        offsets={wid: {"offset": 5.0, "error": 0.5}}))
    _write(str(tmp_path / "b.jsonl"), _dump_lines(
        "shard-1", 2, [], wall0=1000.0, mono0=0.0,
        offsets={wid: {"offset": 7.0, "error": 0.001}}))
    _write(str(tmp_path / "w.jsonl"), _dump_lines(
        "worker", 3, [_ev(1, 1.0, obs_events.WKR_STAGE)],
        wall0=0.0, mono0=0.0, worker_id=wid))
    pm = postmortem.assemble(str(tmp_path))
    assert pm.timeline[0]["t"] == pytest.approx(1008.0)  # b's offset won


def test_wall_anchor_fallback_and_headerless_raw(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines(
        "shard-0", 1, [_ev(1, 3.0, obs_events.SCHED_GRANT)],
        wall0=2000.0, mono0=1.0))
    _write(str(tmp_path / "b.jsonl"),
           json.dumps(_ev(1, 4.5, obs_events.SCHED_ACCEPT)) + "\n")
    pm = postmortem.assemble(str(tmp_path))
    by_name = {e["name"]: e for e in pm.timeline}
    assert by_name[obs_events.SCHED_GRANT]["t"] == pytest.approx(2002.0)
    assert by_name[obs_events.SCHED_GRANT]["align"] == "wall"
    assert by_name[obs_events.SCHED_ACCEPT]["t"] == pytest.approx(4.5)
    assert by_name[obs_events.SCHED_ACCEPT]["align"] == "none"


# -- in-flight reconstruction + anomaly detectors ---------------------------


def test_in_flight_grants_reconstructed_per_process(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(3, 0, 0), lease=1),
        _ev(2, 1.1, obs_events.SCHED_GRANT, key=(3, 0, 1), lease=2),
        _ev(3, 1.5, obs_events.SCHED_ACCEPT, key=(3, 0, 0), lease=1)]))
    pm = postmortem.assemble(str(tmp_path))
    assert list(pm.in_flight) == ["shard-0@1"]
    assert [e["key"] for e in pm.in_flight["shard-0@1"]] == [(3, 0, 1)]
    kinds = {a["type"] for a in pm.anomalies}
    assert "grant-without-accept" in kinds


def test_grant_without_accept_annotates_regrant(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(3, 0, 0), lease=1)],
        wall0=1000.0, mono0=0.0))
    _write(str(tmp_path / "b.jsonl"), _dump_lines("shard-0", 9, [
        _ev(1, 6.0, obs_events.SCHED_GRANT, key=(3, 0, 0), lease=1),
        _ev(2, 7.0, obs_events.SCHED_ACCEPT, key=(3, 0, 0), lease=1)],
        wall0=1000.0, mono0=0.0))
    pm = postmortem.assemble(str(tmp_path))
    anomaly = next(a for a in pm.anomalies
                   if a["type"] == "grant-without-accept")
    assert anomaly["proc"] == "shard-0@1"
    assert anomaly["regranted_by"] == "shard-0@9"
    assert anomaly["t_regrant"] == pytest.approx(1006.0)
    assert pm.tile_history((3, 0, 0))


def test_lease_ping_pong_detector(tmp_path):
    events = []
    for i in range(3):
        events.append(_ev(2 * i + 1, float(i), obs_events.SCHED_GRANT,
                          key=(3, 1, 1), lease=i))
        events.append(_ev(2 * i + 2, i + 0.5, obs_events.SCHED_EXPIRE,
                          key=(3, 1, 1), lease=i))
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, events))
    pm = postmortem.assemble(str(tmp_path))
    assert any(a["type"] == "lease-ping-pong" for a in pm.anomalies)


def test_redirect_loop_detector(tmp_path):
    events = [_ev(i + 1, float(i), obs_events.SESS_REDIRECT,
                  key=(3, 2, 2), owner=1) for i in range(3)]
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, events))
    pm = postmortem.assemble(str(tmp_path))
    assert any(a["type"] == "redirect-loop" for a in pm.anomalies)


def test_double_commit_detector_across_processes(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_ACCEPT, key=(3, 0, 2), lease=1)]))
    _write(str(tmp_path / "b.jsonl"), _dump_lines("shard-1", 2, [
        _ev(1, 2.0, obs_events.SCHED_ACCEPT, key=(3, 0, 2), lease=9)]))
    pm = postmortem.assemble(str(tmp_path))
    double = next(a for a in pm.anomalies if a["type"] == "double-commit")
    assert sorted(double["procs"]) == ["shard-0@1", "shard-1@2"]


def test_retry_storm_detector_needs_tight_window(tmp_path):
    storm = [_ev(i + 1, i * 0.5, obs_events.SESS_RESULT_REJECTED,
                 key=(3, 1, 2)) for i in range(5)]
    spread = [_ev(i + 1, i * 100.0, obs_events.SESS_RESULT_REJECTED,
                  key=(3, 2, 1)) for i in range(5)]
    _write(str(tmp_path / "a.jsonl"),
           _dump_lines("shard-0", 1, storm + spread))
    pm = postmortem.assemble(str(tmp_path))
    storms = [a for a in pm.anomalies if a["type"] == "retry-storm"]
    assert [a["key"] for a in storms] == [[3, 1, 2]]


def test_chrome_export_names_processes_and_orders_events(tmp_path):
    _write(str(tmp_path / "a.jsonl"), _dump_lines("shard-0", 1, [
        _ev(1, 1.0, obs_events.SCHED_GRANT, key=(1, 0, 0), lease=4),
        _ev(2, 1.5, obs_events.SCHED_ACCEPT, key=(1, 0, 0), lease=4)]))
    doc = postmortem.assemble(str(tmp_path)).to_chrome()
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert metas[0]["args"]["name"] == "shard-0@1"
    assert [e["ts"] for e in inst] == sorted(e["ts"] for e in inst)
    assert inst[0]["args"]["key"] == "1/0/0"


# -- SLO integration --------------------------------------------------------


def test_slo_fire_attaches_flight_evidence():
    from distributedmandelbrot_tpu_torch.obs.slo import _BaseSLO

    class AlwaysBurning(_BaseSLO):
        def _window_counts(self, window, now):
            return 0, 100

    saved = flight.get()
    flight.set_recorder(None)
    try:
        rec = flight.ensure("gateway", environ={})
        rec.note(obs_events.GW_SHED, key=(4, 1, 1))
        reg = Registry()
        from distributedmandelbrot_tpu_torch.obs.timeseries import \
            TimeseriesSampler
        slo = AlwaysBurning("test_slo", TimeseriesSampler(reg, period=1.0))
        doc = slo.evaluate()
        assert doc["state"] == "firing"
        names = [e["name"] for e in doc["evidence"]]
        assert obs_events.GW_SHED in names
        assert names[-1] == obs_events.SLO_FIRE
    finally:
        flight.set_recorder(saved)
