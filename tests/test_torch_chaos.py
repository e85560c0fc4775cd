"""The port's chaos scenario plumbing (``chaos/``, carried from the JAX
package), under the JAX package's own tests: the scenario catalogue,
target validation, the runner's expected-grid / per-shard ownership
precompute, and the report serialisation — plus one live
kill-and-restart farm of the port's shards (subprocess shards, SIGKILL,
flight-recorder dumps, postmortem reconstruction).

The live farm kills shard 0 once its autoflushed dump holds a grant,
and stops the grant storm once the restarted shard's dump holds one:
both waits are polls under a deadline, not fixed sleeps, so a loaded
host cannot kill the shard before it has granted anything.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from distributedmandelbrot_tpu_torch.chaos.runner import (ChaosReport,
                                                    ChaosRunner, KillEvent,
                                                    SCENARIOS, Scenario,
                                                    run_scenario)
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import postmortem


def test_catalogue_is_sane():
    assert {"coord-kill", "coord-crashpoint", "worker-churn",
            "slow-persist", "storm"} <= set(SCENARIOS)
    for name, sc in SCENARIOS.items():
        assert sc.name == name
        assert sc.description
        assert sc.n_shards >= 1 and sc.n_workers >= 1
        assert sc.deadline > 0
        # Every scheduled kill and crashpoint must name a slot the farm
        # actually has — ChaosRunner validates this at construction, so
        # a bad catalogue entry fails here instead of mid-run.
        ChaosRunner(sc)


def test_scenario_replace_plumbing():
    sc = dataclasses.replace(SCENARIOS["coord-kill"], n_workers=1,
                             levels="3:2", parity_samples=1)
    assert sc.n_workers == 1
    assert SCENARIOS["coord-kill"].n_workers == 2  # catalogue untouched
    runner = ChaosRunner(sc)
    assert len(runner.workers) == 1
    assert len(runner.expected) == 9


def test_runner_precomputes_owned_partition():
    runner = ChaosRunner(Scenario(name="t", levels="4:2", n_shards=3))
    assert runner.expected == {(4, i, j)
                               for i in range(4) for j in range(4)}
    # owned_expected is a partition of the grid by ring owner.
    assert set().union(*runner.owned_expected) == runner.expected
    total = sum(len(s) for s in runner.owned_expected)
    assert total == len(runner.expected)
    for shard, keys in enumerate(runner.owned_expected):
        assert all(runner.ring.owner_of(k) == shard for k in keys)


def test_runner_rejects_bad_targets():
    with pytest.raises(ValueError):
        ChaosRunner(Scenario(name="t", n_shards=2,
                             kills=(KillEvent(1.0, "coord:2"),)))
    with pytest.raises(ValueError):
        ChaosRunner(Scenario(name="t",
                             kills=(KillEvent(1.0, "gateway:0"),)))
    with pytest.raises(ValueError):
        ChaosRunner(Scenario(name="t",
                             kills=(KillEvent(1.0, "coord:x"),)))
    with pytest.raises(ValueError):
        # Crashpoints ride DMTPU_CRASHPOINTS in the coordinator env;
        # a worker target would silently never fire.
        ChaosRunner(Scenario(name="t",
                             crashpoints={"worker:0": "x:1"}))


def test_report_to_json_round_trips():
    report = ChaosReport(
        scenario="coord-kill", ok=False, duration_s=12.3,
        expected_tiles=9, tiles_on_disk=8, duplicate_entries=0,
        misowned_entries=0, parity_checked=2, parity_failures=0,
        kills=1, restarts=1, restart_to_first_grant_s=[0.42],
        failures=["1 tiles never completed (first: (3, 0, 0))"])
    doc = json.loads(report.to_json())
    assert doc["scenario"] == "coord-kill"
    assert doc["ok"] is False
    assert doc["restart_to_first_grant_s"] == [0.42]
    assert doc["failures"]


def test_run_scenario_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenario("does-not-exist")


def test_report_carries_postmortem_summary():
    report = ChaosReport(
        scenario="coord-kill", ok=False, duration_s=1.0,
        expected_tiles=9, tiles_on_disk=8, duplicate_entries=0,
        misowned_entries=0, parity_checked=0, parity_failures=0,
        kills=1, restarts=1, failures=["x"],
        postmortem={"processes": [], "anomalies": []})
    doc = json.loads(report.to_json())
    assert doc["postmortem"]["anomalies"] == []
    # ok reports stay lean: the field defaults empty.
    assert ChaosReport(scenario="s", ok=True, duration_s=0.0,
                       expected_tiles=0, tiles_on_disk=0,
                       duplicate_entries=0, misowned_entries=0,
                       parity_checked=0, parity_failures=0,
                       kills=0, restarts=0).postmortem == {}


# -- live kill-and-restart farm ---------------------------------------------

_DRIVER = "distributedmandelbrot_tpu_torch.chaos.driver"


def _farm_env(flight_dir: str) -> dict:
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    env["DMTPU_FLIGHT_DIR"] = flight_dir
    env["DMTPU_FLIGHT_PERIOD"] = "0.1"  # autoflush = the SIGKILL survivor
    return env


def _spawn_shard(tmp, flight_dir, tag, shard, n_shards):
    port_file = os.path.join(tmp, f"ports-{tag}.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", _DRIVER, "shard",
         os.path.join(tmp, "farm"), port_file, "8:16",
         str(shard), str(n_shards),
         "--lease-timeout", "0.05", "--sweep-period", "0.02",
         "--checkpoint-period", "0"],
        env=_farm_env(flight_dir), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    return proc, port_file


def _read_ports(proc, port_file, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while not os.path.exists(port_file):
        if proc.poll() is not None:
            raise RuntimeError(
                f"shard died during startup (exit {proc.returncode})")
        if time.monotonic() > deadline:
            proc.kill()
            raise RuntimeError("shard never wrote its port file")
        time.sleep(0.05)
    with open(port_file, "r", encoding="utf-8") as f:
        return json.load(f)


def _save_ring(tmp, infos):
    from distributedmandelbrot_tpu_torch.control.ring import HashRing, ShardInfo
    ring_path = os.path.join(tmp, "ring.json")
    HashRing([ShardInfo("127.0.0.1",
                        distributer_port=i["distributer"],
                        dataserver_port=i["dataserver"],
                        exporter_port=i["exporter"])
              for i in infos], version=1).save(ring_path)
    return ring_path


# The storm outlasts both grant waits on a loaded host; the test ends
# as soon as the drain's window does.
_DRAIN_SECONDS = 20.0


def _wait_for_grant(flight_dir, shard, pid, proc, deadline_s=60.0):
    """Poll shard ``shard`` (process ``pid``)'s autoflushed flight dump
    until it holds a ``SCHED_GRANT`` event."""
    path = os.path.join(flight_dir, f"flight-shard-{shard}-{pid}.jsonl")
    deadline = time.monotonic() + deadline_s
    while True:
        if os.path.exists(path) and any(
                e["name"] == obs_events.SCHED_GRANT
                for e in postmortem.load_dump(path).events):
            return
        if proc.poll() is not None:
            raise RuntimeError(f"shard {shard} exited ({proc.returncode}) "
                               "before it granted a lease")
        if time.monotonic() > deadline:
            raise TimeoutError(f"shard {shard}'s dump shows no grant after "
                               f"{deadline_s:.0f} s")
        time.sleep(0.05)


def test_kill_and_restart_postmortem_reconstructs_the_fleet(tmp_path):
    """SIGKILL a shard under grant storm, restart it, and assemble the
    flight dumps: the killed incarnation's black box survives via
    autoflush, the restarted incarnation's grants land causally after
    the kill, and the survivors dump cleanly at SIGTERM."""
    tmp = str(tmp_path)
    flight_dir = os.path.join(tmp, "flight")
    os.makedirs(flight_dir)
    procs = []
    drain = None
    try:
        shard0, pf0 = _spawn_shard(tmp, flight_dir, "s0", 0, 2)
        shard1, pf1 = _spawn_shard(tmp, flight_dir, "s1", 1, 2)
        procs += [shard0, shard1]
        infos = [_read_ports(shard0, pf0), _read_ports(shard1, pf1)]
        ring_path = _save_ring(tmp, infos)
        drain = subprocess.Popen(
            [sys.executable, "-m", _DRIVER, "drain", ring_path,
             "--duration", str(_DRAIN_SECONDS), "--batch", "16",
             "--out", os.path.join(tmp, "drain.json")],
            env=_farm_env(flight_dir), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        # SIGKILL shard 0 mid-grant once an autoflush has written a
        # grant: no exit hook runs, so its dump is whatever the last
        # autoflush wrote.
        killed_pid = infos[0]["pid"]
        _wait_for_grant(flight_dir, 0, killed_pid, shard0)
        t_kill_wall = time.time()
        shard0.kill()
        shard0.wait()
        # Restart shard 0 (fresh pid, same shard index + data dir) and
        # re-publish the ring so the drain client re-dials it.
        shard0b, pf0b = _spawn_shard(tmp, flight_dir, "s0b", 0, 2)
        procs.append(shard0b)
        infos[0] = _read_ports(shard0b, pf0b)
        _save_ring(tmp, infos)
        _wait_for_grant(flight_dir, 0, infos[0]["pid"], shard0b)
        drain.wait(timeout=_DRAIN_SECONDS + 90.0)
        with open(os.path.join(tmp, "drain.json"), encoding="utf-8") as f:
            assert json.load(f)["grants"] > 0
        # SIGTERM is the graceful path: coordinator.stop() then exit,
        # which rewrites each survivor's dump with reason=atexit.
        for proc in (shard0b, shard1):
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60.0)
    finally:
        if drain is not None and drain.poll() is None:
            drain.kill()
            drain.wait()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    pm = postmortem.assemble(flight_dir)
    by_pid = {d.header.get("pid"): d for d in pm.dumps}
    killed = by_pid[killed_pid]
    assert killed.role == "shard-0"
    assert killed.header["reason"] == "autoflush"  # SIGKILL: no exit hook
    survivors = [d for d in pm.dumps if d.header.get("pid") != killed_pid]
    assert {d.role for d in survivors} == {"shard-0", "shard-1"}
    assert all(d.header["reason"] == "atexit" for d in survivors)
    # The killed incarnation granted leases, and the restarted
    # incarnation's grants all land after the kill on the merged clock.
    killed_grants = [e for e in pm.timeline if e["proc"] == killed.proc
                     and e["name"] == obs_events.SCHED_GRANT]
    assert killed_grants
    restarted = next(d for d in survivors if d.role == "shard-0")
    restarted_grants = [e for e in pm.timeline
                        if e["proc"] == restarted.proc
                        and e["name"] == obs_events.SCHED_GRANT]
    assert restarted_grants
    assert killed_grants[-1]["t"] < t_kill_wall < restarted_grants[0]["t"]
    assert pm.summary()["events"] == len(pm.timeline)
