"""The port's sharded control plane and its operations tools on the CPU,
through ``cli.main`` and ``python -m distributedmandelbrot_tpu_torch``:
``coord`` shards drained by ``worker --ring``, ``top``, ``stats``,
``trace``, ``admin``, ``compact``, ``postmortem``, ``loadgen`` and
``chaos``, and the worker's ``--exporter-port`` and ``--profile``.

Interop both ways: the port's ring worker drains the JAX package's
``coord`` shards and the JAX package's ring worker drains the port's;
the port's ``top`` reads the JAX shards' exporters and its
``postmortem`` assembles the flight dumps they wrote.  Chunks are full
4096^2 (the wire requires it), budgets tiny."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from distributedmandelbrot_tpu import cli as ref_cli
from distributedmandelbrot_tpu.obs import postmortem as ref_postmortem
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.chaos import runner
from distributedmandelbrot_tpu_torch.control.ring import HashRing, ShardInfo
from distributedmandelbrot_tpu_torch.coordinator import EmbeddedCoordinator
from distributedmandelbrot_tpu_torch.core.workload import (
    Workload, parse_level_settings)
from distributedmandelbrot_tpu_torch.viewer import DataClient, FetchStatus
from distributedmandelbrot_tpu_torch.worker import NativeBackend

REPO = Path(__file__).resolve().parent.parent
# Five chunks; the two-shard ring gives each shard at least one.  A
# budget of 2 keeps the numpy golden near 2 s a chunk.
LEVELS = "1:2,2:2"
KEYS = [(1, 2, 0, 0)] + [(2, 2, i, j) for i in range(2) for j in range(2)]


def _golden(level, max_iter, i, j):
    """The port's C++ loop, which its tests hold bitwise to the golden."""
    return NativeBackend().compute_batch([Workload(level, max_iter, i,
                                                   j)])[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, proc, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, f"exited {proc.returncode}"
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"nothing listens on port {port}")


class _Shards:
    """Two ``coord`` shards of ``package`` over one data directory, on
    ports picked here and written into one ring JSON first."""

    def __init__(self, package: str, tmp: Path, env_extra=None):
        self.tmp = tmp
        self.ring_path = str(tmp / "ring.json")
        ports = [(_free_port(), _free_port(), _free_port())
                 for _ in range(2)]
        self.ring = HashRing([ShardInfo("127.0.0.1", distributer_port=d,
                                        dataserver_port=s, exporter_port=e)
                              for d, s, e in ports], version=1)
        self.ring.save(self.ring_path)
        env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                   **(env_extra or {}))
        self.procs = []
        for k, (d, s, e) in enumerate(ports):
            log = open(tmp / f"coord{k}.log", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", package, "coord", "--shard",
                 f"{k}/2", "--ring", self.ring_path, "-l", LEVELS, "-o",
                 str(tmp), "--host", "127.0.0.1", "--distributer-port",
                 str(d), "--dataserver-port", str(s), "--exporter-port",
                 str(e), "--stats-period", "0"], cwd=tmp, env=env,
                stdout=log, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL))
            log.close()

    def __enter__(self):
        try:
            for info, proc in zip(self.ring.shards, self.procs):
                _wait_listening(info.exporter_port, proc)
                _wait_listening(info.dataserver_port, proc)
        except BaseException:
            self.stop()
            raise
        return self

    def stop(self) -> list:
        """SIGINT (the clean shutdown), then kill what is left."""
        codes = []
        for proc in self.procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in self.procs:
            try:
                codes.append(proc.wait(timeout=30))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        return codes

    def __exit__(self, *exc):
        self.stop()

    def log(self, k: int) -> str:
        return (self.tmp / f"coord{k}.log").read_text()

    def check_stored(self, timeout: float = 60.0) -> None:
        """Every chunk fetched from its owning shard's data server is the
        golden's (polled: saves land after the upload is accepted)."""
        deadline = time.monotonic() + timeout
        for level, mi, i, j in KEYS:
            owner = self.ring.shards[self.ring.owner(level, i, j)]
            with DataClient("127.0.0.1", owner.dataserver_port) as client:
                while True:
                    pixels, status = client.fetch(level, i, j)
                    if status is FetchStatus.OK \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.1)
            assert status is FetchStatus.OK, (level, i, j)
            assert np.array_equal(pixels, _golden(level, mi, i, j))


def _owned() -> list:
    ring = HashRing.local(2)
    return [sum(ring.owner(level, i, j) == k for level, _, i, j in KEYS)
            for k in range(2)]


def test_both_shards_own_chunks_of_the_test_levels():
    assert sorted(_owned()) == [1, 4]


def test_coord_shards_drained_by_the_ring_worker(tmp_path, capsys):
    """Two port ``coord`` shards drained by the port's ``worker --ring
    --backend native --exporter-port 0``: every chunk on its owner equals
    the golden; ``top --ring --once --json`` lists both shards and the
    worker; ``stats`` reads each shard's ``/varz``; SIGINT stops both
    shards with exit 0."""
    stats_json = tmp_path / "worker.json"
    with _Shards("distributedmandelbrot_tpu_torch", tmp_path) as shards:
        assert cli.main(["worker", "--ring", shards.ring_path, "--backend",
                         "native", "--exporter-port", "0", "--stats-json",
                         str(stats_json), "-q"]) == 0
        out = capsys.readouterr().out
        assert "worker exporter on port" in out
        assert "5 tiles computed, 5 accepted" in out
        shards.check_stored()
        # The worker's span reports reach the shards after its uploads.
        deadline = time.monotonic() + 30
        while True:
            assert cli.main(["top", "--ring", shards.ring_path, "--once",
                             "--json", "--interval", "0.2"]) == 0
            snap = json.loads(capsys.readouterr().out)
            if snap["workers"] or time.monotonic() > deadline:
                break
        assert snap["roles"]["shard"]["healthy"] == 2
        assert sorted(s["shard"] for s in snap["shards"]) == [0, 1]
        assert snap["totals"]["completed"] == 5
        assert len(snap["workers"]) == 1
        for k, info in enumerate(shards.ring.shards):
            assert cli.main(["stats", "--port", str(info.exporter_port)]) \
                == 0
            text = capsys.readouterr().out
            assert f"progress: {_owned()[k]}/5 tiles complete" in text
            assert cli.main(["stats", "--port", str(info.exporter_port),
                             "--json"]) == 0
            varz = json.loads(capsys.readouterr().out)
            assert varz["scheduler"]["completed"] == _owned()[k]
        assert shards.stop() == [0, 0]
    assert "coord shard 0/2: owns" in shards.log(0)
    counters = json.loads(stats_json.read_text())["counters"]
    assert counters["results_accepted"] == 5


def test_port_ring_worker_drains_jax_coord_shards(tmp_path, capsys):
    """The JAX package's ``coord`` shards, drained by the port's ring
    worker (``--backend numpy``); the port's ``top`` reads the JAX
    shards' exporters; the port's ``postmortem`` assembles the flight
    dumps the JAX shards wrote, equal to the JAX package's own
    assembly."""
    flight = tmp_path / "flight"
    flight.mkdir()
    with _Shards("distributedmandelbrot_tpu", tmp_path,
                 {"DMTPU_FLIGHT_DIR": str(flight)}) as shards:
        assert cli.main(["worker", "--ring", shards.ring_path, "--backend",
                         "numpy", "-q"]) == 0
        shards.check_stored()
        capsys.readouterr()
        assert cli.main(["top", "--ring", shards.ring_path, "--once",
                         "--json", "--interval", "0.2"]) == 0
        snap = json.loads(capsys.readouterr().out)
        assert snap["roles"]["shard"]["healthy"] == 2
        assert snap["totals"]["completed"] == 5
        assert shards.stop() == [0, 0]
    out = tmp_path / "pm.json"
    assert cli.main(["postmortem", str(flight), "--json", "--out",
                     str(out)]) == 0
    got = json.loads(out.read_text())
    want = ref_postmortem.assemble(str(flight)).to_dict()
    assert got == json.loads(json.dumps(want))
    assert {p["proc"].split("@")[0] for p in got["processes"]} == {
        "shard-0", "shard-1"}
    assert got["events"] == len(got["timeline"]) > 0
    assert cli.main(["postmortem", str(flight), "--limit", "5"]) == 0
    assert "shard-0" in capsys.readouterr().out


def test_jax_ring_worker_drains_port_coord_shards(tmp_path):
    """The port's ``coord`` shards, drained by the JAX package's ring
    worker (``dmtpu worker --ring --backend native``); the JAX package's
    ``top`` reads the port's shards."""
    with _Shards("distributedmandelbrot_tpu_torch", tmp_path) as shards:
        assert ref_cli.main(["worker", "--ring", shards.ring_path,
                             "--backend", "native", "-q"]) == 0
        shards.check_stored()
        assert ref_cli.main(["top", "--ring", shards.ring_path, "--once",
                             "--no-color", "--interval", "0.2"]) == 0
        assert shards.stop() == [0, 0]


def test_compact_command(tmp_path, capsys):
    """``compact`` rewrites a coordinator's index with one entry per tile
    and sweeps orphan chunk files; the coordinator restarted on it finds
    the level complete.  A sharded store (per-shard index logs) and a
    missing one are refused, with nothing touched."""
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:2")) as co:
        assert cli.main(["worker", "--port", str(co.distributer_port),
                         "--backend", "numpy", "-q"]) == 0
        co.wait_saves_settled(expected_accepted=1)
    orphan = tmp_path / "Data" / "1;0;0.tmp"
    orphan.write_bytes(b"x")
    capsys.readouterr()
    assert cli.main(["compact", "-o", str(tmp_path)]) == 0
    assert "compacted: 1 -> 1 entries, 1 orphan file(s) removed" in \
        capsys.readouterr().out
    assert not orphan.exists()
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:2")) as co:
        assert co.scheduler.is_complete()
    sharded = tmp_path / "sharded"
    (sharded / "Data").mkdir(parents=True)
    (sharded / "Data" / "_index-s0of2.dat").write_bytes(b"")
    (sharded / "Data" / "1;0;0").write_bytes(b"chunk")
    with pytest.raises(SystemExit, match="no tile index"):
        cli.main(["compact", "-o", str(sharded)])
    assert sorted(p.name for p in (sharded / "Data").iterdir()) == [
        "1;0;0", "_index-s0of2.dat"]
    with pytest.raises(SystemExit, match="no tile index"):
        cli.main(["compact", "-o", str(tmp_path / "absent")])


def test_trace_command_empty_farm(tmp_path, capsys):
    """``trace`` against a coordinator with no workers dumps an
    empty-but-valid Chrome trace (coordinator metadata only) and exits
    0 — both to a file and to stdout."""
    out = tmp_path / "trace.json"
    with EmbeddedCoordinator(str(tmp_path / "data"),
                             parse_level_settings("1:12")) as co:
        rc = cli.main(["trace", "--port", str(co.exporter_port),
                       "--out", str(out)])
        assert rc == 0
        assert "wrote" in capsys.readouterr().out
        rc = cli.main(["trace", "--port", str(co.exporter_port)])
        assert rc == 0
        stdout_doc = json.loads(capsys.readouterr().out)
    doc = json.loads(out.read_text())
    assert doc == stdout_doc
    assert isinstance(doc["traceEvents"], list)
    # No workers ran: only metadata rows, every one well-formed.
    assert doc["traceEvents"], "coordinator metadata rows expected"
    for ev in doc["traceEvents"]:
        assert ev["ph"] == "M"
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
    # A dead port is a loud SystemExit, not a traceback.
    with pytest.raises(SystemExit, match="cannot fetch"):
        cli.main(["trace", "--port", "1", "--timeout", "0.5"])


def test_admin_checkpoint_and_stats_refusal(tmp_path, capsys):
    """``admin checkpoint`` writes a durability checkpoint through the
    exporter and prints its stats; an unreachable exporter is a
    SystemExit for ``admin`` and ``stats``."""
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:2")) as co:
        assert cli.main(["worker", "--port", str(co.distributer_port),
                         "--backend", "numpy", "-q"]) == 0
        co.wait_saves_settled(expected_accepted=1)
        capsys.readouterr()
        assert cli.main(["admin", "checkpoint", "--port",
                         str(co.exporter_port)]) == 0
        stats = json.loads(capsys.readouterr().out)
        assert stats["completed"] == 1
    with pytest.raises(SystemExit, match="cannot POST"):
        cli.main(["admin", "checkpoint", "--port", "1", "--timeout", "0.5"])
    with pytest.raises(SystemExit, match="cannot fetch"):
        cli.main(["stats", "--port", "1", "--timeout", "0.5"])


@pytest.mark.parametrize("flags", [
    ["--smoke"], ["--smoke", "--sessions", "4", "--level", "4",
                  "--phases", "steady:40x2"]], ids=["open_loop", "sessions"])
def test_loadgen_smoke(flags, capsys):
    assert cli.main(["loadgen", *flags]) == 0
    assert "smoke ok" in capsys.readouterr().out


def test_loadgen_storm_against_a_replica_fleet(capsys):
    """A real storm: two gateway replicas over one in-memory store,
    driven open-loop over sockets; every arrival settles."""
    assert cli.main(["loadgen", "--phases", "steady:40x1", "--level", "4",
                     "--seed-tiles", "4", "--replicas", "2",
                     "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["requests"] == report["completed"] + report["shed"] + \
        report["unavailable"] + report["errors"]
    assert report["completed"] > 0 and report["errors"] == 0
    assert report["replicas"] == 2
    assert cli.main(["loadgen", "--phases", "bogus"]) == 2


def test_chaos_command_list_and_refusal(capsys):
    assert cli.main(["chaos", "--list"]) == 0
    listed = capsys.readouterr().out
    for name in ("coord-kill", "worker-churn", "storm"):
        assert name in listed
    assert cli.main(["chaos", "no-such-scenario"]) == 2


def test_chaos_smoke_runs_the_port_farm(tmp_path, capsys):
    """``chaos coord-kill --smoke``: the port's shards and numpy workers
    as subprocesses, a shard killed and restarted on schedule, then the
    audit (exactly-once completion, ring ownership, golden parity)."""
    assert cli.main(["chaos", "coord-kill", "--smoke", "--json",
                     "--workdir", str(tmp_path), "-q"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"], report["failures"]
    assert report["tiles_on_disk"] == report["expected_tiles"] == 9
    assert report["kills"] >= 1 and report["restarts"] >= 1
    assert report["parity_failures"] == 0
    assert runner._DRIVER_MODULE == \
        "distributedmandelbrot_tpu_torch.chaos.driver"


@pytest.mark.parametrize("backend", [["--backend", "numpy"],
                                     ["--backend", "torch", "--device",
                                      "cpu", "--dtype", "f64"]],
                         ids=["numpy", "torch_cpu"])
def test_worker_profile_writes_a_chrome_trace(tmp_path, capsys, backend):
    """``worker --profile DIR`` writes a torch.profiler Chrome trace of
    the drain into DIR that loads as JSON."""
    prof = tmp_path / "prof"
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:2")) as co:
        assert cli.main(["worker", "--port", str(co.distributer_port),
                         *backend, "--profile", str(prof), "-q"]) == 0
        co.wait_saves_settled(expected_accepted=1)
    assert "profile trace written to" in capsys.readouterr().out
    (trace,) = prof.glob("worker-*.trace.json")
    doc = json.loads(trace.read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]


def test_profile_of_a_cuda_backend_needs_a_gpu(tmp_path):
    """On a host without a GPU a CUDA device's profile raises; it does not
    quietly profile the CPU only."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(SystemExit, match="without a CUDA device"):
        with cli._profiled(str(tmp_path), ["cuda"]):
            pass
    assert not list(tmp_path.iterdir())


def test_worker_ring_refusals(tmp_path):
    bad = tmp_path / "ring.json"
    bad.write_text("{}")
    with pytest.raises(SystemExit, match="worker:"):
        cli.main(["worker", "--ring", str(bad), "--backend", "numpy"])
    HashRing.local(2).save(str(bad))
    with pytest.raises(SystemExit, match="needs sessions"):
        cli.main(["worker", "--ring", str(bad), "--backend", "numpy",
                  "--no-session"])


def test_worker_takes_the_jax_ring_exporter_and_profile_flags(monkeypatch):
    """``--ring``, ``--exporter-port`` and ``--profile`` with the JAX
    worker's defaults and metavars."""
    import argparse
    ours = {a.dest: a for a in cli._parser()._actions}
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise KeyboardInterrupt

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(KeyboardInterrupt):
        ref_cli.cmd_worker([])
    monkeypatch.undo()
    theirs = {a.dest: a for a in seen[0]._actions}
    for dest in ("ring", "exporter_port", "profile"):
        assert (ours[dest].option_strings, ours[dest].default,
                ours[dest].metavar, ours[dest].type) == \
            (theirs[dest].option_strings, theirs[dest].default,
             theirs[dest].metavar, theirs[dest].type), dest
