"""Chaos scenario runner: kill a live sharded farm and audit the wreckage.

A :class:`Scenario` names a farm shape (N coordinator shards, M numpy
workers, one shared data dir), a kill schedule (SIGKILL
:class:`KillEvent`\\ s plus spawn-time ``DMTPU_CRASHPOINTS`` hard-exit
points), and fault injections (``DMTPU_SLOWPOINTS`` slow persists;
worker deaths double as dropped sessions).  :class:`ChaosRunner` drives
it live — subprocesses via :mod:`.driver`, endpoint table rewritten in
``ring.json`` as shards come back on fresh ephemeral ports — and then
asserts the invariants the control plane sells:

- **exactly once**: the union of the per-shard namespaced indices is
  exactly the level grid — no tile missing, none duplicated within a
  shard log or across two shards (a cross-shard duplicate or an
  in-shard double entry would mean a grant was issued twice across a
  restart);
- **ownership**: every entry in shard ``k``'s index hashes to ``k`` on
  the ring — misrouted uploads never reached the wrong index;
- **parity**: sampled tiles on disk are byte-identical to the numpy
  golden for their ``(level, max_iter)``;
- **bounded blip**: each coordinator restart reaches its first lease
  grant within ``grant_blip_bound`` seconds, measured by polling the
  respawned shard's ``/varz``.

The catalogue in :data:`SCENARIOS` is the ``dmtpu chaos`` surface; the
CI smoke runs the ``coord-kill`` entry with one worker.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Optional

from distributedmandelbrot_tpu_torch.control.ring import (HashRing, ShardInfo,
                                                    shard_namespace)
from distributedmandelbrot_tpu_torch.core.workload import (Workload,
                                                     parse_level_settings)
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

_DRIVER_MODULE = "distributedmandelbrot_tpu_torch.chaos.driver"
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

# The persist-path crash/slow site every disk-shaped scenario targets:
# blob durable, index entry not yet appended (utils/faults.py) — the
# interleaving that forces a regrant after restart.
PERSIST_POINT = "store.after_chunk_write"

_PORT_FILE_TIMEOUT = 30.0
_GRACEFUL_STOP_TIMEOUT = 30.0
_WORKER_RESPAWN_DELAY = 0.4
_VARZ_POLL_PERIOD = 0.2


@dataclass(frozen=True)
class KillEvent:
    """One scheduled SIGKILL: ``target`` (``"coord:K"`` | ``"worker:I"``)
    dies ``at`` seconds into the run, respawns ``restart_after`` later."""

    at: float
    target: str
    restart_after: float = 0.3


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    # Real numpy compute on full 4096^2 tiles runs ~0.8s per max_iter
    # unit per tile — 3:4 keeps a 9-tile farm inside a CI minute while
    # still exercising genuine compute + full-size uploads.
    levels: str = "3:4"
    n_shards: int = 2
    n_workers: int = 2
    kills: tuple = ()
    # Spawn-time hard-exit crashpoints per target, DMTPU_CRASHPOINTS
    # syntax — e.g. {"coord:1": "store.after_chunk_write:2"}.  Applied
    # only to the first life of the target: a respawn must be able to
    # finish the slice, not re-die on the same hit count forever.
    crashpoints: dict = field(default_factory=dict)
    slow_persist: float = 0.0  # seconds injected per persist-path hit
    deadline: float = 240.0
    # Worker respawn churn while a shard is down can stack with a full
    # reconnect cycle before the first post-restart grant lands; the
    # bound asserts "a blip, not an outage", not a latency SLO.
    grant_blip_bound: float = 120.0
    parity_samples: int = 2
    batch_size: int = 2
    window: int = 2
    # Must comfortably cover grant-to-upload latency: a granted tile can
    # queue behind a full pipeline window of ~3s-per-tile numpy compute
    # before its upload lands, and an expired lease means regrant thrash.
    lease_timeout: float = 60.0
    checkpoint_period: float = 0.5


SCENARIOS: dict[str, Scenario] = {s.name: s for s in (
    Scenario(
        name="coord-kill",
        description="SIGKILL one coordinator shard mid-farm; its slice "
                    "must finish after the restart with no duplicates.",
        kills=(KillEvent(2.0, "coord:0"),)),
    Scenario(
        name="coord-crashpoint",
        description="Shard 1 hard-exits between blob write and index "
                    "append (the regrant-forcing interleaving); restart "
                    "must re-complete the torn tile exactly once.",
        crashpoints={"coord:1": PERSIST_POINT + ":2"}),
    Scenario(
        name="worker-churn",
        description="SIGKILL every worker once on a stagger (dropped "
                    "sessions); leases must expire and re-grant cleanly.",
        kills=(KillEvent(1.5, "worker:0"), KillEvent(3.0, "worker:1")),
        lease_timeout=15.0),
    Scenario(
        name="slow-persist",
        description="Every persist sleeps on the blob/index seam while a "
                    "coordinator dies mid-run — widens the torn-write "
                    "window a SIGKILL can land in.",
        slow_persist=0.05,
        kills=(KillEvent(2.5, "coord:0"),)),
    Scenario(
        name="storm",
        description="Both shards and a worker die on a spot-preemption "
                    "schedule under slowed persists.",
        kills=(KillEvent(2.0, "coord:0"), KillEvent(3.5, "worker:0"),
               KillEvent(6.0, "coord:1")),
        slow_persist=0.02,
        deadline=360.0),
)}


@dataclass
class ChaosReport:
    scenario: str
    ok: bool
    duration_s: float
    expected_tiles: int
    tiles_on_disk: int
    duplicate_entries: int
    misowned_entries: int
    parity_checked: int
    parity_failures: int
    kills: int
    restarts: int
    # One sample per measured coordinator restart: seconds from respawn
    # to that shard's first lease grant (its /varz workloads_granted).
    restart_to_first_grant_s: list = field(default_factory=list)
    failures: list = field(default_factory=list)
    # Fleet snapshot (obs/fleet.py) scraped from the live shards just
    # before graceful teardown — the per-shard/per-worker rates a chaos
    # postmortem wants next to the invariant verdicts.
    fleet: dict = field(default_factory=dict)
    # Flight-recorder postmortem summary (obs/postmortem.py), assembled
    # from the fleet's crash dumps when the scenario FAILED — which
    # process died holding which leases, and what the anomaly detectors
    # flagged.  Empty on success (the dumps stay on disk either way).
    postmortem: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1,
                          sort_keys=True)


class _Slot:
    """Bookkeeping for one managed subprocess (a shard or a worker)."""

    def __init__(self, role: str, index: int) -> None:
        self.role = role
        self.index = index
        self.proc: Optional[subprocess.Popen] = None
        self.info: Optional[dict] = None  # shard port-file payload
        self.respawn_at: Optional[float] = None  # monotonic
        self.waiting_port = False
        self.spawned_at = 0.0
        self.measure_from: Optional[float] = None  # blip measurement
        self.last_varz_poll = 0.0
        self.lives = 0

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ChaosRunner:
    """Run one :class:`Scenario` against a throwaway data dir.

    ``workdir=None`` uses a temp dir removed afterwards; pass a path to
    keep the farm state (per-process logs land next to the data dir
    either way, as ``coord-K.log`` / ``worker-I.log``).
    """

    def __init__(self, scenario: Scenario, *,
                 workdir: Optional[str] = None,
                 counters: Optional[Counters] = None,
                 log: Optional[Callable[[str], None]] = None) -> None:
        self.scenario = scenario
        self.workdir = workdir
        self.counters = counters if counters is not None else Counters()
        self._log = log if log is not None else (lambda msg: None)
        self.settings = parse_level_settings(scenario.levels)
        self.expected = {(s.level, i, j) for s in self.settings
                         for i in range(s.level) for j in range(s.level)}
        # Ownership is a pure function of N — no endpoints needed.
        self.ring = HashRing.local(scenario.n_shards)
        self.owned_expected = [
            {k for k in self.expected if self.ring.owner_of(k) == shard}
            for shard in range(scenario.n_shards)]
        for ev in scenario.kills:
            self._parse_target(ev.target)  # validate early
        for target in scenario.crashpoints:
            role, _ = self._parse_target(target)
            if role != "coord":
                raise ValueError(
                    f"crashpoints target coordinators, got {target!r}")
        self.coords = [_Slot("coord", k) for k in range(scenario.n_shards)]
        self.workers = [_Slot("worker", i)
                        for i in range(scenario.n_workers)]
        self.kill_count = 0
        self.restart_count = 0
        self.blips: list[float] = []
        self.failures: list[str] = []
        self._stores: dict[int, object] = {}
        self._last_scan: set = set()

    # -- target / process plumbing ----------------------------------------

    def _parse_target(self, target: str) -> tuple[str, int]:
        role, _, idx_s = target.partition(":")
        try:
            idx = int(idx_s)
        except ValueError:
            raise ValueError(f"bad kill target {target!r}") from None
        if role == "coord":
            bound = self.scenario.n_shards
        elif role == "worker":
            bound = self.scenario.n_workers
        else:
            raise ValueError(f"bad kill target {target!r}")
        if not 0 <= idx < bound:
            raise ValueError(f"kill target {target!r} outside farm "
                             f"({bound} {role}s)")
        return role, idx

    def _slot(self, target: str) -> _Slot:
        role, idx = self._parse_target(target)
        return (self.coords if role == "coord" else self.workers)[idx]

    def _base_env(self) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep \
            + env.get("PYTHONPATH", "")
        env.setdefault("JAX_PLATFORMS", "cpu")
        # Every child keeps a black box; a fast autoflush cadence is
        # what makes SIGKILL evidence land (no exit hook ever runs).
        env.setdefault("DMTPU_FLIGHT_DIR", self.flight_dir)
        env.setdefault("DMTPU_FLIGHT_PERIOD", "0.2")
        if self.scenario.slow_persist > 0:
            env["DMTPU_SLOWPOINTS"] = \
                f"{PERSIST_POINT}:{self.scenario.slow_persist}"
        return env

    def _open_log(self, slot: _Slot):
        path = os.path.join(self.root, f"{slot.role}-{slot.index}.log")
        return open(path, "ab")

    def _port_file(self, shard: int) -> str:
        return os.path.join(self.root, f"ports-{shard}.json")

    def _spawn_coord(self, slot: _Slot) -> None:
        sc = self.scenario
        env = self._base_env()
        crash = sc.crashpoints.get(f"coord:{slot.index}")
        if crash and slot.lives == 0:
            env["DMTPU_CRASHPOINTS"] = crash
        port_file = self._port_file(slot.index)
        if os.path.exists(port_file):
            os.unlink(port_file)  # stale ports from the previous life
        cmd = [sys.executable, "-m", _DRIVER_MODULE, "shard",
               self.parent_dir, port_file, sc.levels,
               str(slot.index), str(sc.n_shards),
               "--lease-timeout", str(sc.lease_timeout),
               "--checkpoint-period", str(sc.checkpoint_period)]
        with self._open_log(slot) as logf:
            slot.proc = subprocess.Popen(cmd, env=env, stdout=logf,
                                         stderr=logf)
        slot.lives += 1
        slot.spawned_at = time.monotonic()
        slot.waiting_port = True
        slot.respawn_at = None
        slot.info = None

    def _spawn_worker(self, slot: _Slot) -> None:
        sc = self.scenario
        cmd = [sys.executable, "-m", _DRIVER_MODULE, "worker",
               self.ring_path,
               "--batch-size", str(sc.batch_size),
               "--window", str(sc.window)]
        with self._open_log(slot) as logf:
            slot.proc = subprocess.Popen(cmd, env=self._base_env(),
                                         stdout=logf, stderr=logf)
        slot.lives += 1
        slot.spawned_at = time.monotonic()
        slot.respawn_at = None

    def _write_ring(self) -> None:
        infos = []
        for slot in self.coords:
            info = slot.info or {}
            infos.append(ShardInfo("127.0.0.1",
                                   distributer_port=info.get(
                                       "distributer", 0),
                                   dataserver_port=info.get(
                                       "dataserver", 0),
                                   exporter_port=info.get(
                                       "exporter", 0)))
        HashRing(infos, version=1).save(self.ring_path)

    # -- observation -------------------------------------------------------

    def _store(self, shard: int):
        store = self._stores.get(shard)
        if store is None:
            from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
            store = ChunkStore(
                self.parent_dir,
                namespace=shard_namespace(shard, self.scenario.n_shards))
            self._stores[shard] = store
        return store

    def _scan_keys(self) -> set:
        """Union of completed keys across every shard's namespaced index.

        Tolerant of mid-append reads (live coordinators): a scan that
        fails keeps the previous observation — the final invariant read
        happens only after a graceful drain.
        """
        keys: set = set()
        try:
            for shard in range(self.scenario.n_shards):
                for entry in self._store(shard).entries():
                    keys.add(entry.key)
        except Exception:
            return self._last_scan
        self._last_scan = keys
        return keys

    def _varz(self, slot: _Slot) -> Optional[dict]:
        info = slot.info or {}
        port = info.get("exporter")
        if not port:
            return None
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/varz", timeout=0.5) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None

    def _capture_postmortem(self) -> dict:
        """Assemble the fleet's flight dumps into a postmortem summary
        for a FAILED scenario report.  Best-effort like the fleet
        snapshot: a postmortem that cannot assemble must not mask the
        invariant verdict it was meant to explain."""
        from distributedmandelbrot_tpu_torch.obs import postmortem
        try:
            pm = postmortem.assemble(self.flight_dir,
                                     registry=self.counters.registry)
            summary = pm.summary()
            summary["dump_dir"] = self.flight_dir
            return summary
        except Exception as e:
            self._log(f"postmortem assembly failed: {e!r}")
            return {}

    def _capture_fleet(self) -> dict:
        """A fleet snapshot (obs/fleet.py) over the still-live shards.

        Best-effort by design: the scenario verdict rests on the
        invariant audit, and a dead exporter at teardown time is a
        normal chaos outcome, not a reason to fail the report.  Two
        scrape rounds a beat apart give the aggregator the pair of
        samples it needs for rates.
        """
        from distributedmandelbrot_tpu_torch.obs.fleet import FleetAggregator
        peers = []
        for slot in self.coords:
            port = (slot.info or {}).get("exporter")
            if slot.alive and port:
                peers.append(f"shard@127.0.0.1:{port}")
        if not peers:
            return {}
        try:
            agg = FleetAggregator(peers, timeout=1.0)
            agg.scrape_once()
            time.sleep(0.25)
            agg.scrape_once()
            return agg.snapshot()
        except Exception as e:
            self._log(f"fleet snapshot failed: {e!r}")
            return {}

    @staticmethod
    def _granted(varz: dict) -> int:
        name = obs_names.COORD_WORKLOADS_GRANTED
        total = 0
        for label, value in varz.get("counters", {}).items():
            if label == name or label.startswith(name + "{"):
                total += int(value)
        return total

    # -- the live loop -----------------------------------------------------

    def _fire_kill(self, ev: KillEvent) -> None:
        slot = self._slot(ev.target)
        if not slot.alive:
            self._log(f"kill {ev.target}: already dead, skipped")
            return
        slot.proc.kill()  # SIGKILL: no drain, flocks released by kernel
        slot.proc.wait()
        slot.respawn_at = time.monotonic() + ev.restart_after
        self.kill_count += 1
        self.counters.inc(obs_names.CHAOS_KILLS)
        self._log(f"killed {ev.target} (SIGKILL) at t="
                  f"{time.monotonic() - self.t0:.1f}s")

    def _monitor_coord(self, slot: _Slot) -> None:
        now = time.monotonic()
        if slot.proc is not None and not slot.alive \
                and slot.respawn_at is None:
            # Died without a scheduled SIGKILL: a crashpoint hard-exit
            # (code 86) is scenario-inflicted; anything else is a bug in
            # the thing under test, surfaced as an invariant failure —
            # but restart either way so the farm can still drain.
            code = slot.proc.returncode
            if code == 86:
                self.kill_count += 1
                self.counters.inc(obs_names.CHAOS_KILLS)
                self._log(f"coord:{slot.index} crashpoint hard-exit")
            else:
                self.failures.append(
                    f"coord:{slot.index} died unexpectedly "
                    f"(exit {code}); see coord-{slot.index}.log")
                self._log(f"coord:{slot.index} died (exit {code})")
            slot.respawn_at = now + 0.3
        if slot.respawn_at is not None and now >= slot.respawn_at:
            self._spawn_coord(slot)
            self._log(f"respawned coord:{slot.index}")
        if slot.waiting_port and slot.alive:
            port_file = self._port_file(slot.index)
            if os.path.exists(port_file):
                with open(port_file, "r", encoding="utf-8") as f:
                    slot.info = json.load(f)
                slot.waiting_port = False
                self._write_ring()  # fresh ephemeral ports for workers
                if slot.lives > 1:
                    self.restart_count += 1
                    self.counters.inc(obs_names.CHAOS_RESTARTS)
                    slot.measure_from = slot.spawned_at
        if slot.measure_from is not None and slot.alive \
                and now - slot.last_varz_poll >= _VARZ_POLL_PERIOD:
            slot.last_varz_poll = now
            varz = self._varz(slot)
            if varz is not None and self._granted(varz) > 0:
                blip = now - slot.measure_from
                self.blips.append(round(blip, 3))
                slot.measure_from = None
                self._log(f"coord:{slot.index} first grant "
                          f"{blip:.2f}s after respawn")
            elif self.owned_expected[slot.index] <= self._last_scan:
                # Slice already complete on disk: nothing left to grant,
                # so there is no blip to measure for this restart.
                slot.measure_from = None

    def _monitor_worker(self, slot: _Slot) -> None:
        now = time.monotonic()
        if slot.proc is not None and not slot.alive \
                and slot.respawn_at is None:
            # Unscheduled worker death = a dropped session (the lease
            # sweeper's problem, not ours) — respawn with a small delay
            # so a down shard can come back before the retry storm.
            slot.respawn_at = now + _WORKER_RESPAWN_DELAY
            self._log(f"worker:{slot.index} died "
                      f"(exit {slot.proc.returncode}); respawning")
        if slot.respawn_at is not None and now >= slot.respawn_at:
            self._spawn_worker(slot)
            self.restart_count += 1
            self.counters.inc(obs_names.CHAOS_RESTARTS)

    # -- lifecycle ---------------------------------------------------------

    def run(self) -> ChaosReport:
        tmp = None
        if self.workdir is None:
            tmp = tempfile.TemporaryDirectory(prefix="dmtpu-chaos-")
            root = tmp.name
        else:
            root = self.workdir
            os.makedirs(root, exist_ok=True)
        try:
            return self._run(root)
        finally:
            self._kill_everything()
            if tmp is not None:
                tmp.cleanup()

    def _run(self, root: str) -> ChaosReport:
        sc = self.scenario
        self.root = root
        self.parent_dir = os.path.join(root, "farm")
        os.makedirs(self.parent_dir, exist_ok=True)
        self.flight_dir = os.path.join(root, "flight")
        os.makedirs(self.flight_dir, exist_ok=True)
        self.ring_path = os.path.join(root, "ring.json")
        self.t0 = time.monotonic()
        self._log(f"scenario {sc.name}: {sc.n_shards} shards, "
                  f"{sc.n_workers} workers, levels {sc.levels}, "
                  f"{len(self.expected)} tiles")

        for slot in self.coords:
            self._spawn_coord(slot)
        port_deadline = time.monotonic() + _PORT_FILE_TIMEOUT
        for slot in self.coords:
            port_file = self._port_file(slot.index)
            while not os.path.exists(port_file):
                if time.monotonic() > port_deadline:
                    raise RuntimeError(
                        f"coord:{slot.index} never wrote its port file")
                if not slot.alive:
                    raise RuntimeError(
                        f"coord:{slot.index} died during startup "
                        f"(exit {slot.proc.returncode}); see "
                        f"coord-{slot.index}.log")
                time.sleep(0.05)
            with open(port_file, "r", encoding="utf-8") as f:
                slot.info = json.load(f)
            slot.waiting_port = False
        self._write_ring()
        for slot in self.workers:
            self._spawn_worker(slot)

        pending = sorted(sc.kills, key=lambda ev: ev.at)
        deadline = self.t0 + sc.deadline
        completed = False
        while time.monotonic() < deadline:
            now_rel = time.monotonic() - self.t0
            while pending and pending[0].at <= now_rel:
                self._fire_kill(pending.pop(0))
            for slot in self.coords:
                self._monitor_coord(slot)
            for slot in self.workers:
                self._monitor_worker(slot)
            if self.expected <= self._scan_keys():
                completed = True
                break
            time.sleep(0.1)
        if not completed:
            self.failures.append(
                f"deadline: {len(self._last_scan & self.expected)}/"
                f"{len(self.expected)} tiles after {sc.deadline:.0f}s")

        fleet_snapshot = self._capture_fleet()
        self._stop_workers()
        self._stop_coords()
        self._check_invariants()
        self.counters.inc(obs_names.CHAOS_INVARIANT_FAILURES,
                          len(self.failures))
        report = ChaosReport(
            scenario=sc.name,
            ok=not self.failures,
            duration_s=round(time.monotonic() - self.t0, 2),
            expected_tiles=len(self.expected),
            tiles_on_disk=self._tiles_on_disk,
            duplicate_entries=self._duplicates,
            misowned_entries=self._misowned,
            parity_checked=self._parity_checked,
            parity_failures=self._parity_failures,
            kills=self.kill_count,
            restarts=self.restart_count,
            restart_to_first_grant_s=self.blips,
            failures=list(self.failures),
            fleet=fleet_snapshot,
            postmortem=self._capture_postmortem()
            if self.failures else {})
        self._log(f"scenario {sc.name}: "
                  f"{'OK' if report.ok else 'FAILED'} in "
                  f"{report.duration_s:.1f}s ({report.kills} kills, "
                  f"{report.restarts} restarts)")
        return report

    def _stop_workers(self) -> None:
        for slot in self.workers:
            if slot.alive:
                slot.proc.kill()  # stateless: nothing to drain
            if slot.proc is not None:
                slot.proc.wait()
            slot.respawn_at = None

    def _stop_coords(self) -> None:
        # SIGTERM is the driver's graceful path: stop() drains in-flight
        # persists, so the invariant read below sees a settled index.
        for slot in self.coords:
            if slot.alive:
                slot.proc.terminate()
        deadline = time.monotonic() + _GRACEFUL_STOP_TIMEOUT
        for slot in self.coords:
            if slot.proc is None:
                continue
            try:
                slot.proc.wait(timeout=max(0.1,
                                           deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.failures.append(
                    f"coord:{slot.index} ignored SIGTERM for "
                    f"{_GRACEFUL_STOP_TIMEOUT:.0f}s (drain hang)")
                slot.proc.kill()
                slot.proc.wait()
            slot.respawn_at = None

    def _kill_everything(self) -> None:
        for slot in self.coords + self.workers:
            if slot.alive:
                slot.proc.kill()
                slot.proc.wait()

    # -- invariants --------------------------------------------------------

    def _check_invariants(self) -> None:
        sc = self.scenario
        per_shard: dict[int, list] = {}
        for shard in range(sc.n_shards):
            try:
                per_shard[shard] = [e.key for e in
                                    self._store(shard).entries()]
            except Exception as e:
                self.failures.append(
                    f"shard {shard}: index unreadable after drain: {e}")
                per_shard[shard] = []

        self._duplicates = 0
        self._misowned = 0
        owners_by_key: dict = collections.defaultdict(set)
        union: set = set()
        for shard, keys in per_shard.items():
            counts = collections.Counter(keys)
            in_shard_dups = sum(n - 1 for n in counts.values())
            if in_shard_dups:
                self._duplicates += in_shard_dups
                self.failures.append(
                    f"shard {shard}: {in_shard_dups} duplicate index "
                    f"entries (a grant was issued twice)")
            misowned = sorted(k for k in counts
                              if self.ring.owner_of(k) != shard)
            if misowned:
                self._misowned += len(misowned)
                self.failures.append(
                    f"shard {shard}: {len(misowned)} entries it does "
                    f"not own (first: {misowned[0]})")
            for k in counts:
                owners_by_key[k].add(shard)
                union.add(k)
        cross = sorted(k for k, owners in owners_by_key.items()
                       if len(owners) > 1)
        if cross:
            self._duplicates += len(cross)
            self.failures.append(
                f"{len(cross)} tiles present in multiple shard indices "
                f"(first: {cross[0]})")
        unexpected = sorted(union - self.expected)
        if unexpected:
            self.failures.append(
                f"{len(unexpected)} tiles outside the level grid "
                f"(first: {unexpected[0]})")
        missing = sorted(self.expected - union)
        if missing:
            self.failures.append(
                f"{len(missing)} tiles never completed "
                f"(first: {missing[0]})")
        self._tiles_on_disk = len(union & self.expected)

        for blip in self.blips:
            if blip > sc.grant_blip_bound:
                self.failures.append(
                    f"restart-to-first-grant {blip:.2f}s exceeds the "
                    f"{sc.grant_blip_bound:.0f}s bound")

        self._parity_checked = 0
        self._parity_failures = 0
        if sc.parity_samples > 0 and union:
            self._check_parity(sorted(union & self.expected)
                               [:sc.parity_samples])

    def _check_parity(self, keys: list) -> None:
        import numpy as np

        from distributedmandelbrot_tpu_torch.worker.backends import NumpyBackend
        max_iter_by_level = {s.level: s.max_iter for s in self.settings}
        backend = NumpyBackend()
        for level, ir, ii in keys:
            shard = self.ring.owner_of((level, ir, ii))
            chunk = self._store(shard).load(level, ir, ii)
            if chunk is None:
                self.failures.append(
                    f"parity: tile ({level},{ir},{ii}) in index but "
                    f"unloadable from shard {shard}")
                self._parity_failures += 1
                continue
            golden = backend.compute_batch(
                [Workload(level, max_iter_by_level[level], ir, ii)])[0]
            self._parity_checked += 1
            if not np.array_equal(np.asarray(chunk.data).ravel(), golden):
                self._parity_failures += 1
                self.failures.append(
                    f"parity: tile ({level},{ir},{ii}) differs from the "
                    f"numpy golden")


def run_scenario(name: str, **overrides) -> ChaosReport:
    """Run one catalogue scenario, with field overrides (CLI surface)."""
    try:
        scenario = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; have: "
            f"{', '.join(sorted(SCENARIOS))}") from None
    run_kwargs = {k: overrides.pop(k)
                  for k in ("workdir", "counters", "log")
                  if k in overrides}
    if overrides:
        scenario = dataclasses.replace(scenario, **overrides)
    return ChaosRunner(scenario, **run_kwargs).run()
