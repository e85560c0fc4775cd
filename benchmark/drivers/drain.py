"""Drain traffic: one worker computes the configuration's chunk profile
pass after pass in a closed loop, for the window, its grants from an
in-process source (no wire, no codec, no store), the seed rotating
where the first pass starts.

Traffic keys:

- ``warmup_levels``: the short drain that set-up makes, after one K1
  and one K2 launch at full size.
- ``check``: chunks the check recomputes, by level, drawn from the seed
  before the window among the chunks that need real work: a mean of at
  least ``check_floor_steps`` steps a pixel by the configuration's step
  table (every chunk where it has none).  The source keeps a copy of
  each drawn chunk the first time it comes back, and nothing else.

A chunk counts when the source has it back within the window.  Its
latency runs from its grant leaving the source to its return.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque

import numpy as np

from benchmark.harness import chip, roofline
from benchmark.harness.common import (Record, check, hist_delta,
                                      hist_totals, seeded)
from benchmark.harness.trace import Profiler
from benchmark.reference import escape as reference

WORKER_HISTS = ("worker_backend_phase_seconds",)


def profile_keys(levels: str) -> list[tuple[int, int, int, int]]:
    """(level, max_iter, index_real, index_imag) in the coordinator's
    grant order: level settings in order, index_real outer."""
    out = []
    for part in levels.split(","):
        level, max_iter = (int(v) for v in part.split(":"))
        out += [(level, max_iter, i, j) for i in range(level)
                for j in range(level)]
    return out


def _key4(w) -> tuple[int, int, int, int]:
    return (w.level, w.max_iter, w.index_real, w.index_imag)


class GrantSource:
    """In-process coordinator surface for the worker (``request``,
    ``request_batch``, ``submit``, ``submit_batch``; no host, so no
    sessions): the profile pass after pass from ``start``, until closed
    or ``limit`` grants are out.  Times each chunk from its grant to its
    return (``done``: key, grant time, return time), and keeps a copy of
    the pixels of the chunks in ``keep`` the first time each comes back
    (the program's buffer goes back to it).  A window wider than the
    profile holds one key more than once; its returns pair with its
    grants in order."""

    def __init__(self, keys, start: int, Workload, keep=(),
                 limit: int | None = None):
        self._order = [Workload(*k) for k in keys[start:] + keys[:start]]
        self._limit = limit
        self._pos = 0
        self._lock = threading.Lock()
        self._keep = set(keep)
        self._granted: dict = defaultdict(deque)
        self.kept: dict = {}
        self.done: list = []
        self.closed = threading.Event()

    def _take(self, n: int):
        with self._lock:
            if self.closed.is_set():
                return []
            if self._limit is not None:
                n = min(n, self._limit - self._pos)
            got = [self._order[(self._pos + i) % len(self._order)]
                   for i in range(max(0, n))]
            self._pos += len(got)
            t = time.monotonic()
            for w in got:
                self._granted[w.key].append(t)
        return got

    def request(self):
        got = self._take(1)
        return got[0] if got else None

    def request_batch(self, max_count: int):
        return self._take(max_count)

    def submit(self, workload, pixels) -> bool:
        return self.submit_batch([(workload, pixels)])[0]

    def submit_batch(self, results):
        t = time.monotonic()
        with self._lock:
            for w, px in results:
                k = _key4(w)
                self.done.append((k, self._granted[w.key].popleft(), t))
                if k in self._keep and k not in self.kept:
                    self.kept[k] = np.array(px, copy=True).reshape(-1)
        return [True] * len(results)


class ReferenceBackend:
    """The control: the plain reference in a lower precision, put in the
    program's place as the worker's backend."""

    def __init__(self, dtype, device) -> None:
        self.dtype, self.device = dtype, device

    def compute_batch(self, workloads):
        return [reference.chunk_bytes(w.level, w.max_iter, w.index_real,
                                      w.index_imag, device=self.device,
                                      dtype=self.dtype)
                for w in workloads]


def checked_keys(rng, keys, per_level: dict, steps: dict | None,
                 floor_steps: float) -> list:
    """The chunks the check recomputes: ``per_level`` of each level, drawn
    among those whose mean steps a pixel reach ``floor_steps`` by the
    step table (all of the level's chunks without one)."""
    out = []
    for level, n in per_level.items():
        pool = [k for k in keys if k[0] == int(level)
                and (steps is None or steps[":".join(map(str, k))]
                     >= floor_steps * reference.CHUNK_WIDTH ** 2)]
        out += rng.sample(pool, min(int(n), len(pool)))
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", control: bool = False) -> Record:
    import torch

    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.utils.metrics import Counters
    from distributedmandelbrot_tpu_torch.worker import Worker
    from distributedmandelbrot_tpu_torch.worker.backends import CudaBackend

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    keys = profile_keys(cfg["levels"])
    settings = dict(cfg["worker"])
    counters = Counters()
    backend = (ReferenceBackend(torch.bfloat16, dev) if control
               else CudaBackend(device=device))
    steps = _steps_table(cell)

    # Set-up: one K1 and one K2 launch at full size, then a short drain
    # of its own.
    if not control:
        w1, w2 = (Workload(*k) for k in keys[:2])
        backend.materialize_tile(backend.dispatch_tile(w1))
        for h in backend.dispatch_many([w1, w2]):
            backend.materialize_tile(h)
    warm_keys = profile_keys(traffic["warmup_levels"])
    Worker(GrantSource(warm_keys, 0, Workload, limit=len(warm_keys)),
           backend, counters=counters, **settings).run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # The window.
    rng = seeded(seed, "drain")
    start = rng.randrange(len(keys))
    chosen = checked_keys(rng, keys, traffic["check"], steps,
                          traffic["check_floor_steps"])
    source = GrantSource(keys, start, Workload, keep=chosen)
    prof = Profiler(trace, seconds)
    setup_s = time.monotonic() - t_process
    with prof:
        with prof.window():
            start_hists = {n: hist_totals(counters.registry, n)
                           for n in WORKER_HISTS}
            t0 = time.monotonic()
            timer = threading.Timer(seconds, source.closed.set)
            timer.start()
            worker = Worker(source, backend, counters=counters, **settings)
            worker.run_until_drained()
            timer.join()
            end_hists = {n: hist_totals(counters.registry, n)
                         for n in WORKER_HISTS}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    deadline = t0 + seconds
    device_rec = chip.device_record(cell.chips, dev)
    done = [d for d in source.done if d[2] <= deadline]
    bound_s = None
    if steps is not None:
        bound_s = sum(roofline.chunk_bound_s(steps[":".join(map(str, d[0]))])
                      for d in done)
    fusion = worker.pipeline.stage_stats()["fusion"]
    del backend, worker
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, once the window has closed.
    differing = missing = 0
    for k in chosen:
        got = source.kept.get(k)
        if got is None:
            missing += 1
            continue
        want = reference.chunk_bytes(*k, device=dev)
        differing += (int((got != want).sum()) if got.shape == want.shape
                      else want.size)
    limits = cfg["limits"]
    checks = {
        "bytes_differing": check(differing, limits["bytes_differing"]),
        "sampled_chunks_missing": check(missing + (0 if chosen else 1),
                                        limits["sampled_chunks_missing"]),
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return Record(
        correct=correct, attempted=len(done), failed=0, device=device_rec,
        checks=checks, setup_s=setup_s, window_s=seconds,
        latencies_s=[d[2] - d[1] for d in done], kind="drain",
        done=len(done),
        hists={n: hist_delta(end_hists, start_hists, n)
               for n in WORKER_HISTS},
        fusion={"tiles": fusion["tiles"], "launches": fusion["launches"]},
        bound_s=bound_s, trace=prof.trace, checked=len(chosen))


def _steps_table(cell) -> dict | None:
    path = cell.config.get("steps_table")
    if not path or not cell.path(path).is_file():
        return None
    with open(cell.path(path), encoding="utf-8") as fh:
        return json.load(fh)["steps"]
