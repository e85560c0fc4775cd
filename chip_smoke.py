#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``distributedmandelbrot_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100 for the ``sm_90a`` kernels) and the CUDA
toolkit's ``nvcc``; builds the kernels from ``ops/csrc`` on first use.
Imports nothing of JAX or of the JAX package.  Each phase prints one
JSON line; any failure raises and the script exits non-zero.

1. device: card name, count, power limit; kernel build time; registers
   and spills per kernel (``nvcc -Xptxas -v``).
2. kernel_vs_plain: every kernel against its plain PyTorch version on
   CUDA tensors, bitwise (pixels, the bf16 census, and the smooth values
   compared as bits): K1 (``escape_tile``) and K2 (``escape_mega``) on
   128^2 views and full 4096^2 chunks at budgets 256, 1024 and 2000
   (cycle probe armed), fused K2 at k = 2 and 4 with mixed budgets
   against K1 per tile; K1's Julia, Multibrot-3 and Burning-Ship modes,
   K4 (``escape_smooth``) in every mode and K5 (``escape_pack``, n = 2
   and 4, mixed budgets, every mode, each plane also against K1) on the
   128^2 views and one 4096^2 view per kernel.
3. golden: the all-escaping sky chunk bitwise against the numpy golden
   at 4096^2; bulb and seahorse chunks at 512^2 through the backend's
   fused route (proven-interior pixels bitwise, <= 2% off-mask).
4. main_path: the port's pipelined ``Worker`` with ``CudaBackend``
   (depth 2, window 4) drains level 4 at budget 256 and level 10 at
   budget 1024 (116 full chunks) from an in-process grant source; every
   chunk is recomputed with K1 and compared by checksum, four sampled
   chunks bitwise against the plain version.
5. main_path_profile: the same drain under torch.profiler, for the
   device time by kernel and the card's busy share.
6. render_path: ``python -m distributedmandelbrot_tpu_torch render``
   (``cli.main``, in process) at 4096^2, one view per mode: Mandelbrot,
   Julia, Multibrot-3 and Burning Ship, integer (K1) and ``--smooth
   --dtype f32`` (K4), and ``--supersample`` 4 and 2 (K5).  Each render
   must launch its kernel once and no other, with no decline to the
   torch loop; its PNG must equal, byte for byte, the PNG of the plain
   versions' planes through the same colormap.
7. kernels: per kernel, its launches on the paths above and its median
   time by CUDA events at 4096^2 beside the plain version's and the
   bound (the larger of its f32 operations over the non-FMA f32 rate
   and its output bytes over the memory rate); K1 per mode, and K5
   beside four K1 launches on the same windows.

The second-to-last line is ``nvidia-smi``'s name and power limit, the
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): 67 TFLOP/s f32
# outside the tensor cores counts an FMA as two operations; the kernels
# issue no FMA, so one operation per instruction: half of it.
F32_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
# Uncontracted f32 operations per escape step: 3 multiplies (cross,
# zr^2, zi^2), 5 adds/subtracts (zr+zr, +ci, zr2-zi2, +cr, |z|^2).
OPS_PER_STEP = 8
# The smooth epilogue per escaped pixel: |z|^2 (3), log, division,
# log2, the subtraction from n + 2 (one each).
SMOOTH_EPILOGUE_OPS = 7

KERNEL_SOURCE = "distributedmandelbrot_tpu_torch/ops/csrc/escape_kernels.cu"
REPLACES = {
    "escape_tile": "distributedmandelbrot_tpu/ops/pallas_escape.py:164",
    "escape_mega": "distributedmandelbrot_tpu/ops/pallas_escape.py:638",
    "escape_smooth": "distributedmandelbrot_tpu/ops/pallas_escape.py:1211",
    "escape_pack": "distributedmandelbrot_tpu/ops/pallas_escape.py:951",
}
JULIA_C = complex(-0.8, 0.156)
# K1's modes, as wrapper keywords.
MODES = {"mandelbrot": {}, "julia": {"julia_c": JULIA_C},
         "multibrot3": {"power": 3}, "ship": {"burning": True}}
# The supersampled render's subpixel offsets (cli._SS_OFFSETS).
SS4 = ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25))


def ops_per_step(kw: dict) -> int:
    """Uncontracted f32 operations per step of a mode: 8 at degree 2,
    one more for the Burning Ship's abs, 6d - 1 at degree d > 2 (d - 1
    complex products of 6, the two adds of c, |z|^2's three)."""
    if kw.get("burning"):
        return OPS_PER_STEP + 1
    d = kw.get("power", 2)
    return OPS_PER_STEP if d == 2 else 6 * d - 1
NO_LIBRARY = ("no single PyTorch call computes an escape-time plane; the "
              "plain version is a loop of elementwise ops")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` timings of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def max_abs_err(a, b):
    if a.is_floating_point():
        return float((a - b).abs().max())
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())


def bit_diff(a, b) -> tuple[int, int]:
    """(elements that differ, largest difference): in units in the last
    place for f32 (the bits compared as integers), in values otherwise."""
    if a.dtype == torch.float32:
        d = (a.view(torch.int32).to(torch.int64)
             - b.view(torch.int32).to(torch.int64)).abs()
    else:
        d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def plain_tile(ce, spec, mi, kw, dev, cycle_budget=None):
    """K1's plain version for a wrapper call ``(spec, mi, **kw)`` (the
    probe resolved from ``cycle_budget``, the pack's deepest budget)."""
    return ce.escape_tile_plain(
        ce._params_row(spec, kw.get("julia_c")), mi, spec.height,
        spec.width, cycle_check=ce.escape_time.resolve_cycle_check(
            None, cycle_budget or mi),
        power=kw.get("power", 2), burning=kw.get("burning", False),
        device=dev)


def plain_smooth(ce, spec, mi, kw, dev, return_steps=False):
    return ce.escape_smooth_plain(
        ce._params_row(spec, kw.get("julia_c")), mi, spec.height,
        spec.width, cycle_check=ce.escape_time.resolve_cycle_check(None, mi),
        power=kw.get("power", 2), burning=kw.get("burning", False),
        device=dev, return_steps=return_steps)


def plain_pack(ce, specs, mis, kw, dev, return_steps=False):
    rows = np.asarray([ce._params_row(s, kw.get("julia_c")) for s in specs],
                      dtype=np.float32)
    return ce.escape_pack_plain(
        rows, mis, height=specs[0].height, width=specs[0].width,
        cycle_check=ce.escape_time.resolve_cycle_check(None, max(mis)),
        power=kw.get("power", 2), burning=kw.get("burning", False),
        device=dev, return_steps=return_steps)


def pack_call(ce, specs, mis, kw, dev):
    jc = kw.get("julia_c")
    return ce.compute_tiles_packed_cuda(
        specs, mis, power=kw.get("power", 2),
        burning=kw.get("burning", False),
        julia_cs=[jc] * len(specs) if jc is not None else None, device=dev)


def shifted(spec, dx: float, dy: float):
    """``spec`` moved by (dx, dy) pixel pitches: a supersample window."""
    pr = spec.range_real / (spec.width - 1)
    pi = spec.range_imag / (spec.height - 1)
    return type(spec)(spec.start_real + dx * pr, spec.start_imag + dy * pi,
                      spec.range_real, spec.range_imag, spec.width,
                      spec.height)


class GrantSource:
    """In-process coordinator surface for the worker (``request``,
    ``request_batch``, ``submit``, ``submit_batch``; no host, so no
    sessions).  Keeps a checksum per chunk and the bytes of the sampled
    chunks only."""

    def __init__(self, workloads, sample_keys) -> None:
        self._todo = list(workloads)
        self._lock = threading.Lock()
        self.sample_keys = set(sample_keys)
        self.crc: dict = {}
        self.samples: dict = {}
        self.bad_sizes: list = []

    def _take(self, n: int):
        with self._lock:
            got, self._todo = self._todo[:n], self._todo[n:]
        return got

    def request(self):
        got = self._take(1)
        return got[0] if got else None

    def request_batch(self, max_count: int):
        return self._take(max_count)

    def submit(self, workload, pixels) -> bool:
        return self.submit_batch([(workload, pixels)])[0]

    def submit_batch(self, results):
        from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
        for w, px in results:
            if px.dtype.name != "uint8" or px.size != CHUNK_PIXELS:
                self.bad_sizes.append((w.key, px.dtype.name, px.size))
            crc = zlib.crc32(memoryview(px))
            with self._lock:
                self.crc[w.key] = crc
                if w.key in self.sample_keys:
                    self.samples[w.key] = px.copy()
        return [True] * len(results)


def phase_device(build):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    t0 = time.monotonic()
    build.load()
    built_s = time.monotonic() - t0
    regs = []
    for row in build.ptxas_report():
        # Mangled: a length prefix, the name, then I<Li..E...>E template
        # arguments.
        m = re.search(r"\d(escape_[a-z]+_kernel)(?:I((?:Li\d+E)+)E)?",
                      row["kernel"])
        kname = row["kernel"]
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            kname = m.group(1) + (f"<{','.join(args)}>" if args else "")
        regs.append({"kernel": kname,
                     "registers": row.get("registers"),
                     "spill_stores": row.get("spill_stores"),
                     "spill_loads": row.get("spill_loads")})
    emit({"phase": "device", "ok": True, "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": built_s,
          "built_now": build.build_seconds() is not None, "ptxas": regs})
    return name, count, smi


def phase_kernel_vs_plain(ce, TileSpec):
    """Every K1/K2 launch here is held bitwise against the plain version
    on the same device."""
    dev = torch.device("cuda", 0)
    views = [TileSpec(x, y, s, s, width=128, height=128)
             for x, y, s in ((-0.7436, 0.1317, 2e-3), (-0.8, 0.1, 0.2),
                             (-2.0, -2.0, 4.0), (1.5, 1.5, 0.1),
                             (-0.2, -0.05, 0.1))]
    chunks = [TileSpec.for_chunk(4, i, j) for i, j in ((1, 1), (1, 2),
                                                         (3, 3))]
    err = {"escape_tile": 0, "escape_mega": 0, "escape_smooth": 0.0,
           "escape_pack": 0}
    cases = 0

    def check(name, got, want, what):
        nonlocal cases
        cases += 1
        err[name] = max(err[name], max_abs_err(got, want))
        n, d = bit_diff(got, want)
        if n:
            unit = "ulps" if got.dtype == torch.float32 else "values"
            raise AssertionError(f"{name} differs from {what} on {n} "
                                 f"pixels (max {d} {unit})")

    for group in (views, chunks):
        for mi in (256, 1024, 2000):
            cyc = ce.escape_time.resolve_cycle_check(None, mi)
            for spec in group:
                got = ce.compute_tile_cuda_device(spec, mi, device=dev)
                row = ce._params_row(spec)
                want = ce.escape_tile_plain(row, mi, spec.height, spec.width,
                                            cycle_check=cyc, device=dev)
                check("escape_tile", got, want, f"plain at mi {mi}")
            rows, mrds, kw = ce.mega_dispatch_plan(group, [mi] * len(group))
            tiles, census = ce.compute_tiles_mega_cuda(
                group, [mi] * len(group), device=dev)
            ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev,
                                                   **kw)
            check("escape_mega", tiles, ptiles, f"plain at mi {mi}")
            if not torch.equal(census, pcensus):
                raise AssertionError(
                    f"census {census.view(-1).tolist()} != plain "
                    f"{pcensus.view(-1).tolist()} at mi {mi}")
    mixed = [([chunks[1], chunks[0]], [2000, 256]),
             ([chunks[0], chunks[1], chunks[2], chunks[1]],
              [256, 1024, 2000, 300]),
             (views[:4], [300, 2000, 150, 1024])]
    for specs, mis in mixed:
        tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=dev)
        rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev, **kw)
        check("escape_mega", tiles, ptiles, f"plain at mixed {mis}")
        if not torch.equal(census, pcensus):
            raise AssertionError(f"mixed census {census.view(-1).tolist()}"
                                 f" != plain {pcensus.view(-1).tolist()}")
        for t, (spec, mi) in enumerate(zip(specs, mis)):
            one = ce.compute_tile_cuda_device(spec, mi, device=dev)
            check("escape_mega", tiles[t], one, f"K1 per tile ({mis})")

    # The render path's kernels: K1's modes, K4 in every mode, K5 at
    # n = 2 and 4 with mixed budgets in every mode, each pack plane also
    # against K1 on its window (the probe from the pack's deepest
    # budget); one 4096^2 view per kernel.
    full = TileSpec(-1.5, -1.5, 3.0, 3.0, width=4096, height=4096)
    for mode, kw in MODES.items():
        for spec in views + [full]:
            for mi in ((256, 2000) if spec is not full else (1024,)):
                if mode != "mandelbrot":
                    got = ce.compute_tile_cuda_device(spec, mi, device=dev,
                                                      **kw)
                    check("escape_tile", got, plain_tile(ce, spec, mi, kw,
                                                         dev),
                          f"plain ({mode}, mi {mi})")
                got = ce.compute_tile_smooth_cuda(spec, mi, device=dev, **kw)
                check("escape_smooth", got, plain_smooth(ce, spec, mi, kw,
                                                         dev),
                      f"plain ({mode}, mi {mi}, {spec.width}^2)")
        packs = [([shifted(views[0], dx, dy) for dx, dy in SS4[:2]],
                  [2000, 256]),
                 ([views[0], views[1], views[2], views[4]],
                  [256, 1024, 2000, 300]),
                 ([shifted(full, dx, dy) for dx, dy in SS4], [1024] * 4)]
        for specs, mis in packs:
            got = pack_call(ce, specs, mis, kw, dev)
            check("escape_pack", got, plain_pack(ce, specs, mis, kw, dev),
                  f"plain ({mode}, n {len(specs)}, mis {mis})")
            for t, (spec, mi) in enumerate(zip(specs, mis)):
                one = plain_tile(ce, spec, mi, kw, dev, cycle_budget=max(mis))
                check("escape_pack", got[t], one,
                      f"K1's plain version per state ({mode}, {mis})")
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "ok": True, "cases": cases,
          "bitwise": True, "max_abs_err": err})
    return err


def phase_golden(wk, TileSpec, escape_time, Workload):
    sky = Workload(4, 256, 3, 3)
    full = wk.CudaBackend(definition=4096)
    golden = wk.NumpyBackend(definition=4096).compute_batch([sky])[0]
    got_k1 = full.materialize_tile(full.dispatch_tile(sky))
    got_k2 = [full.materialize_tile(h)
              for h in full.dispatch_many([sky, sky])]
    for got in [got_k1] + got_k2:
        if not (got == golden).all():
            raise AssertionError(
                f"sky chunk: {int((got != golden).sum())} pixels differ "
                "from the numpy golden")
    small = wk.CudaBackend(definition=512)
    ws = [sky, Workload(4, 256, 1, 1), Workload(4, 1024, 1, 2)]
    handles = small.dispatch_many(ws)
    if not all(isinstance(h, wk.MegaTileHandle) for h in handles):
        raise AssertionError("the 512^2 batch did not take the fused route")
    got = [small.materialize_tile(h) for h in handles]
    gold = wk.NumpyBackend(definition=512).compute_batch(ws)
    off_mask = {}
    if not (got[0] == gold[0]).all():
        raise AssertionError("sky at 512^2 differs from the golden")
    for i in (1, 2):
        spec = TileSpec.for_chunk(ws[i].level, ws[i].index_real,
                                  ws[i].index_imag, definition=512)
        cr, ci = spec.grid_2d()
        mask = escape_time.mandelbrot_interior(
            torch.from_numpy(cr), torch.from_numpy(ci)).numpy().ravel()
        if not (got[i][mask] == gold[i][mask]).all():
            raise AssertionError(f"{ws[i]}: proven-interior pixels differ")
        off = float((got[i][~mask] != gold[i][~mask]).mean())
        off_mask[str(ws[i].key)] = off
        if off > 0.02:
            raise AssertionError(f"{ws[i]}: {off:.2%} off-mask mismatch")
    emit({"phase": "golden", "ok": True, "sky_4096_bitwise": True,
          "off_mask_mismatch_512": off_mask})


def phase_main_path(wk, ce, names, TileSpec, Workload):
    level4 = [Workload(4, 256, i, j) for j in range(4) for i in range(4)]
    level10 = [Workload(10, 1024, i, j) for j in range(10) for i in range(10)]
    workloads = level4 + level10
    sample = [Workload(4, 256, 1, 2), Workload(4, 256, 3, 3),
              Workload(10, 1024, 3, 5), Workload(10, 1024, 2, 4)]
    source = GrantSource(workloads, [w.key for w in sample])
    backend = wk.CudaBackend()
    # batch_size=4 leases the whole window per exchange: what a session
    # with batched grants does against a coordinator (the CLI's default,
    # --grant-batch 0), which an in-process source has no session for.
    worker = wk.Worker(source, backend, batch_size=4, window=4, depth=2)
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    t0 = time.monotonic()
    rounds = worker.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ce.launch_counts()
    reg = worker.registry
    fused = reg.counter_value(names.WORKER_KERNEL_FUSED_LAUNCHES) or 0
    fused_tiles = reg.counter_value(names.WORKER_KERNEL_FUSED_TILES) or 0
    to_torch = backend.demotions(names.ROUTE_PER_TILE_TO_TORCH)
    demoted = backend.demotions(names.ROUTE_FUSED_TO_PER_TILE)
    pruned = reg.counter_value(names.WORKER_KERNEL_BF16_PRUNED) or 0
    missing = [w.key for w in workloads if w.key not in source.crc]
    if missing or source.bad_sizes:
        raise AssertionError(f"missing chunks {missing[:5]} "
                             f"(+{max(0, len(missing) - 5)}), bad sizes "
                             f"{source.bad_sizes[:5]}")
    if fused <= 0 or launches["escape_mega"] <= 0:
        raise AssertionError("the main path made no fused launch")
    if to_torch or demoted:
        raise AssertionError(f"demotions on the main path: {to_torch} to "
                             f"torch, {demoted} fused to per-tile")
    # Every chunk again through K1, one at a time: the fused, pipelined
    # route must have stored exactly the per-tile kernel's bytes.
    recheck = []
    for w in workloads:
        px = backend.materialize_tile(backend.dispatch_tile(w))
        if zlib.crc32(memoryview(px)) != source.crc[w.key]:
            recheck.append(w.key)
    if recheck:
        raise AssertionError(f"{len(recheck)} chunks differ from K1: "
                             f"{recheck[:5]}")
    for w in sample:
        spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag)
        plain = ce.escape_tile_plain(
            ce._params_row(spec), w.max_iter, 4096, 4096,
            cycle_check=ce.escape_time.resolve_cycle_check(None, w.max_iter),
            device="cuda")
        got = torch.from_numpy(source.samples[w.key]).view(4096, 4096)
        if not torch.equal(got, plain.cpu()):
            raise AssertionError(f"sampled chunk {w.key} differs from the "
                                 "plain version")
    n = len(workloads)
    emit({"phase": "main_path", "ok": True, "chunks": n, "rounds": rounds,
          "levels": {"4": {"max_iter": 256, "chunks": len(level4)},
                     "10": {"max_iter": 1024, "chunks": len(level10)}},
          "seconds": wall, "chunks_per_s": n / wall,
          "mpix_per_s": n * 4096 * 4096 / wall / 1e6,
          "timing": "host clock around run_until_drained(), ended by "
                    "torch.cuda.synchronize()",
          "launches": launches, "fused_launches": fused,
          "fused_tiles": fused_tiles, "demotions_to_torch": to_torch,
          "demotions_fused_to_per_tile": demoted, "bf16_pruned": pruned,
          "k1_recheck_equal": n, "sample_bitwise_vs_plain": len(sample),
          "stage_stats": worker.pipeline.stage_stats().get("fusion")})
    return launches, workloads


def phase_main_path_profile(wk, workloads) -> None:
    """The main path's drain once more, under torch.profiler: device time
    by kernel and the share of the drain's wall time in which the card
    ran anything (the union of its kernel and copy intervals).  Host
    time is inflated by the profiler, so the share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    source = GrantSource(workloads, [])
    worker = wk.Worker(source, wk.CudaBackend(), batch_size=4, window=4,
                       depth=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        worker.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name: dict = {}
    spans = []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        key = ("escape_mega" if "escape_mega" in evt.name else
               "escape_tile" if "escape_tile" in evt.name else
               "memcpy" if "emcpy" in evt.name else "other")
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e3
    busy_ms = 0.0
    last = None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy_ms += (end - start) / 1e3
            last = end
        elif end > last:
            busy_ms += (end - last) / 1e3
            last = end
    seen = bool(spans)
    emit({"phase": "main_path_profile", "ok": True, "chunks": len(workloads),
          "wall_s": wall, "device_time_seen": seen,
          "device_ms_by_kind": by_name if seen else "not measured",
          "device_busy_ms": busy_ms if seen else "not measured",
          "device_busy_share": busy_ms / 1e3 / wall if seen
          else "not measured"})


# (name, render flags, kernel): one 4096^2 view per mode of the render
# path.  Each fractal's default center, span 3.
RENDERS = [
    ("mandelbrot", ["--max-iter", "1024"], "escape_tile"),
    ("julia", ["--fractal", "julia", "--max-iter", "1024"], "escape_tile"),
    ("multibrot3", ["--fractal", "multibrot", "--max-iter", "1024"],
     "escape_tile"),
    ("ship", ["--fractal", "ship", "--center=-0.5,-0.5", "--max-iter",
              "1024"], "escape_tile"),
    ("mandelbrot_smooth", ["--smooth", "--dtype", "f32", "--max-iter",
                           "1024"], "escape_smooth"),
    ("julia_smooth", ["--fractal", "julia", "--smooth", "--dtype", "f32",
                      "--max-iter", "1024"], "escape_smooth"),
    ("multibrot3_smooth", ["--fractal", "multibrot", "--smooth", "--dtype",
                           "f32", "--max-iter", "1024"], "escape_smooth"),
    ("ship_smooth", ["--fractal", "ship", "--center=-0.5,-0.5", "--smooth",
                     "--dtype", "f32", "--max-iter", "1024"],
     "escape_smooth"),
    ("mandelbrot_ss4", ["--supersample", "4", "--max-iter", "1024"],
     "escape_pack"),
    ("julia_ss2", ["--fractal", "julia", "--supersample", "2",
                   "--max-iter", "1024"], "escape_pack"),
]
RENDER_SIDE = 4096


def expected_png(ce, cli, srender, TileSpec, name, flags, dev) -> bytes:
    """The PNG the render must write, from the plain versions' planes on
    the card through the port's colormap and PNG writer."""
    mode = name.split("_")[0]
    kw = MODES[mode]
    center = next((f.split("=", 1)[1] for f in flags
                   if f.startswith("--center=")),
                  "0,0" if mode == "julia" else "-0.5,0.0")
    cx, cy = (float(v) for v in center.split(","))
    mi = int(flags[flags.index("--max-iter") + 1])
    span = 3.0
    spec = TileSpec(cx - span / 2, cy - span / 2, span, span,
                    width=RENDER_SIDE, height=RENDER_SIDE)
    if "--supersample" in flags:
        n = int(flags[flags.index("--supersample") + 1])
        specs = [shifted(spec, dx, dy) for dx, dy in cli._SS_OFFSETS[n]]
        acc = None
        for plane in plain_pack(ce, specs, [mi] * n, kw, dev).cpu().numpy():
            rgba = srender.value_to_rgba(plane)
            acc = rgba if acc is None else acc + rgba
        rgba = acc / n
    elif "--smooth" in flags:
        rgba = srender.smooth_to_rgba(
            plain_smooth(ce, spec, mi, kw, dev).cpu().numpy(), mi)
    else:
        rgba = srender.value_to_rgba(
            plain_tile(ce, spec, mi, kw, dev).cpu().numpy())
    return srender.encode_png(srender.imsave_bytes(rgba))


def render_breakdown(ce, srender, TileSpec) -> dict:
    """Where a 4096^2 render's time goes, piece by piece on the host
    clock: the kernel (launch to synchronize), the copy of its plane to
    the host, the colormap, and the PNG (byte conversion and zlib)."""
    dev = torch.device("cuda", 0)
    spec = render_view("mandelbrot", TileSpec)
    win = [shifted(spec, dx, dy) for dx, dy in SS4]
    cases = {
        "mandelbrot": (lambda: ce.compute_tile_cuda_device(
            spec, 1024, device=dev), srender.value_to_rgba),
        "mandelbrot_smooth": (lambda: ce.compute_tile_smooth_cuda(
            spec, 1024, device=dev),
            lambda nu: srender.smooth_to_rgba(nu, 1024)),
        "mandelbrot_ss4": (lambda: pack_call(ce, win, [1024] * 4, {}, dev),
                           lambda planes: sum(srender.value_to_rgba(p)
                                              for p in planes) / 4),
    }
    out = {}
    for name, (compute, colormap) in cases.items():
        compute()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        plane = compute()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        host = plane.cpu().numpy()
        t2 = time.monotonic()
        rgba = colormap(host)
        t3 = time.monotonic()
        srender.encode_png(srender.imsave_bytes(rgba))
        t4 = time.monotonic()
        out[name] = {"kernel": t1 - t0, "copy": t2 - t1, "colormap": t3 - t2,
                     "png": t4 - t3, "total": t4 - t0}
    return out


def phase_render_path(ce, cli, srender, TileSpec):
    """The render subcommand end to end at 4096^2, one view per mode:
    each launches its kernel once and nothing else, declines nothing,
    and writes the plain versions' PNG byte for byte."""
    dev = torch.device("cuda", 0)
    by_render, launches = {}, {k: 0 for k in ce.launch_counts()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, kernel in RENDERS:
            out = os.path.join(tmp, f"{name}.png")
            torch.cuda.synchronize()
            ce.reset_launch_counts()
            cli.reset_kernel_declines()
            t0 = time.monotonic()
            rc = cli.main(["render", *flags, "--definition",
                           str(RENDER_SIDE), "--out", out, "-q"])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = ce.launch_counts()
            declines = cli.kernel_declines()
            want = {k: int(k == kernel) for k in counts}
            if rc != 0 or counts != want or declines:
                raise AssertionError(
                    f"render {name}: rc {rc}, launches {counts} (want "
                    f"{want}), declines {declines}")
            for k, v in counts.items():
                launches[k] += v
            with open(out, "rb") as fh:
                got = fh.read()
            png_equal = got == expected_png(ce, cli, srender, TileSpec, name,
                                            flags, dev)
            if not png_equal:
                raise AssertionError(f"render {name}: the PNG differs from "
                                     "the plain versions' PNG")
            by_render[name] = {"kernel": kernel, "launches": counts[kernel],
                               "declines": 0, "seconds": wall,
                               "png_bytes": len(got),
                               "png_equal_plain": png_equal}
    emit({"phase": "render_path", "ok": True, "side": RENDER_SIDE,
          "renders": by_render, "launches": launches,
          "breakdown_s": render_breakdown(ce, srender, TileSpec),
          "timing": "host clock around cli.main, ended by "
                    "torch.cuda.synchronize() (colormap and PNG "
                    "encoding on the host included)"})
    return launches


def warp_steps(steps) -> int:
    """Steps the warps execute: a warp spans 32 adjacent pixels of a row
    and runs until its slowest lane retires (per-thread early exit
    diverges inside a warp)."""
    s = steps.reshape(-1, 32).to(torch.int64)
    return int(s.max(dim=1).values.sum()) * 32


def bound(f32_steps: int, scout_steps: int, out_bytes: int,
          per_step: int = OPS_PER_STEP, extra_ops: int = 0):
    """(bound_ms, bound_by, ops): the kernel's operations (``per_step``
    per f32 step, the bf16 scout's scalar ops counted at the same rate,
    plus ``extra_ops``) over the f32 non-FMA rate, against its output
    bytes over the memory rate."""
    ops = f32_steps * per_step + scout_steps * OPS_PER_STEP + extra_ops
    t_ops = ops / F32_OPS_PER_S
    t_bytes = out_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def render_view(mode: str, TileSpec):
    """A render path view at 4096^2: the fractal's default center (the
    ship's at -0.5-0.5i), span 3."""
    cx, cy = {"julia": (0.0, 0.0), "ship": (-0.5, -0.5)}.get(mode,
                                                             (-0.5, 0.0))
    return TileSpec(cx - 1.5, cy - 1.5, 3.0, 3.0, width=4096, height=4096)


def time_k1_modes(ce, TileSpec, dev) -> dict:
    """K1 per added mode on its render view at budget 1024."""
    out = {}
    mi = 1024
    for mode in ("julia", "multibrot3", "ship"):
        kw = MODES[mode]
        spec = render_view(mode, TileSpec)
        ms = median_ms(lambda: ce.compute_tile_cuda_device(
            spec, mi, device=dev, **kw), reps=20)
        plain_ms = median_ms(lambda: plain_tile(ce, spec, mi, kw, dev),
                             reps=2, warmup=1)
        got = ce.compute_tile_cuda_device(spec, mi, device=dev, **kw)
        want, steps = ce.escape_tile_plain(
            ce._params_row(spec, kw.get("julia_c")), mi, 4096, 4096,
            cycle_check=ce.escape_time.resolve_cycle_check(None, mi),
            power=kw.get("power", 2), burning=kw.get("burning", False),
            device=dev, return_steps=True)
        if not torch.equal(got, want):
            raise AssertionError(f"timed K1 ({mode}) differs from its plain "
                                 "version")
        b_ms, b_by, ops = bound(int(steps.sum()), 0, 4096 * 4096,
                                per_step=ops_per_step(kw))
        out[mode] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "ops": ops,
                     "f32_steps": int(steps.sum()),
                     "f32_warp_steps": warp_steps(steps),
                     "input": f"{mode} render view (span 3) at 4096^2, "
                              f"max_iter {mi}"}
    return out


def phase_kernels(ce, TileSpec, launches, err):
    dev = torch.device("cuda", 0)
    # The main path's heaviest inputs: level-10 chunks at budget 1024 on
    # the seahorse valley's edge (chunk (3, 5) spans [-0.8,-0.4]x[0,0.4]).
    a = TileSpec.for_chunk(10, 3, 5)
    b = TileSpec.for_chunk(10, 3, 4)
    mi = 1024
    cyc = ce.escape_time.resolve_cycle_check(None, mi)
    row_a = ce._params_row(a)

    k1_ms = median_ms(lambda: ce.compute_tile_cuda_device(a, mi, device=dev),
                      reps=50)
    k1_plain_ms = median_ms(lambda: ce.escape_tile_plain(
        row_a, mi, 4096, 4096, cycle_check=cyc, device=dev), reps=3,
        warmup=1)
    k1_got = ce.compute_tile_cuda_device(a, mi, device=dev)
    k1_want, k1_steps = ce.escape_tile_plain(row_a, mi, 4096, 4096,
                                             cycle_check=cyc, device=dev,
                                             return_steps=True)
    k1_bitwise = bool(torch.equal(k1_got, k1_want))
    k1_bound, k1_by, k1_ops = bound(int(k1_steps.sum()), 0, 4096 * 4096)

    specs, mis = [a, b], [mi, mi]
    rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
    k2_ms = median_ms(lambda: ce.compute_tiles_mega_cuda(specs, mis,
                                                         device=dev),
                      reps=50)
    k2_plain_ms = median_ms(lambda: ce.escape_mega_plain(
        rows, mrds, device=dev, **kw), reps=3, warmup=1)
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=dev)
    ptiles, pcensus, psteps, pscout = ce.escape_mega_plain(
        rows, mrds, device=dev, return_steps=True, **kw)
    k2_bitwise = bool(torch.equal(tiles, ptiles)
                      and torch.equal(census, pcensus))
    k2_bound, k2_by, k2_ops = bound(int(psteps.sum()), sum(pscout),
                                    2 * 4096 * 4096)
    # K4 on the same chunk: f32 nu, 4 bytes a pixel.
    k4_ms = median_ms(lambda: ce.compute_tile_smooth_cuda(a, mi, device=dev),
                      reps=50)
    k4_plain_ms = median_ms(lambda: plain_smooth(ce, a, mi, {}, dev),
                            reps=3, warmup=1)
    k4_got = ce.compute_tile_smooth_cuda(a, mi, device=dev)
    k4_want, k4_steps = plain_smooth(ce, a, mi, {}, dev, return_steps=True)
    k4_bitwise = bit_diff(k4_got, k4_want)[0] == 0
    k4_bound, k4_by, k4_ops = bound(
        int(k4_steps.sum()), 0, 4 * 4096 * 4096,
        extra_ops=int((k4_want > 0).sum()) * SMOOTH_EPILOGUE_OPS)

    # K5 on the four supersample windows of the same chunk, beside four
    # K1 launches on them (what the pack replaces), and at n = 2.
    win = [shifted(a, dx, dy) for dx, dy in SS4]
    k5_ms = median_ms(lambda: pack_call(ce, win, [mi] * 4, {}, dev), reps=50)
    k1x4_ms = median_ms(lambda: [ce.compute_tile_cuda_device(w, mi,
                                                             device=dev)
                                 for w in win], reps=50)
    k5_n2_ms = median_ms(lambda: pack_call(ce, win[:2], [mi] * 2, {}, dev),
                         reps=50)
    k5_plain_ms = median_ms(lambda: plain_pack(ce, win, [mi] * 4, {}, dev),
                            reps=3, warmup=1)
    k5_got = pack_call(ce, win, [mi] * 4, {}, dev)
    k5_want, k5_steps = plain_pack(ce, win, [mi] * 4, {}, dev,
                                   return_steps=True)
    k5_bitwise = bool(torch.equal(k5_got, k5_want))
    k5_bound, k5_by, k5_ops = bound(int(k5_steps.sum()), 0, 4 * 4096 * 4096)
    modes = time_k1_modes(ce, TileSpec, dev)

    if not (k1_bitwise and k2_bitwise and k4_bitwise and k5_bitwise):
        raise AssertionError("timed kernels differ from their plain versions")

    def runs(kernel):
        by_path = {path: counts.get(kernel, 0)
                   for path, counts in launches.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    kernels = [
        {"name": "escape_tile", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["escape_tile"], **runs("escape_tile"),
         "max_abs_err": err["escape_tile"], "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "library_reason": NO_LIBRARY,
         "bitwise_vs_plain": k1_bitwise,
         "input": "chunk (10, 3, 5) at 4096^2, max_iter 1024",
         "f32_steps": int(k1_steps.sum()),
         "f32_warp_steps": warp_steps(k1_steps), "ops": k1_ops,
         "modes": modes},
        {"name": "escape_mega", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["escape_mega"], **runs("escape_mega"),
         "max_abs_err": err["escape_mega"], "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "library_reason": NO_LIBRARY,
         "bitwise_vs_plain": k2_bitwise,
         "input": "k=2: chunks (10, 3, 5) and (10, 3, 4) at 4096^2, "
                  "max_iter 1024, census armed",
         "f32_steps": int(psteps.sum()),
         "f32_warp_steps": warp_steps(psteps), "scout_steps": sum(pscout),
         "ops": k2_ops},
        {"name": "escape_smooth", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["escape_smooth"], **runs("escape_smooth"),
         "max_abs_err": err["escape_smooth"], "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None, "library_reason": NO_LIBRARY,
         "bitwise_vs_plain": k4_bitwise,
         "input": "chunk (10, 3, 5) at 4096^2, max_iter 1024, bailout 256",
         "f32_steps": int(k4_steps.sum()),
         "f32_warp_steps": warp_steps(k4_steps), "ops": k4_ops},
        {"name": "escape_pack", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["escape_pack"], **runs("escape_pack"),
         "max_abs_err": err["escape_pack"], "ms": k5_ms,
         "plain_ms": k5_plain_ms, "bound_ms": k5_bound, "bound_by": k5_by,
         "library_ms": None, "library_reason": NO_LIBRARY,
         "bitwise_vs_plain": k5_bitwise,
         "input": "n=4: the supersample windows of chunk (10, 3, 5) at "
                  "4096^2, max_iter 1024",
         "k1_x4_ms": k1x4_ms, "n2_ms": k5_n2_ms,
         "f32_steps": int(k5_steps.sum()), "ops": k5_ops,
         # Warp lane-steps under two models of the pack's loop: each
         # state's code skipped once no lane of the warp needs it (what
         # four K1 launches issue), or issued for every state until the
         # warp's last orbit retires.
         "warp_steps_states_skipped": sum(warp_steps(st) for st in k5_steps),
         "warp_steps_states_issued": len(win) * warp_steps(
             k5_steps.max(dim=0).values)},
    ]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch import worker as wk
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.obs import names
    from distributedmandelbrot_tpu_torch.ops import _build, escape_time
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    from distributedmandelbrot_tpu_torch.serve import render as srender

    t_start = time.monotonic()
    name, count, smi = phase_device(_build)
    err = phase_kernel_vs_plain(ce, TileSpec)
    phase_golden(wk, TileSpec, escape_time, Workload)
    main_launches, workloads = phase_main_path(wk, ce, names, TileSpec,
                                               Workload)
    phase_main_path_profile(wk, workloads)
    render_launches = phase_render_path(ce, cli, srender, TileSpec)
    kernels = phase_kernels(ce, TileSpec, {"main_path": main_launches,
                                           "render_path": render_launches},
                            err)
    emit({"phase": "kernels", "ok": True,
          "seconds_total": time.monotonic() - t_start,
          "card": smi, "kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
