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
   128^2 views and one 4096^2 view per kernel; K8, the matrix form, in
   K1 and in K2 (k = 2 and 4, mixed budgets 256/1024/2000, Mandelbrot
   and Julia), K2 in its Julia, Multibrot-3 and Burning-Ship modes, each
   against its plain version (the census as integers) and per tile
   against K1, and, where the probe admits full mode, the matrix form
   against the cached form (128^2 views, 4096^2 chunks).  Then the
   refill stress cases of K1's and K2's persistent loop: K2 at k = 128
   tiles of 64^2 with budgets from 1-2000 (1-9 included, numpy seed) in
   every mode and K8 form, per tile against K1; K1 and K2 on a 7x3 tile;
   two K2 launches in flight at once on two streams of cuda:0.  K3 and
   K5 on the same loop: K3 at k = 300 tiles of 64^2 with budgets 1-5000
   in every mode (per tile against K1), the batch's halves as two K3
   launches at once on two streams, and K3 at k = 65,537 tiles of 4x32;
   K5 at n = 1-4 in every mode on 7x3 and 64^2 windows at budgets 1-9,
   17 and 1500 (per plane against K1).  K4 on the same loop in every
   mode on 7x3 and 64^2 windows (one holding c = -2, an orbit that stops
   at the step limit) at budgets 1-9, 17 and 1500, the probe by policy
   and armed, two launches at once on two streams; K6 (one thread a
   pixel) at k = 300 tiles of 64^2 with budgets 1-1000 in every mode at
   phases 256 and 61, and at k = 65,537 tiles of 4x32 (two launches of
   its grid's tile slices); K7 (one thread a lane of a list) on the
   live lanes of 300 tiles of 32^2 (budgets 1-1000) from steps 257 and
   62, rounds of 1, 7 and 256 steps and to the end, in every mode,
   packed and over an index list (int64, int32), two launches at once on
   two streams; the compacted pipeline (one K7 launch over the live
   lanes' indices) against K3, after phases of 256 and 64 steps.  Fused
   batches past one K2
   launch's 128 tiles: 129 level-12 chunks at 64^2 through
   ``CudaBackend.dispatch_many`` on cuda:0 and on the ring ``[cuda:0,
   cuda:0]`` (two K2 launches, no demotion, per tile against K1), and
   300 tiles through ``compute_tiles_mega_sharded`` on the ring (shards
   of 150, four launches).  K9 (``perturb_scan``) and K10
   (``perturb_scan_smooth``), the perturbation route's delta scans, on
   every state output: f32 and f64, Mandelbrot (the config-4 view) and
   Julia at 256^2 and 512^2, K9 with the stagnation stop armed and not,
   an orbit shorter than the budget, a stagnation stop and a scan of
   78 segments.
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
7. mesh_path: the port's ``Worker`` with ``MeshBackend`` drains three
   grant sets in batches of 4 full chunks: level 4 at budget 5000 (the
   K3 route), level 10 at 1000 with ``DMTPU_COMPACT=1`` (K6/K7) and
   level 10 at 256 (the K1 chain); each chunk equals K1 by checksum,
   sampled chunks equal the plain versions bitwise, and each drain
   launches its route's kernel and no other, with no demotion.  Then
   the ring ``[cuda:0, cuda:0]`` (two shards, two streams): MeshBackend,
   ``CudaBackend.dispatch_many`` and the row-sharded torch loop, each
   bitwise its one-device result.
8. mxu_path: the ``DMTPU_MXU`` gate on the fused route: the card's
   probe verdict and its differing lanes; 16 chunks of the main path's
   profile drained by the pipelined ``CudaBackend`` with ``DMTPU_MXU=0``,
   then ``=1`` on one device and on the ring ``[cuda:0, cuda:0]`` (full
   mode: matrix-form launches equal the fused launches, no demotion),
   then with the census verdict forced (demotions counted, census pixels
   > 0, no census failure); every drain's chunks bitwise those of
   ``DMTPU_MXU=0``.  Then one 4096^2 batch per K2 mode through
   ``compute_tiles_mega_sharded`` on the ring, each tile against K1.
9. multihost: the script re-launches itself as two ``gloo`` ranks on
   ``cuda:0``; each runs ``batched_escape_pixels_multihost`` on its half
   of a 4-chunk level-10 batch at budget 5000 (K3 on two chunks), and
   the gathered result must equal K3 on the whole batch in this
   process, bitwise.  A rank that fails or outlives its timeout fails
   the phase.
10. deep_path: ``render`` of the deep views (``--deep``): the config-4
   view (span 1e-10 at -0.77568376995+0.13646737005i, max_iter 50000)
   integer f32 at 1024^2 and 4096^2 and smooth f64 at 1024^2, and the
   period-6 bond point's view (span 1e-15, max_iter 20000, where the
   probe turns BLA on) at 1024^2, each twice (cold, then with the
   reference cached): seconds split into the reference search, the BLA
   probe and table, the scans, the glitch repairs and the rest
   (colormap, PNG), K9/K10 launches, glitched and repaired pixels.  Each
   must launch its scan kernel (the bond view: take BLA) and no escape
   kernel, and write the PNG of the same route on the plain scans byte
   for byte; the config-4 view's sampled pixels equal the exact
   fixed-point counts (at most 1 of 12 off, the JAX package's bar).
11. farm_path: the pull-based farm in the port alone, at main_path's
   cut (``-l 4:256,10:1024``, 116 chunks, in a temporary data
   directory): ``python -m distributedmandelbrot_tpu_torch coordinator``
   as a process of its own, drained by ``worker --backend cuda
   --stats-json`` (``cli.main`` in this process, K2 and K1 must
   launch): chunks/s over TCP beside main_path's in-process chunks/s,
   the worker's stage stats and the coordinator's upload histograms
   (decode, accept, persist; its exporter's ``/varz``); every stored
   chunk fetched back through the port's ``DataClient`` equals
   ``CudaBackend``'s bytes for its grant, eight (sky, interior,
   boundary of both levels) equal the plain version; the same drain
   again with 2 and 4 upload lanes (a fresh coordinator each), for
   chunks/s by lane count.  Then ``serve -l 2:256`` with no chunk on
   disk: a read of an absent tile through the gateway, with a port worker
   attached once the read waits, returns the plain version's bytes
   (the compute-on-read latency); the second read is a cache hit by
   the gateway's counter (its exporter's ``/varz``); the rendered
   tile in jet, viridis and plasma decodes to ``value_lut(cmap)[tile]``;
   ``viewer 2 1 1 --out`` and ``viewer --stitch 2 --out`` write the
   PNGs the fetched values colour to.  Then ``animate`` of the
   config-5 shape cut to 12 frames at 1024^2 (span 4 to 1e-16, budgets
   1000 to 20000): seconds per frame, the deep frames, K1 and K9 must
   launch, and frames 0, 6 and 11 are byte for byte the PNG ``render``
   writes for the same span and budget.  Every process started is
   stopped; each leg's launches are counted around its drive only.
12. control_path (in a process of its own: a process that profiled
   before misses device events): the sharded control plane at
   farm_path's cut.  Two ``python -m distributedmandelbrot_tpu_torch
   coord`` shards (``--shard 0/2`` and ``1/2``, one shared data
   directory, ports picked here and written into one ring JSON) are
   drained by ``worker --backend cuda --ring RING --exporter-port 0
   --profile DIR --stats-json`` (``cli.main`` in that process; K2 and
   K1 must launch): chunks/s over the ring beside farm_path's, the
   chunks each shard granted (they sum to 116), the worker's own
   ``/varz`` read during the drain (the upload lane's histograms) and
   its stage stats, the shards' upload histograms, and the escape
   kernels' events in the ``--profile`` trace, which must equal the
   launch counters.  Every stored chunk fetched from its owning shard
   equals ``CudaBackend``'s bytes, the eight samples the plain version;
   ``top --ring RING --once --json`` lists both shards and ``stats
   --port --json`` reads each shard's ``/varz``.  The shards stop on
   SIGINT (exit 0); ``compact -o DIR`` must refuse the sharded store
   (it knows only a single coordinator's index) and touch nothing; the
   shards restarted on it serve all 116 chunks equal once more.  Then
   the same drain without ``--profile`` on fresh shards, for chunks/s.
13. kernels: per kernel, its launches on the paths above and its median
   time by CUDA events at 4096^2 beside the plain version's and the
   bound (the larger of its f32 operations over the non-FMA f32 rate
   and the bytes it must move over the memory rate); K1 per mode, K5
   beside four K1 launches on the same windows, and the compacted
   pipeline's wall time beside K3's on one 4-chunk batch with the warp
   lane-steps each issues over the steps the pixels need and its device
   time split by operation under torch.profiler; K7 on the whole resume
   as the pipeline launches it (and its flat form on one round of 256
   steps, a form off the path); K8 in K2
   beside K2 in the same run, with the static f32 instructions of each
   persistent kernel's instantiation (``cuobjdump -sass``), and K2 in
   each mode.  For K1, K2 and their modes, K3 (also on a light batch of
   four level-4 chunks at 256), K4 (also on chunk (4,1,1) at 256), K5,
   K6 (also on the light batch at 700) and K7 also the lane steps the
   warps issue (measured by the instrumented form, beside the modelled
   ``f32_warp_steps`` of a one-pixel-a-thread loop), registers,
   occupancy and the SASS of the inner step group.  K9 on the config-4
   view at 4096^2 (16 row chunks, as the route launches them) and
   1024^2, K10 on its smooth f64 view at 1024^2, beside their plain
   versions and their bound (the lane-steps the view needs x 20
   operations over the f32 or f64 rate), with registers.
14. check_path: ``python -m distributedmandelbrot_tpu_torch check --json
   --profile`` (``cli.main``, through a gate script) in a child process
   on the card's host must exit 0 with no finding and no stale baseline
   entry, having imported neither torch, jax nor the JAX package; every
   kernel on the kernels line must have its launching function in the
   ``torch`` rule family's scope (``rules_torch.launching_functions``).
   Its wall and CPU seconds and the per-family seconds of ``--profile``
   beside the card's name and power limit.

``python3 chip_smoke.py --control [--out PATH]`` runs control_path
alone (about a minute with the build).

``python3 chip_smoke.py --deep [--out PATH]`` runs the deep route alone
in a process of its own (about a minute): the build, ``deep_path``
twice (pass 1 is the process's first render, pass 2 a later one), K9
and K10 against their plain versions and their times, the colour
kernel's; ``--out`` writes the JSON lines to PATH.

The second-to-last line is ``nvidia-smi``'s name and power limit, the
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import resource
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
    "escape_batch": "distributedmandelbrot_tpu/ops/pallas_escape.py:493",
    "escape_state": "distributedmandelbrot_tpu/ops/compact_escape.py:95",
    "escape_resume": "distributedmandelbrot_tpu/ops/compact_escape.py:167",
    "escape_mega_mxu": "distributedmandelbrot_tpu/ops/mxu_iteration.py:65",
    "escape_mega_julia": "distributedmandelbrot_tpu/ops/pallas_escape.py:638",
    "escape_mega_multibrot":
        "distributedmandelbrot_tpu/ops/pallas_escape.py:638",
    "escape_mega_ship": "distributedmandelbrot_tpu/ops/pallas_escape.py:638",
}
# K6 writes c, z (f32) and n, act (int32) per pixel; K7 reads c, z, n,
# act and the budget and writes z, n, act per lane and round.
STATE_BYTES_PER_PIXEL = 24
RESUME_BYTES_PER_LANE = 28 + 16
# The multi-process phase: two ranks, each on cuda:0, each with its own
# timeout (seconds).
RANKS = 2
RANK_TIMEOUT_S = 300
JULIA_C = complex(-0.8, 0.156)
# K1's modes, as wrapper keywords.
MODES = {"mandelbrot": {}, "julia": {"julia_c": JULIA_C},
         "multibrot3": {"power": 3}, "ship": {"burning": True}}
# K2's modes beyond Mandelbrot (the suffixes of their launch counters).
MEGA_MODES = {"julia": MODES["julia"], "multibrot": MODES["multibrot3"],
              "ship": MODES["ship"]}
# K8's f32 operations per step as written: 4 multiplies and 2 adds for
# the 2x2 product, 2 adds of c, 2 squares and 1 add for |z|^2.  A note
# only: the function needs OPS_PER_STEP (rn(zi*zr) + rn(zr*zi) equals
# rn(rn(zr+zr)*zi) bit for bit wherever the probe admits the form, and
# the next step's squares are |z|^2's), so the bound counts that.
MXU_OPS_AS_WRITTEN = 11
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
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bit_diff(a, b) -> tuple[int, int]:
    """(elements that differ, largest difference): in units in the last
    place for f32 and f64 (the bits compared as integers), in values
    otherwise."""
    if a.dtype == torch.float32:
        d = (a.view(torch.int32).to(torch.int64)
             - b.view(torch.int32).to(torch.int64)).abs()
    elif a.dtype == torch.float64:
        d = (a.view(torch.int64) != b.view(torch.int64)).to(torch.int64)
    else:
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
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


def kernel_name(mangled: str) -> str:
    """``escape_mega_kernel<0,1>`` from its mangled name: a length
    prefix, the name, then ``I<L[ib]n E...>E`` template arguments."""
    m = re.search(r"\d((?:escape_[a-z]+|mxu_probe|perturb_[a-z]+"
                  r"|colormap_rgba8)_kernel)"
                  r"(?:I([fd]?)((?:L[ib]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = ([{"f": "float", "d": "double"}[m.group(2)]] if m.group(2)
            else []) + re.findall(r"L[ib](\d+)E", m.group(3) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_listing(build) -> str | None:
    """The built library's SASS (``cuobjdump -sass``), or None."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        return subprocess.run([tool, "-sass", str(build.library_path())],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None


_SASS_INST = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)")


def sass_functions(listing: str) -> dict:
    """The persistent kernels' SASS by instantiation name: a list of
    basic blocks, each a list of opcodes (a block ends at a label or
    after a branch, exit or return)."""
    per: dict = {}
    cur = None
    for line in listing.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            cur = (per.setdefault(name, [[]])
                   if name.startswith(("escape_tile", "escape_mega",
                                       "escape_batch", "escape_pack",
                                       "escape_smooth"))
                   else None)
            continue
        if cur is None:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            cur.append([])
            continue
        m = _SASS_INST.search(line)
        if m and m.group(1) != "NOP":
            cur[-1].append(m.group(1))
            if m.group(1) in ("BRA", "EXIT", "RET", "JMP", "BRX"):
                cur.append([])
    return per


def sass_f32_ops(listing: str | None) -> dict | str:
    """Static f32 arithmetic instructions (FMUL, FADD, FFMA) of each
    persistent kernel's instantiation: whether nvcc kept the matrix
    form's recomputed squares or merged them, and that no FMA was
    formed."""
    if listing is None:
        return "not measured (no cuobjdump listing)"
    return {name: {op: sum(b.count(op) for b in blocks)
                   for op in ("FMUL", "FADD", "FFMA")}
            for name, blocks in sass_functions(listing).items()}


def sass_step_group(listing: str | None) -> dict | str:
    """The inner step group of each persistent kernel's instantiation:
    the basic block with the most f32 arithmetic (at degree 2 and in the
    ship, steps 5-8 of dm::step_group, the group's tail after its
    early-exit votes; at degree d > 2 the body of the complex power's
    loop), with its instructions, f32 operations, and instructions per
    f32 operation (the share of issue slots the arithmetic gets is its
    inverse)."""
    if listing is None:
        return "not measured (no cuobjdump listing)"
    out = {}
    for name, blocks in sass_functions(listing).items():
        f32 = [sum(op in ("FMUL", "FADD", "FFMA") for op in b)
               for b in blocks]
        b = blocks[int(np.argmax(f32))]
        out[name] = {"instructions": len(b), "f32": max(f32),
                     "per_f32": len(b) / max(f32) if max(f32) else None,
                     "opcodes": {op: b.count(op) for op in sorted(set(b))}}
    return out


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
        kname = kernel_name(row["kernel"])
        regs.append({"kernel": kname,
                     "registers": row.get("registers"),
                     "spill_stores": row.get("spill_stores"),
                     "spill_loads": row.get("spill_loads")})
    emit({"phase": "device", "ok": True, "name": name, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": built_s,
          "built_now": build.build_seconds() is not None, "ptxas": regs})
    return name, count, smi


def bitwise_checker(err: dict):
    """``check(name, got, want, what)``, which raises unless ``got`` equals
    ``want`` bit for bit and keeps each kernel's largest difference in
    ``err``, and a count of its cases."""
    cases = [0]

    def check(name, got, want, what):
        cases[0] += 1
        err[name] = max(err[name], max_abs_err(got, want))
        n, d = bit_diff(got, want)
        if n:
            unit = ("ulps" if got.dtype == torch.float32 else
                    "differing f64s" if got.dtype == torch.float64 else
                    "values")
            raise AssertionError(f"{name} differs from {what} on {n} "
                                 f"pixels (max {d} {unit})")

    return check, lambda: cases[0]


def phase_kernel_vs_plain(ce, TileSpec):
    """Every kernel launch here is held bitwise against its plain version
    on the same device."""
    dev = torch.device("cuda", 0)
    views = [TileSpec(x, y, s, s, width=128, height=128)
             for x, y, s in ((-0.7436, 0.1317, 2e-3), (-0.8, 0.1, 0.2),
                             (-2.0, -2.0, 4.0), (1.5, 1.5, 0.1),
                             (-0.2, -0.05, 0.1))]
    chunks = [TileSpec.for_chunk(4, i, j) for i, j in ((1, 1), (1, 2),
                                                         (3, 3))]
    err = {"escape_tile": 0, "escape_mega": 0, "escape_smooth": 0.0,
           "escape_pack": 0, "escape_batch": 0, "escape_state": 0.0,
           "escape_resume": 0.0, "escape_tile_mxu": 0, "escape_mega_mxu": 0,
           **{f"escape_mega_{m}": 0 for m in MEGA_MODES},
           "perturb_scan": 0, "perturb_scan_smooth": 0.0}
    check, cases = bitwise_checker(err)

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
    check_mesh_kernels(ce, TileSpec, views, check)
    check_mxu_and_mega_modes(ce, TileSpec, views, chunks, check)
    check_refill_stress(ce, TileSpec, check)
    check_perturb_kernels(check)
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "ok": True, "cases": cases(),
          "bitwise": True, "max_abs_err": err})
    return err


def mode_args(kw: dict) -> dict:
    return dict(power=kw.get("power", 2), burning=kw.get("burning", False))


def mega_kw(kw: dict, k: int) -> dict:
    """K2 keywords of a K1 mode for k tiles (one Julia constant each)."""
    kw = dict(kw)
    jc = kw.pop("julia_c", None)
    if jc is not None:
        kw["julia_cs"] = [jc] * k
    return kw


def check_mxu_and_mega_modes(ce, TileSpec, views, chunks, check) -> None:
    """K8 and K2's modes, bitwise: K1 in the matrix form (Mandelbrot and
    Julia) against its plain version on the 128^2 views and the 4096^2
    chunks at budgets 256, 1024 and 2000; K2 in the matrix form at k = 2
    and 4 with mixed budgets 256/1024/2000 (census armed), Mandelbrot and
    Julia, and K2 in its Julia, Multibrot-3 and Burning-Ship modes on the
    128^2 views and one 4096^2 pair, each against its plain version
    (census compared as integers) and per tile against K1 in the same
    mode.  Where the probe admits full mode, the matrix form also equals
    the cached form (128^2 views, and the 4096^2 chunks (10,3,5),
    (10,3,4) at 1024)."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    dev = torch.device("cuda", 0)
    admitted = mxu.mxu_parity_proven(dev)
    for mi in (256, 1024, 2000):
        cyc = ce.escape_time.resolve_cycle_check(None, mi)
        for spec in views + chunks:
            for jc in ((None, JULIA_C) if spec.width == 128 else (None,)):
                got = ce.compute_tile_cuda_device(spec, mi, use_mxu=True,
                                                  julia_c=jc, device=dev)
                want = ce.escape_tile_plain(
                    ce._params_row(spec, jc), mi, spec.height, spec.width,
                    cycle_check=cyc, use_mxu=True, device=dev)
                check("escape_tile_mxu", got, want, f"plain at mi {mi}")
                if admitted:
                    check("escape_tile_mxu", got, ce.compute_tile_cuda_device(
                        spec, mi, julia_c=jc, device=dev),
                        f"the cached form at mi {mi}")
    deep = [TileSpec.for_chunk(10, 3, 5), TileSpec.for_chunk(10, 3, 4)]
    sets = [(views[:2], [2000, 256]), (views[:4], [256, 1024, 2000, 300]),
            (chunks[:2], [1024, 2000]), (deep, [1024, 1024])]

    def against_plain_and_k1(name, specs, mis, k1_kw, **kw):
        tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=dev,
                                                   **kw)
        rows, mrds, pkw = ce.mega_dispatch_plan(specs, mis, **kw)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev, **pkw)
        check(name, tiles, ptiles, f"plain ({mis})")
        check(name, census, pcensus, f"the plain census ({mis})")
        cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
        for t, (spec, mi) in enumerate(zip(specs, mis)):
            one = ce.compute_tile_cuda_device(spec, mi, cycle_check=cyc,
                                              device=dev, **k1_kw)
            check(name, tiles[t], one, f"K1 per tile ({mis})")
        return tiles

    for specs, mis in sets:
        for jc in ((None, JULIA_C) if specs[0].width == 128 else (None,)):
            jkw = mega_kw({"julia_c": jc}, len(specs)) if jc else {}
            tiles = against_plain_and_k1(
                "escape_mega_mxu", specs, mis,
                {"use_mxu": True, "julia_c": jc}, use_mxu=True, **jkw)
            if admitted:
                cached, _ = ce.compute_tiles_mega_cuda(
                    specs, mis, use_mxu=False, device=dev, **jkw)
                check("escape_mega_mxu", tiles, cached,
                      f"the cached form ({mis})")
    for mode, kw in MEGA_MODES.items():
        for specs, mis in ((views[:4], [256, 1024, 2000, 300]),
                           ([render_view(mode, TileSpec),
                             neighbour(render_view(mode, TileSpec))],
                            [1024, 2000])):
            against_plain_and_k1(f"escape_mega_{mode}", specs, mis, kw,
                                 **mega_kw(kw, len(specs)))


# K1's and K2's forms for the refill stress cases: each K2 mode, K8 in
# Mandelbrot and Julia mode (K1 keywords; the K2 counter each launches).
STRESS_FORMS = {"mandelbrot": ({}, "escape_mega"),
                "julia": (MODES["julia"], "escape_mega_julia"),
                "multibrot": (MODES["multibrot3"], "escape_mega_multibrot"),
                "ship": (MODES["ship"], "escape_mega_ship"),
                "mxu": ({"use_mxu": True}, "escape_mega_mxu"),
                "mxu_julia": ({"use_mxu": True, **MODES["julia"]},
                              "escape_mega_mxu")}


def stress_batch(TileSpec, seed: int = 5, k: int = 128, side: int = 64,
                 top: int = 2000):
    """k views of side^2 on boundary windows of every scale, with budgets
    drawn from 1-``top`` (1 through 9 among them), from a numpy seed."""
    rng = np.random.default_rng(seed)
    anchors = np.array([(-0.745, 0.11), (-0.2, 0.7), (-1.25, 0.0),
                        (0.28, 0.01), (-0.5, -0.5), (0.0, 0.0),
                        (-1.75, -0.03), (0.35, 0.35)])
    specs = []
    for t in range(k):
        cx, cy = anchors[t % len(anchors)] + rng.normal(0, 0.02, 2)
        span = float(10 ** rng.uniform(-3, 0.5))
        specs.append(TileSpec(cx - span / 2, cy - span / 2, span, span,
                              width=side, height=side))
    mis = [int(m) for m in rng.integers(1, top + 1, k)]
    mis[:9] = list(range(1, 10))
    return specs, mis


def check_refill_stress(ce, TileSpec, check) -> None:
    """The persistent loop where refill and the end game bite, bitwise:
    K2 at k = 128 tiles of 64^2 with budgets from 1-2000 (1-9 included)
    in every mode and K8 form, against its plain version (census as
    integers) and per tile against K1; K1 and K2 on a 7x3 tile at
    budgets 1-9, 17 and 1500 in every form; two K2 launches in flight at
    once on two streams of cuda:0, each against its plain version.  Then
    K3 and K5 (check_k3_k5_stress)."""
    dev = torch.device("cuda", 0)

    def mega(name, specs, mis, kw, per_tile=True):
        mkw = mega_kw(kw, len(specs))
        tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=dev,
                                                   **mkw)
        rows, mrds, pkw = ce.mega_dispatch_plan(specs, mis, **mkw)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev,
                                               **pkw)
        check(name, tiles, ptiles, f"plain (stress, {len(specs)} tiles)")
        check(name, census, pcensus, "the plain census (stress)")
        if per_tile:
            cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
            for t, (spec, mi) in enumerate(zip(specs, mis)):
                one = ce.compute_tile_cuda_device(spec, mi, cycle_check=cyc,
                                                  device=dev, **kw)
                check(name, tiles[t], one, f"K1 per tile (stress, mi {mi})")

    specs, mis = stress_batch(TileSpec)
    tiny = TileSpec(-0.8, 0.1, 0.2, 0.1, width=7, height=3)
    tiny2 = TileSpec(-0.745, 0.11, 0.01, 0.01, width=7, height=3)
    for form, (kw, name) in STRESS_FORMS.items():
        mega(name, specs, mis, kw)
        k1_name = "escape_tile_mxu" if kw.get("use_mxu") else "escape_tile"
        for mi in (*range(1, 10), 17, 1500):
            got = ce.compute_tile_cuda_device(tiny, mi, device=dev, **kw)
            want = ce.escape_tile_plain(
                ce._params_row(tiny, kw.get("julia_c")), mi, 3, 7,
                cycle_check=ce.escape_time.resolve_cycle_check(None, mi),
                device=dev, **{k: v for k, v in kw.items()
                               if k != "julia_c"})
            check(k1_name, got, want, f"plain (7x3, {form}, mi {mi})")
            mega(name, [tiny, tiny2], [mi, 300], kw)
    # Two launches in flight at once, each on its own stream and counter.
    specs, mis = stress_batch(TileSpec, seed=11, k=64)
    halves = [(specs[:32], mis[:32]), (specs[32:], mis[32:])]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    got = []
    for (sp, mi), st in zip(halves, streams):
        with torch.cuda.stream(st):
            got.append(ce.compute_tiles_mega_cuda(sp, mi, device=dev))
    torch.cuda.synchronize()
    for (sp, mi), (tiles, census) in zip(halves, got):
        rows, mrds, kw = ce.mega_dispatch_plan(sp, mi)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev, **kw)
        check("escape_mega", tiles, ptiles, "plain (two streams at once)")
        check("escape_mega", census, pcensus,
              "the plain census (two streams at once)")
    check_k3_k5_stress(ce, TileSpec, check)
    check_k4_k6_stress(ce, TileSpec, check)
    check_k7_stress(ce, TileSpec, check)


# K7's stress rounds: from it0 (after a phase of it0 - 1 steps, so the
# lanes' groups fall off and on multiples of 8) for these many steps,
# None running to the deepest budget.
RESUME_IT0 = (257, 62)
RESUME_SEGS = (1, 7, 256, None)


def check_k7_stress(ce, TileSpec, check) -> None:
    """K7 over lists of lanes, bitwise against its plain version
    (z as bits, n, act): the live lanes of 300 tiles of 32^2 with budgets
    1-1000 (1-9 included) after phases of 256 and 61 steps, in every
    mode, rounds of 1, 7 and 256 steps and to the end, each packed (the
    flat form) and over an index list into K6's planes (int64, and int32
    for the rounds to the end); the list's halves as two launches at once
    on two streams."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    dev = torch.device("cuda", 0)
    specs, mis = stress_batch(TileSpec, k=300, side=32, top=STATE_TOP)
    dyn = torch.from_numpy(np.repeat(np.asarray(mis, np.int32) - 1,
                                     32 * 32)).to(dev)
    for mode, kw in MODES.items():
        rows = np.asarray([ce._params_row(sp, kw.get("julia_c"))
                           for sp in specs], np.float32)
        fam = mode_args(kw)
        for it0 in RESUME_IT0:
            planes = [t.reshape(-1).contiguous() for t in
                      cx.escape_state_cuda(rows, mis, height=32, width=32,
                                           phase_budget=it0 - 1, device=dev,
                                           **fam)]
            live = torch.nonzero(planes[5]).squeeze(1)
            packed = [t[live].contiguous() for t in planes]
            for seg in RESUME_SEGS:
                seg = seg or max(mis) - it0
                what = f"({mode}, it0 {it0}, seg {seg}"
                want = cx.escape_resume_plain(it0, seg, dyn[live], *packed,
                                              **fam)
                got = cx.escape_resume_cuda(it0, seg, dyn[live],
                                            *(t.clone() for t in packed),
                                            **fam)
                for g, w in zip(got, want):
                    check("escape_resume", g, w, f"plain {what}, packed)")
                lists = [live] + ([live.to(torch.int32)]
                                  if seg == max(mis) - it0 else [])
                for idx in lists:
                    got = cx.escape_resume_cuda(
                        it0, seg, dyn, *(t.clone() for t in planes),
                        idx=idx, **fam)
                    for g, w in zip(got, want):
                        check("escape_resume", g[live], w,
                              f"plain {what}, {idx.dtype} list)")
            fresh = [t.clone() for t in planes]
            half = live.numel() // 2
            streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
            torch.cuda.synchronize()
            for part, st in zip((live[:half], live[half:]), streams):
                with torch.cuda.stream(st):
                    cx.escape_resume_cuda(it0, max(mis), dyn, *fresh,
                                          idx=part, **fam)
            torch.cuda.synchronize()
            want = cx.escape_resume_plain(it0, max(mis), dyn, *planes,
                                          idx=live, **fam)
            for g, w in zip(fresh[2:], want):
                check("escape_resume", g, w,
                      f"plain ({mode}, it0 {it0}, two streams at once)")


# The compacted pipeline's phases in kernel_vs_plain: the policy's, and
# the reference's overflow case's (more live lanes than its capacity).
PIPELINE_PHASES = (256, 64)

# K4's stress budgets; K6's 300 tiles' top budget and phases.
SMOOTH_BUDGETS = (*range(1, 10), 17, 1500)
STATE_TOP = 1000
STATE_PHASES = (256, 61)


def check_k4_k6_stress(ce, TileSpec, check) -> None:
    """K4 on the persistent loop and K6, bitwise: K4 in every mode on
    7x3 and 64^2 windows (one whose pixel (0, 0) is c = -2, which stops at
    the step limit) at budgets 1-9, 17 and 1500, with the probe by the
    budget's policy and armed, the two launches in flight at once on two
    streams; K6 at k = 300 tiles of 64^2 with budgets 1-1000 in every mode
    at phases 256 and 61, and at k = 65,537 tiles of 4x32 (past one
    launch's 65,535 grid slices), tile t repeating distinct tile t % 7."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    dev = torch.device("cuda", 0)
    windows = [TileSpec(-0.8, 0.1, 0.2, 0.1, width=7, height=3),
               TileSpec(-0.8, 0.1, 0.2, 0.1, width=64, height=64),
               TileSpec(-2.0, 0.0, 0.5, 0.5, width=64, height=64)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for mode, kw in MODES.items():
        for spec in windows:
            for mi in SMOOTH_BUDGETS:
                cycles = (ce.escape_time.resolve_cycle_check(None, mi), True)
                torch.cuda.synchronize()
                got = []
                for st, cyc in zip(streams, cycles):
                    with torch.cuda.stream(st):
                        got.append(ce.compute_tile_smooth_cuda(
                            spec, mi, cycle_check=cyc, device=dev, **kw))
                torch.cuda.synchronize()
                for g, cyc in zip(got, cycles):
                    want = ce.escape_smooth_plain(
                        ce._params_row(spec, kw.get("julia_c")), mi,
                        spec.height, spec.width, cycle_check=cyc,
                        device=dev, **mode_args(kw))
                    check("escape_smooth", g, want,
                          f"plain ({mode}, {spec.width}x{spec.height}, mi "
                          f"{mi}, probe {cyc}, two streams)")
    specs, mis = stress_batch(TileSpec, k=300, top=STATE_TOP)
    for mode, kw in MODES.items():
        rows = np.asarray([ce._params_row(sp, kw.get("julia_c"))
                           for sp in specs], np.float32)
        for phase in STATE_PHASES:
            got = cx.escape_state_cuda(rows, mis, height=64, width=64,
                                       phase_budget=phase, device=dev,
                                       **mode_args(kw))
            want = cx.escape_state_plain(rows, mis, height=64, width=64,
                                         phase_budget=phase, device=dev,
                                         **mode_args(kw))
            for g, w in zip(got, want):
                check("escape_state", g, w,
                      f"plain (300 tiles, {mode}, phase {phase})")
    base = [TileSpec(-0.75 + 0.01 * i, 0.1 - 0.003 * i, 0.02 * (i + 1),
                     0.01, width=32, height=4) for i in range(7)]
    base_mis = [1, 2, 9, 17, 257, 300, 1000]
    rows = np.asarray([ce._params_row(sp) for sp in base], np.float32)
    idx = np.arange(65_537) % 7
    got = cx.escape_state_cuda(rows[idx], [base_mis[i] for i in idx],
                               height=4, width=32, device=dev)
    want = cx.escape_state_plain(rows, base_mis, height=4, width=32,
                                 device=dev)
    pick = torch.from_numpy(idx).to(dev)
    for g, w in zip(got, want):
        check("escape_state", g, w[pick], "plain (65,537 tiles of 4x32)")


# K5's stress budgets, each in every position of a pack.
PACK_BUDGETS = (*range(1, 10), 17, 1500)


def check_k3_k5_stress(ce, TileSpec, check) -> None:
    """K3 and K5 on the persistent loop, bitwise: K3 at k = 300 tiles of
    64^2 (past one K2 launch) with budgets 1-5000 (1-9 included) in every
    mode, against its plain version and per tile against K1, the same
    batch's halves in flight at once on two streams; K3 at k = 65,537
    tiles of 4x32 (past the 65,535 of a grid's z extent) repeating 7
    distinct tiles; K5 at n = 1-4 in every mode on 7x3 and 64^2 windows,
    the budgets 1-9, 17 and 1500 in every position, against its plain
    version and per plane against K1."""
    dev = torch.device("cuda", 0)
    specs, mis = stress_batch(TileSpec, k=300, top=5000)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    for mode, kw in MODES.items():
        rows = np.asarray([ce._params_row(sp, kw.get("julia_c"))
                           for sp in specs], np.float32)
        got = ce.compute_tiles_batch_cuda(rows, mis, height=64, width=64,
                                          device=dev, **mode_args(kw))
        want = ce.escape_batch_plain(rows, mis, height=64, width=64,
                                     cycle_check=cyc, device=dev,
                                     **mode_args(kw))
        check("escape_batch", got, want, f"plain (stress, 300 tiles, {mode})")
        for t, (row, mi) in enumerate(zip(rows, mis)):
            one = ce.compute_tile_row_cuda(row, mi, 64, 64, cycle_check=cyc,
                                           device=dev, **mode_args(kw))
            check("escape_batch", got[t], one,
                  f"K1 per tile (stress, {mode}, mi {mi})")
        if mode != "mandelbrot":
            continue
        halves = [(rows[:150], mis[:150]), (rows[150:], mis[150:])]
        streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
        torch.cuda.synchronize()
        outs = []
        for (r, m), st in zip(halves, streams):
            with torch.cuda.stream(st):
                outs.append(ce.compute_tiles_batch_cuda(
                    r, m, height=64, width=64, cycle_check=cyc, device=dev))
        torch.cuda.synchronize()
        check("escape_batch", torch.cat(outs), want,
              "plain (two K3 launches at once on two streams)")
    base = [TileSpec(-0.75 + 0.01 * i, 0.1 - 0.003 * i, 0.02 * (i + 1),
                     0.01, width=32, height=4) for i in range(7)]
    base_mis = [1, 2, 9, 17, 300, 1500, 5000]
    rows = np.asarray([ce._params_row(sp) for sp in base], np.float32)
    idx = np.arange(65_537) % 7
    got = ce.compute_tiles_batch_cuda(rows[idx], [base_mis[i] for i in idx],
                                      height=4, width=32, device=dev)
    want = ce.escape_batch_plain(
        rows, base_mis, height=4, width=32, device=dev,
        cycle_check=ce.escape_time.resolve_cycle_check(None, 5000))
    check("escape_batch", got, want[torch.from_numpy(idx).to(dev)],
          "plain (65,537 tiles of 4x32)")
    for mode, kw in MODES.items():
        for w, h in ((7, 3), (64, 64)):
            base = TileSpec(-0.8, 0.1, 0.2, 0.1, width=w, height=h)
            for n in range(1, 5):
                wins = [shifted(base, dx, dy) for dx, dy in SS4[:n]]
                for i in range(len(PACK_BUDGETS)):
                    pm = [PACK_BUDGETS[(i + j) % len(PACK_BUDGETS)]
                          for j in range(n)]
                    got = pack_call(ce, wins, pm, kw, dev)
                    check("escape_pack", got, plain_pack(ce, wins, pm, kw,
                                                         dev),
                          f"plain ({mode}, {w}x{h}, mis {pm})")
                    cyc = ce.escape_time.resolve_cycle_check(None, max(pm))
                    for t, (sp, mi) in enumerate(zip(wins, pm)):
                        one = ce.compute_tile_cuda_device(
                            sp, mi, cycle_check=cyc, device=dev, **kw)
                        check("escape_pack", got[t], one,
                              f"K1 per plane ({mode}, {w}x{h}, mis {pm})")


def check_mesh_kernels(ce, TileSpec, views, check) -> int:
    """The mesh routes' kernels, bitwise: K3 at k = 2 and 4 with mixed
    budgets in every mode on the 128^2 views and, for Mandelbrot, on
    4096^2 chunks at budgets 256, 1024 and 5000 (the probe armed), each
    plane also against K1; K6's six planes and one K7 round (floats
    compared as bits) against their plain versions; the compacted
    pipeline against K3 on boundary batches, with and without the
    overflow path."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    dev = torch.device("cuda", 0)

    deep = [TileSpec.for_chunk(10, i, j) for i, j in ((3, 5), (3, 4),
                                                       (2, 4), (2, 5))]
    shallow = [TileSpec.for_chunk(4, i, j) for i, j in ((1, 1), (1, 2),
                                                         (3, 3))]
    sets = [(views[:2], [2000, 256]), (views[1:], [256, 1024, 5000, 300]),
            (shallow[:2], [5000, 256]),
            ([shallow[0], deep[0], shallow[2], deep[1]],
             [256, 1024, 5000, 300])]
    for mode, kw in MODES.items():
        jc, fam = kw.get("julia_c"), mode_args(kw)
        for specs, mis in sets:
            if mode != "mandelbrot" and specs[0].width > 128:
                continue
            h, w = specs[0].height, specs[0].width
            rows = np.asarray([ce._params_row(sp, jc) for sp in specs],
                              np.float32)
            got = ce.compute_tiles_batch_cuda(rows, mis, height=h, width=w,
                                              device=dev, **fam)
            cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
            want = ce.escape_batch_plain(rows, mis, height=h, width=w,
                                         cycle_check=cyc, device=dev, **fam)
            check("escape_batch", got, want, f"plain ({mode}, {mis})")
            for t, (row, mi) in enumerate(zip(rows, mis)):
                one = ce.compute_tile_row_cuda(row, mi, h, w, cycle_check=cyc,
                                               device=dev, **fam)
                check("escape_batch", got[t], one, f"K1 ({mode}, {mis})")
        # K6, K7 and the pipeline: boundary views at budgets in the
        # compaction band (and one that fits in phase 1).
        rows = np.asarray([ce._params_row(sp, jc) for sp in views[:4]],
                          np.float32)
        mis = [700, 650, 200, 1000]
        state = cx.escape_state_cuda(rows, mis, height=128, width=128,
                                     device=dev, **fam)
        plain = cx.escape_state_plain(rows, mis, height=128, width=128,
                                      device=dev, **fam)
        for got, want in zip(state, plain):
            check("escape_state", got, want, f"plain ({mode})")
        lanes = [t.reshape(-1).contiguous() for t in plain]
        dyn = torch.from_numpy(np.repeat(np.asarray(mis, np.int32) - 1,
                                         128 * 128)).to(dev)
        want = cx.escape_resume_plain(257, 256, dyn, *lanes, **fam)
        got = cx.escape_resume_cuda(257, 256, dyn,
                                    *(t.clone() for t in lanes), **fam)
        for g, w_ in zip(got, want):
            check("escape_resume", g, w_, f"plain ({mode})")
        k3 = ce.compute_tiles_batch_cuda(rows, mis, height=128, width=128,
                                         device=dev, **fam)
        for phase in PIPELINE_PHASES:
            out = cx.compact_escape_batch(rows, mis, k=4, height=128,
                                          width=128, max_iter=max(mis),
                                          phase_budget=phase, device=dev,
                                          **fam)
            check("escape_resume", out, k3,
                  f"the pipeline vs K3 ({mode}, phase {phase})")
    # The pipeline at 4096^2 on the seahorse valley's edge.
    rows = np.asarray([ce._params_row(sp) for sp in deep[:2]], np.float32)
    k3 = ce.compute_tiles_batch_cuda(rows, [1000, 1000], height=4096,
                                     width=4096, device=dev)
    for phase in PIPELINE_PHASES:
        out = cx.compact_escape_batch(rows, [1000, 1000], k=2, height=4096,
                                      width=4096, max_iter=1000,
                                      phase_budget=phase, device=dev)
        check("escape_resume", out, k3,
              f"the 4096^2 pipeline vs K3 (phase {phase})")
    check_fused_over_one_launch(ce, TileSpec, check)


def check_fused_over_one_launch(ce, TileSpec, check) -> None:
    """Fused batches past one K2 launch's 128 tiles: 129 chunks of level
    12 at 64^2 (budgets 1-300, numpy seed) through CudaBackend's
    dispatch_many on cuda:0 (launches of 128 and 1) and on the ring
    [cuda:0, cuda:0] (a launch per shard of 65), with no demotion, each
    tile against K1; 300 tiles through compute_tiles_mega_sharded on the
    ring (shards of 150, each split in two), pixels and census against
    the one-device route and its plain version."""
    from distributedmandelbrot_tpu_torch import worker as wk
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.obs import names
    from distributedmandelbrot_tpu_torch.parallel import sharding as sh
    from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    ring = make_mesh([dev, dev])
    rng = np.random.default_rng(29)
    ws = [Workload(12, int(m), i % 12, i // 12)
          for i, m in enumerate(rng.integers(1, 301, 129))]
    cyc = ce.escape_time.resolve_cycle_check(None,
                                             max(w.max_iter for w in ws))
    for mesh in (None, ring):
        backend = wk.CudaBackend(definition=64, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        handles = backend.dispatch_many(ws)
        torch.cuda.synchronize()
        launches = ce.launch_counts()["escape_mega"]
        demoted = [backend.demotions(r) for r in (
            names.ROUTE_MESH_TO_FUSED, names.ROUTE_FUSED_TO_PER_TILE)]
        if launches != 2 or any(demoted) or not all(
                isinstance(h, wk.MegaTileHandle) for h in handles):
            where = "the ring" if mesh else "cuda:0"
            raise AssertionError(f"129-tile batch on {where}: {launches} "
                                 f"launches, demotions {demoted}")
        for w, h in zip(ws, handles):
            spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                      definition=64)
            one = ce.compute_tile_cuda_device(spec, w.max_iter,
                                              cycle_check=cyc, device=dev)
            check("escape_mega", h.pixels, one, "K1 per tile (129 tiles)")
    specs, mis = stress_batch(TileSpec, seed=13, k=300, side=16, top=300)
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    tiles, scout = sh.compute_tiles_mega_sharded(specs, mis, mesh=ring)
    torch.cuda.synchronize()
    if ce.launch_counts()["escape_mega"] != 4:
        raise AssertionError(f"300 tiles on the ring: "
                             f"{ce.launch_counts()['escape_mega']} launches")
    ftiles, fscout = ce.compute_tiles_mega_cuda(specs, mis, device=dev)
    rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
    ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev, **kw)
    check("escape_mega", torch.stack(tiles), ftiles, "one device (300 tiles)")
    check("escape_mega", torch.stack(scout), fscout,
          "the one-device census (300 tiles)")
    check("escape_mega", ftiles, ptiles, "plain (300 tiles)")
    check("escape_mega", fscout, pcensus, "the plain census (300 tiles)")


# --- the perturbation route (K9, K10) ----------------------------------------

PERTURB_SOURCE = "distributedmandelbrot_tpu_torch/ops/csrc/perturb_kernels.cu"
# No Pallas kernel: the JAX package's scans are lax.scans (XLA).
PERTURB_REPLACES = {
    "perturb_scan": "distributedmandelbrot_tpu/ops/perturbation.py:438",
    "perturb_scan_smooth":
        "distributedmandelbrot_tpu/ops/perturbation.py:1132",
}
NO_PALLAS = ("no Pallas counterpart: the JAX package computes this scan as "
             "a lax.scan under _segmented_orbit_scan (perturbation.py:342)")
NO_PERTURB_LIBRARY = ("no single PyTorch call computes a delta-orbit scan; "
                      "the plain version is a loop of elementwise ops")
# Uncontracted operations per lane-step of K9/K10 (perturb_kernels.cu),
# the per-lane work of the function: 20 with the dc term (Mandelbrot), 18
# without (Julia); 2Z and tol |Z|^2 depend on the orbit entry alone and
# are computed once per entry.  f64's rate: half of the published 34
# TFLOP/s, which counts an FMA as two.
PERTURB_OPS_PER_STEP = {True: 20, False: 18}
F64_OPS_PER_S = 34e12 / 2
# A lane's outputs: K9 n (4 B) and three masks (1 B each); K10 n, n2
# (4 B each), the frozen value (two of the dtype) and three masks.
K9_OUT_BYTES = 7
CONFIG4 = ("-0.77568376995", "0.13646737005")
BOND = ("0.375", "0.2165063509461096616909307926882340458678500")
JULIA_DEEP = (("0.1", "0.2"), 1e-6, 3000, ("-0.8", "0.156"))
MINIBROT3 = ("-1.7548776662466927", "0.0")
# The period-349 minibrot's nucleus (benchmark/configs/deep-minibrot349.json)
# and its view's span: most lanes run the whole 50,012-entry orbit.
NUCLEUS_349 = ("-0.7756837700816288677685612253565279731949",
               "0.1364673698317589362266084123703078253727")
SPAN_349 = 1.5e-17


def deep_inputs(pt, center, span, side, max_iter, dtype, dev, julia_c=None,
                orbit_len=None):
    """A view's reference orbit (the route's search) and its deltas as
    the route feeds the scans: the orbit on the card in f64, the row and
    column vectors broadcast."""
    spec = pt.DeepTileSpec(*center, span, width=side, height=side)
    need = int(-np.log2(spec.step)) + 64
    bits = max(pt.DEFAULT_PREC_BITS, -(-need // 128) * 128)
    za, zb = pt._to_fixed(center[0], bits), pt._to_fixed(center[1], bits)
    ca, cb = ((za, zb) if julia_c is None else
              (pt._to_fixed(julia_c[0], bits), pt._to_fixed(julia_c[1], bits)))
    orbit, o_re, o_im = pt._find_reference(
        za, zb, ca, cb, span, max_iter, bits, add_dc=julia_c is None,
        device=str(dev))
    z_re, z_im = orbit.z_re[:orbit_len], orbit.z_im[:orbit_len]
    col = (np.arange(side) - (side - 1) / 2) * spec.step
    row = torch.as_tensor((col - o_re).astype(dtype), device=dev)
    colv = torch.as_tensor((col - o_im).astype(dtype), device=dev)
    return (torch.as_tensor(z_re, device=dev),
            torch.as_tensor(z_im, device=dev),
            row[None, :].expand(side, side), colv[:, None].expand(side, side),
            julia_c is None)


def check_perturb_kernels(check) -> None:
    """K9 and K10 against their plain versions on the card, bitwise on
    every state output: f32 and f64, Mandelbrot (the config-4 view) and
    Julia, 256^2 and 512^2, K9 with the stagnation stop armed and not;
    an orbit shorter than the budget (300 entries: one whole segment and
    a ragged tail); a stagnation stop (the period-3 minibrot at 16^2,
    budget 20000, its in-set lanes suspect); many segments with more
    lanes live than the stop's cap (the minibrot at 256^2, f32); and K10
    over the whole 50,012-entry orbit (the period-349 minibrot at 64^2,
    f64)."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    dev = torch.device("cuda", 0)

    def both(label, inputs, stagnations=(True, False), smooth=True):
        zr, zi, dre, dim, add_dc = inputs
        state = None
        for stag in stagnations:
            got = cp.perturb_state_cuda(zr, zi, dre, dim, add_dc=add_dc,
                                        stagnation=stag)
            state = cp.perturb_state_plain(zr, zi, dre, dim, add_dc=add_dc,
                                           stagnation=stag)
            for g, w in zip(got, state):
                check("perturb_scan", g, w,
                      f"plain ({label}, stagnation {stag})")
        if smooth:
            got = cp.perturb_smooth_state_cuda(zr, zi, dre, dim,
                                               bailout=256.0, add_dc=add_dc)
            want = cp.perturb_smooth_state_plain(zr, zi, dre, dim,
                                                 bailout=256.0,
                                                 add_dc=add_dc)
            for g, w in zip(got, want):
                check("perturb_scan_smooth", g, w, f"plain ({label})")
        return state

    for dtype in (np.float32, np.float64):
        for side in (256, 512):
            both(f"config-4, {side}^2, {dtype.__name__}",
                 deep_inputs(pt, CONFIG4, 1e-10, side, 50000, dtype, dev))
            center, span, mi, jc = JULIA_DEEP
            both(f"Julia, {side}^2, {dtype.__name__}",
                 deep_inputs(pt, center, span, side, mi, dtype, dev, jc))
        both(f"orbit of 300 < budget, {dtype.__name__}",
             deep_inputs(pt, CONFIG4, 1e-10, 256, 50000, dtype, dev,
                         orbit_len=300))
        state = both(f"stagnation stop, {dtype.__name__}",
                     deep_inputs(pt, MINIBROT3, 5e-2, 16, 20000, dtype, dev),
                     stagnations=(True,))
        if not int(state[3].sum()):
            raise AssertionError("the stagnation case flagged no lane")
    both("minibrot 256^2, 78 segments, f32",
         deep_inputs(pt, MINIBROT3, 5e-2, 256, 20000, np.float32, dev),
         stagnations=(True,))
    both("the period-349 minibrot, 64^2, f64",
         deep_inputs(pt, NUCLEUS_349, SPAN_349, 64, 50000, np.float64, dev),
         stagnations=())


# (name, render flags): the config-4 view (BASELINE config 4, a
# Misiurewicz window: an early-escaping reference) integer in f32 at
# 1024^2 and 4096^2 and smooth in f64 at 1024^2, and the period-6 bond
# point's view, where every pixel runs the whole budget and the probe
# turns BLA on.
DEEP_RENDERS = [
    ("config4_1024", ["--deep", f"--center={CONFIG4[0]},{CONFIG4[1]}",
                      "--span", "1e-10", "--max-iter", "50000",
                      "--definition", "1024"]),
    ("config4_1024_smooth_f64", ["--deep",
                                 f"--center={CONFIG4[0]},{CONFIG4[1]}",
                                 "--span", "1e-10", "--max-iter", "50000",
                                 "--definition", "1024", "--smooth",
                                 "--dtype", "f64"]),
    ("config4_4096", ["--deep", f"--center={CONFIG4[0]},{CONFIG4[1]}",
                      "--span", "1e-10", "--max-iter", "50000",
                      "--definition", "4096"]),
    ("bond_1024", ["--deep", f"--center={BOND[0]},{BOND[1]}", "--span",
                   "1e-15", "--max-iter", "20000", "--definition", "1024"]),
]
DEEP_PHASES = ("reference", "bla_probe", "bla_table", "scan",
               "repair_secondary", "repair_exact")


def clear_deep_caches(pt) -> None:
    """Forget every reference search, orbit, device orbit, BLA decision
    and table: the next render of a view starts cold."""
    pt.ORBITS.clear()


class ScanTimer:
    """CUDA events around every K9/K10 wrapper call while installed (the
    wrappers are looked up on ``cuda_perturb`` at each call)."""

    def __init__(self, cp):
        self.cp, self.pairs = cp, []
        self.real = (cp.perturb_state_cuda, cp.perturb_smooth_state_cuda)

    def _timed(self, fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.pairs.append((start, end))
            return out
        return call

    def __enter__(self):
        self.cp.perturb_state_cuda = self._timed(self.real[0])
        self.cp.perturb_smooth_state_cuda = self._timed(self.real[1])
        return self

    def __exit__(self, *exc):
        self.cp.perturb_state_cuda, self.cp.perturb_smooth_state_cuda = \
            self.real

    def take_ms(self) -> float:
        torch.cuda.synchronize()
        total = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs.clear()
        return total


def deep_render(cli, pt, cp, ce, flags, out, timer=None) -> dict:
    """One deep render through ``cli.main``, its counts set to 0 just
    before: host-clock seconds split by the route's phases (colormap,
    PNG and the rest by difference), the K9/K10 calls' time by CUDA
    events (``timer``), their launches and the colour kernel's, glitched
    and exactly repaired pixels."""
    from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    cp.reset_launch_counts()
    cc.reset_launch_counts()
    pt.reset_phase_seconds()
    t0 = time.monotonic()
    rc = cli.main(["render", *flags, "--out", out, "-q"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    phases = pt.phase_seconds()
    split = {k: phases.get(k, 0.0) for k in DEEP_PHASES}
    split["colormap_png_and_rest"] = wall - sum(split.values())
    escape = {k: v for k, v in ce.launch_counts().items() if v}
    return {"rc": rc, "seconds": wall, "split_s": split,
            "scan_kernels_device_ms": timer.take_ms() if timer else None,
            "launches": cp.launch_counts(), "escape_launches": escape,
            "colour_launches": cc.launch_counts()[cc.KERNEL_COLORMAP],
            "glitched": int(phases.get("glitched", 0)),
            "exact_repaired": int(phases.get("exact_repaired", 0)),
            "bla": "bla_table" in phases}


def sampled_exact(pt, center, span, side, max_iter, counts, seed=1) -> int:
    """Sampled pixels (12) whose count differs from the exact fixed-point
    count: the JAX package's own bar is at most 1."""
    spec = pt.DeepTileSpec(*center, span, width=side, height=side)
    need = int(-np.log2(spec.step)) + 64
    bits = max(pt.DEFAULT_PREC_BITS, -(-need // 128) * 128)
    za, zb = pt._to_fixed(center[0], bits), pt._to_fixed(center[1], bits)
    rng = np.random.default_rng(seed)
    rs, cs = rng.integers(side, size=12), rng.integers(side, size=12)
    pts = [(za + pt._to_fixed(float((c - (side - 1) / 2) * spec.step), bits),
            zb + pt._to_fixed(float((r - (side - 1) / 2) * spec.step), bits))
           for r, c in zip(rs, cs)]
    exact = pt._escape_counts_exact_batch(pts, max_iter, bits, None)
    return int((counts[rs, cs] != exact).sum())


def phase_deep_path(cli, ce):
    """The deep views through ``render``: each launches K9 (integer) or
    K10 (smooth) and never the plain scans on the card, writes the PNG
    of the same route with the plain scans byte for byte, and the
    config-4 view's sampled pixels equal the exact fixed-point counts;
    the bond view takes BLA; the smooth view is coloured by one launch of
    the colour kernel.  Each view runs twice: cold (every cache of
    the route emptied first: the reference search and orbit computed)
    and warm (cached, as a re-render)."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    launches = {"perturb_scan": 0, "perturb_scan_smooth": 0,
                KERNEL_COLORMAP: 0}
    views = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in DEEP_RENDERS:
            out = os.path.join(tmp, f"{name}.png")
            clear_deep_caches(pt)
            with ScanTimer(cp) as timer:
                cold = deep_render(cli, pt, cp, ce, flags, out, timer)
                warm = deep_render(cli, pt, cp, ce, flags, out, timer)
            for k, v in cold["launches"].items():
                launches[k] += v
            launches[KERNEL_COLORMAP] += cold["colour_launches"]
            with open(out, "rb") as fh:
                got = fh.read()
            smooth = "--smooth" in flags
            kernel = "perturb_scan_smooth" if smooth else "perturb_scan"
            # The same route with the plain scans on the card (K10's
            # count of staged tiles has no plain counterpart).
            real = (cp.perturb_state_cuda, cp.perturb_smooth_state_cuda)
            cp.perturb_state_cuda = cp.perturb_state_plain
            cp.perturb_smooth_state_cuda = (
                lambda *a, tiles=None, **k:
                cp.perturb_smooth_state_plain(*a, **k))
            try:
                plain_out = os.path.join(tmp, f"{name}_plain.png")
                plain = deep_render(cli, pt, cp, ce, flags, plain_out)
            finally:
                cp.perturb_state_cuda, cp.perturb_smooth_state_cuda = real
            with open(plain_out, "rb") as fh:
                png_equal = fh.read() == got
            ok = (cold["rc"] == warm["rc"] == 0 and not cold["escape_launches"]
                  and png_equal and sum(plain["launches"].values()) == 0
                  and cold["colour_launches"] == warm["colour_launches"]
                  == int(smooth))
            if name.startswith("bond"):
                ok = ok and cold["bla"]
            else:
                ok = ok and cold["launches"][kernel] > 0
            views[name] = {"cold": cold, "warm": warm,
                           "png_equal_plain": png_equal,
                           "plain_route_seconds": plain["seconds"]}
            if not ok:
                raise AssertionError(f"deep view {name}: {views[name]}")
        counts, flagged = pt.compute_counts_perturb(
            pt.DeepTileSpec(*CONFIG4, 1e-10, width=1024, height=1024), 50000)
        off = sampled_exact(pt, CONFIG4, 1e-10, 1024, 50000, counts)
        if off > 1:
            raise AssertionError(f"config-4: {off} of 12 sampled pixels "
                                 "differ from the exact counts")
        bond_counts, _ = pt.compute_counts_perturb(
            pt.DeepTileSpec(*BOND, 1e-15, width=1024, height=1024), 20000)
        if bond_counts.any():
            raise AssertionError("the bond view left the set under BLA")
    record = {"phase": "deep_path", "ok": True, "views": views,
              "launches": launches, "config4_sampled_off_exact": off,
          "timing": "host clock around cli.main, ended by "
                    "torch.cuda.synchronize(); split_s by the route's "
                    "phases, the scans' share each to its fetch; "
                    "scan_kernels_device_ms: CUDA events around each "
                    "K9/K10 wrapper call (the K9 host loop's reads of its "
                    "segment counts included)"}
    emit(record)
    return record


KERNEL_COLORMAP = "colormap_rgba8"
COLORMAP_SOURCE = ("distributedmandelbrot_tpu_torch/ops/csrc/"
                   "colormap_kernels.cu")
NO_PALLAS_COLORMAP = ("no Pallas counterpart: the JAX package colours on "
                      "the host (serve/render.py smooth_to_rgba, then "
                      "imsave_bytes)")
NO_COLORMAP_LIBRARY = ("no single PyTorch call maps values to table rows "
                       "and bytes; the plain version is searchsorted and "
                       "a gather")
# A pixel's bytes: nu read (f64), RGBA8 written.
COLORMAP_BYTES_PER_PIXEL = 8 + 4


def time_colormap_kernel(ptxas) -> list:
    """The colour kernel on the config-4 view's repaired smooth values
    (f64, max_iter 50000, jet) at 1024^2 and 4096^2, nu already on the
    card: ``ms`` by CUDA events around a wrapper call, as every row of
    the kernels line is timed (a kernel this short waits there for the
    launch's host path), and ``device_ms``, the median of 50 launches'
    kernel intervals in a ``torch.profiler`` trace; the plain version on
    the card; the route's colouring (``serve.render._smooth_rgba8``: nu
    up, the launch, the bytes down) and the host's float route
    (``imsave_bytes(smooth_to_rgba(...))``) by the host clock.  The
    kernel must equal both byte for byte; bound = 12 bytes a pixel over
    3.35 TB/s."""
    from torch.profiler import ProfilerActivity, profile
    from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    from distributedmandelbrot_tpu_torch.serve import render as srender
    dev = torch.device("cuda", 0)
    bounds = torch.tensor(srender.smooth_boundaries(50000), device=dev)
    table = torch.tensor(srender.smooth_table8("jet"), device=dev)

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    rows = []
    for side in (1024, 4096):
        nu, _ = pt.compute_smooth_perturb(
            pt.DeepTileSpec(*CONFIG4, 1e-10, width=side, height=side), 50000,
            dtype=np.float64, device=dev)
        x = torch.from_numpy(nu).to(dev)
        ms = median_ms(lambda: cc.colormap_rgba8_cuda(x, bounds, table),
                       reps=50)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                cc.colormap_rgba8_cuda(x, bounds, table)
            torch.cuda.synchronize()
        device_ms = statistics.median(
            e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "colormap_rgba8_kernel" in e.name)
        plain_ms = median_ms(lambda: cc.colormap_rgba8_plain(x, bounds,
                                                             table),
                             reps=5, warmup=1)
        route_ms = host_ms(lambda: srender._smooth_rgba8(nu, 50000, "jet",
                                                         dev), reps=11)
        float_ms = host_ms(lambda: srender.imsave_bytes(
            srender.smooth_to_rgba(nu, 50000)), reps=3)
        got = cc.colormap_rgba8_cuda(x, bounds, table)
        torch.cuda.synchronize()
        bytewise_plain = bool(torch.equal(
            got, cc.colormap_rgba8_plain(x, bounds, table)))
        bytewise_float = bool(np.array_equal(
            got.cpu().numpy(),
            srender.imsave_bytes(srender.smooth_to_rgba(nu, 50000))))
        bound_ms = side * side * COLORMAP_BYTES_PER_PIXEL / HBM_BYTES_PER_S \
            * 1e3
        rows.append({
            "name": KERNEL_COLORMAP, "side": side, "dtype": "float64",
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "route_host_ms": route_ms,
            "float_route_host_ms": float_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / ms,
            "device_share_of_bound": bound_ms / device_ms,
            "bitwise_vs_plain": bytewise_plain,
            "bitwise_vs_float_route": bytewise_float,
            "registers": ptxas.get("colormap_rgba8_kernel", {}).get(
                "registers")})
        if not (bytewise_plain and bytewise_float):
            raise AssertionError(f"the colour kernel at {side}^2 differs "
                                 "from its plain version or the float "
                                 "route")
    return rows


def colormap_rows(launches: dict, ptxas: dict) -> list:
    """The kernels line's row of the colour kernel."""
    main, *more = time_colormap_kernel(ptxas)
    # Only the paths that count the colour kernel's launches.
    by_path = {path: counts[KERNEL_COLORMAP]
               for path, counts in launches.items()
               if KERNEL_COLORMAP in counts}
    return [{**main, "route": "cuda", "source": COLORMAP_SOURCE,
             "replaces": None, "replaces_note": NO_PALLAS_COLORMAP,
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": 0, "library_ms": None,
             "library_reason": NO_COLORMAP_LIBRARY,
             "input": "the config-4 view's repaired smooth values at "
                      "1024^2, f64, max_iter 50000, jet",
             "other_inputs": more}]


def perturb_needed_steps(n, active, orbit_len: int) -> int:
    """Lane-steps these inputs need (the plain version's per-lane work
    to its last test): a lane that escaped ran its n passed tests and
    the one it failed; a lane still live ran the whole orbit."""
    steps = torch.where(active, torch.full_like(n, orbit_len), n + 1)
    return int(steps.to(torch.int64).sum())


def time_perturb_kernels(ptxas) -> list:
    """K9 on the config-4 view at 4096^2 as the route launches it (16
    row chunks of 256 rows, f32, the stagnation stop armed) and on one
    1024^2 chunk; K10 on the smooth f64 view at 1024^2 (2 chunks of 512
    rows), and on the period-349 minibrot's (its plain version not run:
    50,012 steps of some 30 launches each; K10 is held bitwise there at
    64^2 in ``kernel_vs_plain``).  CUDA events around all of a view's
    chunks; the plain versions on the same chunks once; bound = the
    lane-steps these inputs need x 20 operations over the rate of the
    dtype, against the outputs' bytes.  K10's rows also give its ring's
    shared memory a block."""
    from distributedmandelbrot_tpu_torch.ops import _build
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    dev = torch.device("cuda", 0)

    def chunks(center, span, side, rows, dtype):
        zr, zi, dre, dim, _ = deep_inputs(pt, center, span, side, 50000,
                                          dtype, dev)
        return zr, zi, [(dre[r:r + rows], dim[r:r + rows])
                        for r in range(0, side, rows)]

    def regs(name, dtype):
        t = "<float" if dtype == np.float32 else "<double"
        return {k: v.get("registers") for k, v in ptxas.items()
                if k.startswith(name) and t in k}

    def spills(name, dtype):
        t = "<float" if dtype == np.float32 else "<double"
        return {k: v.get("spill_stores", 0) + v.get("spill_loads", 0)
                for k, v in ptxas.items() if k.startswith(name) and t in k}

    rows = []
    for name, view, side, rows_per, dtype, smooth in (
            ("perturb_scan", "config4", 4096, 256, np.float32, False),
            ("perturb_scan", "config4", 1024, 1024, np.float32, False),
            ("perturb_scan_smooth", "config4", 1024, 512, np.float64, True),
            ("perturb_scan_smooth", "minibrot349", 1024, 512, np.float64,
             True)):
        center, span = ((CONFIG4, 1e-10) if view == "config4" else
                        (NUCLEUS_349, SPAN_349))
        zr, zi, parts = chunks(center, span, side, rows_per, dtype)
        timed_plain = view == "config4"
        if smooth:
            run = lambda fn: [fn(zr, zi, a, b, bailout=256.0)  # noqa: E731
                              for a, b in parts]
            kern, plain = (cp.perturb_smooth_state_cuda,
                           cp.perturb_smooth_state_plain)
        else:
            run = lambda fn: [fn(zr, zi, a, b)  # noqa: E731
                              for a, b in parts]
            kern, plain = cp.perturb_state_cuda, cp.perturb_state_plain
        ms = median_ms(lambda: run(kern), reps=20 if timed_plain else 5)
        got = run(kern)
        if timed_plain:
            plain_ms = median_ms(lambda: run(plain), reps=1, warmup=0)
            want = run(plain)
            bitwise = all(torch.equal(g, w) for gs, ws in zip(got, want)
                          for g, w in zip(gs, ws))
        else:
            plain_ms, want, bitwise = None, got, None
        if smooth:
            needed = sum(perturb_needed_steps(w[0], w[4], zr.shape[0])
                         for w in want)
            out_bytes = side * side * (8 + 2 * 8 + 3)
        else:
            needed = sum(perturb_needed_steps(w[0], w[1], zr.shape[0])
                         for w in want)
            out_bytes = side * side * K9_OUT_BYTES
        rate = F32_OPS_PER_S if dtype == np.float32 else F64_OPS_PER_S
        ops = needed * PERTURB_OPS_PER_STEP[True]
        t_ops, t_bytes = ops / rate, out_bytes / HBM_BYTES_PER_S
        kname = name.replace("perturb_scan_smooth", "perturb_smooth")
        row = {
            "name": name, "view": view, "side": side,
            "dtype": np.dtype(dtype).name, "ms": ms, "plain_ms": plain_ms,
            "bitwise_vs_plain": bitwise,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "lane_steps_needed": needed, "ops": ops,
            "orbit_len": int(zr.shape[0]), "chunks": len(parts),
            "registers": regs(kname, dtype), "spills": spills(kname, dtype)}
        if smooth:
            row["ring_smem_bytes"] = _build.load(
            ).dm_perturb_smooth_ring_bytes(int(dtype == np.float64), 0,
                                           int(zr.shape[0]))
        rows.append(row)
        if bitwise is False:
            raise AssertionError(f"{name} at {side}^2 differs from its "
                                 "plain version")
    return rows


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
    return launches, workloads, n / wall


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


# The compacted pipeline's device kernels by operation, matched on the
# kernel names the profiler reports (first match wins): K6, K7; the pack
# (torch.nonzero's count and select; in the parent's rounds also the
# cumsum, the scatter by position and the arange); the gathers and
# scatters by index (none in one launch; in the parent's rounds t[orig]
# and n[orig] = ...); fills (zeroed counters); copies (the rows and
# budgets up, the live count down); every other elementwise kernel is
# the epilogue's.
SPLIT_CLASSES = (
    ("k6", r"escape_state_kernel"),
    ("k7", r"escape_resume_kernel"),
    ("pack", r"[Ss]can|[Ss]elect|[Cc]ompact|nonzero|flag_kernel|"
             r"write_indices|DeviceReduce|_scatter_gather|with_index"),
    ("gathers_and_scatters", r"index_elementwise|index_put|indexSelect|"
                             r"index_select|gather"),
    ("fills", r"FillFunctor|fill_kernel"),
    ("host_to_device", r"HtoD|Memcpy HtoD"),
    ("device_to_host", r"DtoH|Memcpy DtoH"),
    ("epilogue", r"elementwise|Functor|copy_kernel|where|reduce"),
)


# The profiler range around the call that compact_split measures.
SPLIT_MARK = "dm_split_call"
# Seconds the split's own process may take.
SPLIT_TIMEOUT_S = 300


def run_split() -> int:
    """``--split``: compact_split of the compacted pipeline on EDGE4 at
    1000, as one JSON line (a process of its own: in one that profiled
    before, the profiler missed the first device events of every range
    on an H100)."""
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    dev = torch.device("cuda", 0)
    rows = np.asarray([ce._params_row(TileSpec.for_chunk(10, i, j))
                       for i, j in EDGE4], np.float32)

    emit(compact_split(lambda: cx.compact_escape_batch(
        rows, [1000] * len(rows), k=len(rows), height=4096, width=4096,
        max_iter=1000, device=dev)))
    return 0


def run_deep(argv: list[str]) -> int:
    """``--deep [--out PATH]``: the deep route alone, in a process of its
    own.  Builds the kernels and the native library and starts CUDA
    first (each timed), so that pass 1 of ``deep_path`` is each view's
    first render in the process past its start-up and pass 2 a later
    one; then holds K9 and K10 bitwise against their plain versions and
    times them, and the colour kernel too."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch.native import bindings
    from distributedmandelbrot_tpu_torch.ops import _build
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    phase_device(_build)
    t0 = time.monotonic()
    native = bindings.native_supported()
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize()
    records = [{"card": nvidia_smi_line(), "native_library": native,
                "native_library_s": native_s,
                "cuda_start_s": time.monotonic() - t0}]
    for n in (1, 2):
        records.append({"pass": n, **phase_deep_path(cli, ce)})
    err = {"perturb_scan": 0, "perturb_scan_smooth": 0.0}
    check, cases = bitwise_checker(err)
    check_perturb_kernels(check)
    records.append({"phase": "kernel_vs_plain", "ok": True,
                    "cases": cases(), "max_abs_err": err})
    ptxas = {kernel_name(r["kernel"]): r for r in _build.ptxas_report()}
    records.append({"phase": "perturb_kernels",
                    "timed": time_perturb_kernels(ptxas)})
    records.append({"phase": "colormap_kernel",
                    "timed": time_colormap_kernel(ptxas)})
    for record in records[-3:]:
        emit(record)
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as fh:
            json.dump(records, fh, indent=1)
    print(records[0]["card"], flush=True)
    return 0


def split_in_child() -> dict:
    """run_split in a fresh process of this script."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--split"], capture_output=True, text=True,
                          timeout=SPLIT_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"the split's process failed:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compact_split(fn, tries: int = 3) -> dict:
    """One call of ``fn`` (a compacted pipeline on cuda:0, warmed up)
    under torch.profiler: its wall time (host clock, ended by a
    synchronize), the card's busy time (the union of its kernel and
    copy intervals), device ms by SPLIT_CLASSES, the device-to-host
    copies (the host reads of live counts), and the wall time the card
    sat idle (the host's launches and reads).  Kernels no class matches
    are listed under ``other``.  A profile that saw no K6 (a profile
    can miss the first device events of its range) is taken again, up
    to ``tries`` times; if none saw it, no split is reported ("not
    measured")."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SPLIT_MARK):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        mark = next(e.time_range.start for e in events
                    if e.name == SPLIT_MARK)
        # The mark's own span on the device timeline is no kernel.
        kernels = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.start >= mark and e.name != SPLIT_MARK]
        if any("escape_state_kernel" in e.name for e in kernels):
            break
    else:
        return {"wall_ms": wall, "device_ms": "not measured",
                "profiles_taken": tries,
                "reason": "no profile saw the K6 launch"}
    by_class = {name: 0.0 for name, _ in SPLIT_CLASSES}
    other: dict = {}
    spans = []
    reads = 0
    for evt in kernels:
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        ms = (end - start) / 1e3
        for name, pattern in SPLIT_CLASSES:
            if re.search(pattern, evt.name):
                by_class[name] += ms
                reads += name == "device_to_host"
                break
        else:
            other[evt.name[:80]] = other.get(evt.name[:80], 0.0) + ms
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy += (end - start) / 1e3
            last = end
        elif end > last:
            busy += (end - last) / 1e3
            last = end
    if not spans:
        return {"wall_ms": wall, "device_ms": "not measured"}
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_ms": wall - busy, "device_ms": by_class,
            "device_to_host_copies": reads, "other": other,
            "profiles_taken": attempt,
            "timing": "one call under torch.profiler (its wall is inflated "
                      "by the profiler); device ms by the kernels' names"}


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
    clock, by the route the render takes: the kernel (launch to
    synchronize), the copy of its plane to the host, the colormap, and
    the PNG (byte conversion and zlib).  The smooth view's plane stays on
    the card: its colormap is the colour kernel's route (the plane
    widened to f64 there, the launch, the bytes copied back) and its
    copy 0."""
    dev = torch.device("cuda", 0)
    spec = render_view("mandelbrot", TileSpec)
    win = [shifted(spec, dx, dy) for dx, dy in SS4]

    def to_host(plane):
        return plane.cpu().numpy()

    cases = {
        "mandelbrot": (lambda: ce.compute_tile_cuda_device(
            spec, 1024, device=dev), to_host, srender.value_to_rgba),
        "mandelbrot_smooth": (lambda: ce.compute_tile_smooth_cuda(
            spec, 1024, device=dev), lambda plane: plane,
            lambda nu: srender.smooth_to_rgba(nu, 1024, rgba8_on=dev)),
        "mandelbrot_ss4": (lambda: pack_call(ce, win, [1024] * 4, {}, dev),
                           to_host,
                           lambda planes: sum(srender.value_to_rgba(p)
                                              for p in planes) / 4),
    }
    out = {}
    for name, (compute, copy, colormap) in cases.items():
        compute()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        plane = compute()
        torch.cuda.synchronize()
        t1 = time.monotonic()
        host = copy(plane)
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
    from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
    dev = torch.device("cuda", 0)
    by_render = {}
    launches = {k: 0 for k in {**ce.launch_counts(), **cc.launch_counts()}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, kernel in RENDERS:
            out = os.path.join(tmp, f"{name}.png")
            torch.cuda.synchronize()
            ce.reset_launch_counts()
            cc.reset_launch_counts()
            cli.reset_kernel_declines()
            t0 = time.monotonic()
            rc = cli.main(["render", *flags, "--definition",
                           str(RENDER_SIDE), "--out", out, "-q"])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = {**ce.launch_counts(), **cc.launch_counts()}
            declines = cli.kernel_declines()
            # A smooth view of one sample is coloured by the colour
            # kernel too.
            coloured = {kernel, cc.KERNEL_COLORMAP} if "--smooth" in flags \
                else {kernel}
            want = {k: int(k in coloured) for k in counts}
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
                               "colour_launches": counts[cc.KERNEL_COLORMAP],
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


# The mesh path's drains: (name, workloads, env, the kernel the route
# launches).  Level 10's 16 chunks span the set's boundary around the
# seahorse valley ([-1.2, 0.4] x [-0.8, 0.8]).
LEVEL10 = [(i, j) for j in range(3, 7) for i in range(2, 6)]
MESH_DRAINS = [
    ("k3_level4_5000", [(4, 5000, i, j) for j in range(4) for i in range(4)],
     {}, "escape_batch"),
    ("compact_level10_1000", [(10, 1000, i, j) for i, j in LEVEL10],
     {"DMTPU_COMPACT": "1"}, "escape_state"),
    ("k1_chain_level10_256", [(10, 256, i, j) for i, j in LEVEL10], {},
     "escape_tile"),
]
# The 4-chunk batch of the multihost phase and of the compaction
# finding: the seahorse valley's edge at level 10.
EDGE4 = [(3, 5), (3, 4), (2, 4), (2, 5)]


def drain_mesh(wk, parallel, workloads):
    """One drain of ``workloads`` by the port's Worker with MeshBackend
    (batches of 4, the classic loop) -> (source, backend, worker, wall)."""
    source = GrantSource(workloads, [w.key for w in workloads[::5]])
    backend = parallel.MeshBackend()
    worker = wk.Worker(source, backend, batch_size=4, window=0)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rounds = worker.run_until_drained()
    torch.cuda.synchronize()
    return source, backend, rounds, time.monotonic() - t0


def phase_mesh_path(wk, ce, parallel, TileSpec, Workload):
    """The mesh route end to end, one drain per kernel route, each read
    from launch counts set to 0 just before it; then the two-shard ring
    on one card."""
    from distributedmandelbrot_tpu_torch.parallel import sharding as sh
    from distributedmandelbrot_tpu_torch.parallel.mesh import (make_mesh,
                                                               tile_row_mesh)
    dev = torch.device("cuda", 0)
    drains, launches = {}, {k: 0 for k in ce.launch_counts()}
    for name, grants, env, kernel in MESH_DRAINS:
        workloads = [Workload(*g) for g in grants]
        os.environ.update(env)
        try:
            torch.cuda.synchronize()
            ce.reset_launch_counts()
            source, backend, rounds, wall = drain_mesh(wk, parallel,
                                                       workloads)
            counts = ce.launch_counts()
        finally:
            for key in env:
                os.environ.pop(key, None)
        missing = [w.key for w in workloads if w.key not in source.crc]
        if missing or source.bad_sizes:
            raise AssertionError(f"{name}: missing {missing[:5]}, bad sizes "
                                 f"{source.bad_sizes[:5]}")
        route = {k: v for k, v in counts.items() if v}
        if kernel not in route or backend.demotions():
            raise AssertionError(f"{name}: launches {route}, demotions "
                                 f"{backend.demotions()}")
        if name.startswith("compact") and set(route) != {"escape_state",
                                                          "escape_resume"}:
            raise AssertionError(f"{name}: launches {route}")
        if not name.startswith("compact") and set(route) != {kernel}:
            raise AssertionError(f"{name}: launches {route}")
        for k, v in counts.items():
            launches[k] += v
        differ = []
        for w in workloads:
            spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag)
            one = ce.compute_tile_cuda_device(spec, w.max_iter, device=dev)
            if zlib.crc32(memoryview(one.cpu().numpy())) != source.crc[w.key]:
                differ.append(w.key)
        if differ:
            raise AssertionError(f"{name}: {len(differ)} chunks differ from "
                                 f"K1: {differ[:5]}")
        for w in workloads[::5]:
            spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag)
            plain = ce.escape_tile_plain(
                ce._params_row(spec), w.max_iter, 4096, 4096,
                cycle_check=ce.escape_time.resolve_cycle_check(
                    None, w.max_iter), device=dev)
            if not np.array_equal(source.samples[w.key],
                                  plain.cpu().numpy().ravel()):
                raise AssertionError(f"{name}: sampled chunk {w.key} "
                                     "differs from the plain version")
        n = len(workloads)
        drains[name] = {"chunks": n, "rounds": rounds, "seconds": wall,
                        "chunks_per_s": n / wall,
                        "mpix_per_s": n * 4096 * 4096 / wall / 1e6,
                        "launches": route, "demotions": 0,
                        "k1_checksum_equal": n,
                        "sample_bitwise_vs_plain": len(source.samples),
                        "env": env}

    # The ring [cuda:0, cuda:0]: two shards, each on its own stream.
    one, two = make_mesh([dev]), make_mesh([dev, dev])
    edge = [Workload(10, 1000, i, j) for i, j in EDGE4]
    ring = {}
    for name, ws, env in (
            ("mesh_backend_k3", edge + [Workload(4, 5000, 1, 1)], {}),
            ("mesh_backend_compact", edge, {"DMTPU_COMPACT": "1"})):
        os.environ.update(env)
        try:
            got = parallel.MeshBackend(mesh=two).compute_batch(ws)
            want = parallel.MeshBackend(mesh=one).compute_batch(ws)
        finally:
            for key in env:
                os.environ.pop(key, None)
        ring[name] = all(np.array_equal(a, b) for a, b in zip(got, want))
    cb = wk.CudaBackend(mesh=two)
    if cb.mesh_width != 2:
        raise AssertionError(f"ring mesh width {cb.mesh_width}")
    got = [cb.materialize_tile(h) for h in cb.dispatch_many(edge)]
    want = [cb.materialize_tile(h) for h in cb.dispatch_many(edge,
                                                             device=dev)]
    ring["cuda_backend_dispatch_many"] = all(
        np.array_equal(a, b) for a, b in zip(got, want))
    spec = TileSpec.for_chunk(10, 3, 5)
    ring["row_sharded_loop"] = bool(np.array_equal(
        sh.compute_tile_row_sharded(tile_row_mesh(1, 2, [dev, dev]), spec,
                                    1024),
        sh.compute_tile_row_sharded(tile_row_mesh(1, 1, [dev]), spec, 1024)))
    if not all(ring.values()):
        raise AssertionError(f"the two-shard ring differs from one device: "
                             f"{ring}")
    emit({"phase": "mesh_path", "ok": True, "drains": drains,
          "launches": launches, "ring_cuda0_x2_bitwise": ring,
          "timing": "host clock around run_until_drained(), ended by "
                    "torch.cuda.synchronize()"})
    return launches


# The MXU path's drain: 16 chunks of the main path's profile, four of
# level 4 at budget 256 and twelve of level 10 at 1024 along the seahorse
# valley (the main path's heaviest chunks).
MXU_DRAIN = ([(4, 256, i, 0) for i in range(4)]
             + [(10, 1024, i, j) for i, j in LEVEL10[:12]])


def drain_fused(wk, names, workloads, mesh=None):
    """One drain of ``workloads`` by the pipelined Worker with
    CudaBackend (depth 2, window 4, batches of 4), launch counts set to
    0 just before -> (crc by key, {launches, counters}, wall)."""
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    source = GrantSource(workloads, [])
    backend = wk.CudaBackend(mesh=mesh)
    worker = wk.Worker(source, backend, batch_size=4, window=4, depth=2)
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    t0 = time.monotonic()
    worker.run_until_drained()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    cv = worker.registry.counter_value
    counters = {name: cv(getattr(names, name)) or 0 for name in (
        "WORKER_KERNEL_FUSED_LAUNCHES", "WORKER_KERNEL_MXU_LAUNCHES",
        "WORKER_KERNEL_MXU_DEMOTIONS", "WORKER_KERNEL_MXU_CENSUS",
        "WORKER_MXU_CENSUS_FAILURES", "WORKER_MESH_LAUNCHES")}
    counters["demotions"] = {r: backend.demotions(r) for r in (
        names.ROUTE_FUSED_TO_PER_TILE, names.ROUTE_PER_TILE_TO_TORCH,
        names.ROUTE_MESH_TO_FUSED)}
    missing = [w.key for w in workloads if w.key not in source.crc]
    if missing or source.bad_sizes:
        raise AssertionError(f"fused drain: missing {missing[:5]}, bad "
                             f"sizes {source.bad_sizes[:5]}")
    return source.crc, {"launches": ce.launch_counts(),
                        "counters": counters}, wall


def phase_mxu_path(wk, ce, names, TileSpec, Workload):
    """The DMTPU_MXU gate on the worker's fused route: the card's probe
    verdict; 16 chunks drained with DMTPU_MXU=0, then with DMTPU_MXU=1 on
    one device and on the ring [cuda:0, cuda:0] (full mode where the
    probe admits it), then with the census verdict forced on both.
    Every drain's chunks must equal the DMTPU_MXU=0 drain's, bitwise.
    Last, one 4096^2 batch per K2 mode through the mesh entry
    (``compute_tiles_mega_sharded`` on the ring) under DMTPU_MXU=1, each
    tile against K1 by checksum."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    from distributedmandelbrot_tpu_torch.parallel import sharding as sh
    from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    t_phase = time.monotonic()
    mxu.reset_mxu_cache()
    differing = mxu.probe_differences(dev)
    admitted = mxu.mxu_parity_proven(dev)
    planes = mxu.probe_planes(dev).cpu()
    cpu_planes = mxu.probe_planes("cpu")
    nan_both = planes.isnan() & cpu_planes.isnan()
    vs_cpu = planes.view(torch.int32) != cpu_planes.view(torch.int32)
    probe = {"verdict": "full" if admitted else "census",
             "differing_lanes": differing,
             "lanes": mxu.PROBE_N * mxu.PROBE_N, "steps": mxu.PROBE_STEPS,
             "planes_vs_cpu_plain_differing_values": int(vs_cpu.sum()),
             "of_which_nan_on_both": int((vs_cpu & nan_both).sum())}
    workloads = [Workload(*g) for g in MXU_DRAIN]
    ring = make_mesh([dev, dev])
    base, base_stats, base_wall = drain_fused(wk, names, workloads)
    drains = {"mxu0": dict(base_stats, seconds=base_wall)}
    os.environ[mxu.MXU_ENV] = "1"
    try:
        runs = [("mxu1", None, None), ("mxu1_ring", ring, None),
                ("census", None, False), ("census_ring", ring, False)]
        for name, mesh, forced in runs:
            if forced is not None:
                mxu._parity_cache[("cuda", 0)] = forced
            crc, stats, wall = drain_fused(wk, names, workloads, mesh)
            c, n = stats["counters"], stats["launches"]
            fused = c["WORKER_KERNEL_FUSED_LAUNCHES"]
            full = forced is None and admitted
            differ = [k for k in base if crc.get(k) != base[k]]
            problems = []
            if differ:
                problems.append(f"{len(differ)} chunks differ from "
                                f"DMTPU_MXU=0: {differ[:3]}")
            if fused <= 0 or any(c["demotions"].values()):
                problems.append("no fused launch, or a demotion")
            if full and (c["WORKER_KERNEL_MXU_LAUNCHES"] != fused
                         or c["WORKER_KERNEL_MXU_DEMOTIONS"]
                         or n["escape_mega"] or n["escape_mega_mxu"] <= 0):
                problems.append("full mode: matrix-form launches do not "
                                "match the fused launches")
            if not full and (c["WORKER_KERNEL_MXU_DEMOTIONS"] != fused
                             or c["WORKER_KERNEL_MXU_LAUNCHES"]
                             or c["WORKER_KERNEL_MXU_CENSUS"] <= 0
                             or n["escape_mega_mxu"]
                             or n["escape_mega"] <= 0):
                problems.append("census mode: counters off")
            if c["WORKER_MXU_CENSUS_FAILURES"]:
                problems.append("census shadow failures")
            if (mesh is not None) != bool(c["WORKER_MESH_LAUNCHES"]):
                problems.append("the ring route was not taken")
            if problems:
                raise AssertionError(f"mxu_path {name}: {problems}; {stats}")
            drains[name] = dict(stats, seconds=wall,
                                mode="full" if full else "census",
                                chunks_equal_mxu0=len(base))
    finally:
        os.environ.pop(mxu.MXU_ENV, None)
        mxu.reset_mxu_cache()
    # K2's modes through the mesh entry, the gate resolved per batch:
    # each mode with the gate off, and Julia again under DMTPU_MXU=1 (the
    # matrix form where the probe admits it).  The counts are read before
    # the K1 launches that check the tiles.
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    batches = []
    mis = [1024, 2000, 256, 1024]
    for mode, gate in (("julia", "0"), ("multibrot", "0"), ("ship", "0"),
                       ("julia", "1")):
        specs = [render_view(mode, TileSpec),
                 neighbour(render_view(mode, TileSpec))] * 2
        os.environ[mxu.MXU_ENV] = gate
        try:
            tiles, _ = sh.compute_tiles_mega_sharded(
                specs, mis, mesh=ring, **mega_kw(MEGA_MODES[mode],
                                                 len(specs)))
        finally:
            os.environ.pop(mxu.MXU_ENV, None)
        batches.append((mode, gate, specs, tiles))
    torch.cuda.synchronize()
    mode_launches = ce.launch_counts()
    mxu.reset_mxu_cache()
    modes = {}
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    for mode, gate, specs, tiles in batches:
        for t, (spec, mi) in enumerate(zip(specs, mis)):
            one = ce.compute_tile_cuda_device(spec, mi, device=dev,
                                              cycle_check=cyc,
                                              **MEGA_MODES[mode])
            if not torch.equal(tiles[t], one):
                raise AssertionError(f"mxu_path: K2 ({mode}, DMTPU_MXU="
                                     f"{gate}) tile {t} differs from K1")
        modes[f"{mode}_mxu{gate}"] = {"tiles": len(specs), "max_iters": mis,
                                      "equal_k1": True}
    want = ["escape_mega_julia", "escape_mega_multibrot", "escape_mega_ship"]
    if admitted:
        want.append("escape_mega_mxu")
    if any(mode_launches[k] <= 0 for k in want):
        raise AssertionError(f"mxu_path modes: launches {mode_launches}")
    launches = {}
    for name in ("mxu1", "mxu1_ring", "census", "census_ring"):
        for k, v in drains[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for k, v in mode_launches.items():
        launches[k] = launches.get(k, 0) + v
    emit({"phase": "mxu_path", "ok": True, "probe": probe,
          "chunks": len(workloads), "drains": drains,
          "mode_batches": modes, "mode_launches": mode_launches,
          "launches": launches, "seconds": time.monotonic() - t_phase,
          "timing": "host clock around run_until_drained(), ended by "
                    "torch.cuda.synchronize()"})
    return launches


def run_rank(rank: int, port: int, out: str) -> int:
    """One rank of the multihost phase (``chip_smoke.py --rank R --port P
    --out DIR``): half of the EDGE4 batch at budget 5000 on cuda:0."""
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    from distributedmandelbrot_tpu_torch.parallel import multihost
    from distributedmandelbrot_tpu_torch.parallel.backend import batch_params
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    multihost.initialize(f"127.0.0.1:{port}", num_processes=RANKS,
                         process_id=rank)
    try:
        mesh = multihost.global_tile_mesh([torch.device("cuda", 0)])
        params, mrds = batch_params([Workload(10, 5000, i, j)
                                     for i, j in EDGE4], 4096)
        k = len(EDGE4) // RANKS
        ce.reset_launch_counts()
        got = multihost.batched_escape_pixels_multihost(
            mesh, params[rank * k:(rank + 1) * k],
            mrds[rank * k:(rank + 1) * k], definition=4096)
        torch.cuda.synchronize()
        np.save(os.path.join(out, f"rank{rank}.npy"), got)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
            json.dump(ce.launch_counts(), fh)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def phase_multihost(ce, TileSpec):
    """Two gloo ranks on cuda:0, re-launched from this script; the
    gathered result must equal K3 on the whole batch here, bitwise."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--port", str(port), "--out", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.monotonic() - t0
        bad = [(r, p.returncode, log[-2000:])
               for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        if bad or len(logs) != RANKS:
            raise AssertionError(f"multihost ranks failed: {bad}")
        got = np.concatenate([np.load(os.path.join(out, f"rank{r}.npy"))
                              for r in range(RANKS)])
        counts = []
        for r in range(RANKS):
            with open(os.path.join(out, f"rank{r}.json")) as fh:
                counts.append(json.load(fh))
    specs = [TileSpec.for_chunk(10, i, j) for i, j in EDGE4]
    rows = np.asarray([ce._params_row(sp) for sp in specs], np.float32)
    want = ce.compute_tiles_batch_cuda(rows, [5000] * len(specs),
                                       height=4096, width=4096,
                                       device="cuda").cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("the two-rank result differs from K3 in one "
                             "process")
    if any(c.get("escape_batch") != 1 for c in counts):
        raise AssertionError(f"each rank must launch K3 once: {counts}")
    launches = {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}
    emit({"phase": "multihost", "ok": True, "ranks": RANKS,
          "device": "cuda:0 (both ranks)", "backend": "gloo",
          "chunks": len(specs), "max_iter": 5000, "seconds": wall,
          "bitwise_vs_one_process_k3": True, "launches_by_rank": counts,
          "timing": "host clock from the ranks' start to their exit "
                    "(interpreter start and process-group setup included)"})
    return launches


def warp_steps(steps) -> int:
    """Steps the warps execute: a warp spans 32 adjacent pixels of a row
    and runs until its slowest lane retires (per-thread early exit
    diverges inside a warp)."""
    s = steps.reshape(-1, 32).to(torch.int64)
    return int(s.max(dim=1).values.sum()) * 32


def issued_lane_steps(launch) -> int:
    """Lane steps a kernel's instrumented form issues: ``launch`` gets a
    zeroed (1,) int64 counter on the card, to which each warp of a
    persistent kernel adds 8 x 32 per group it runs, each warp of K6
    32 per step of its slowest lane, and each warp of K7 8 x 32 per group
    of its slowest lane (the counting form is launched only here)."""
    counter = torch.zeros((1,), dtype=torch.int64, device="cuda")
    launch(counter)
    torch.cuda.synchronize()
    return int(counter.item())


# The persistent kernels' instantiations by form: escape_tile_kernel<F,
# MXU, COUNT>, escape_mega_kernel<F, MXU, JULIA, COUNT>, and
# escape_batch_kernel, escape_pack_kernel and escape_smooth_kernel<F,
# JULIA, COUNT> (the uncounted form).
PERSISTENT_FORMS = {
    "escape_tile": ("escape_tile_kernel<0,0,0>", {}),
    "escape_tile_julia": ("escape_tile_kernel<0,0,0>", {"julia": True}),
    "escape_tile_multibrot3": ("escape_tile_kernel<2,0,0>", {"power": 3}),
    "escape_tile_ship": ("escape_tile_kernel<1,0,0>", {"burning": True}),
    "escape_mega": ("escape_mega_kernel<0,0,0,0>", {}),
    "escape_mega_julia": ("escape_mega_kernel<0,0,1,0>", {"julia": True}),
    "escape_mega_multibrot": ("escape_mega_kernel<2,0,0,0>", {"power": 3}),
    "escape_mega_ship": ("escape_mega_kernel<1,0,0,0>", {"burning": True}),
    "escape_mega_mxu": ("escape_mega_kernel<0,1,0,0>", {"use_mxu": True}),
    "escape_batch": ("escape_batch_kernel<0,0,0>", {}),
    "escape_pack": ("escape_pack_kernel<0,0,0>", {}),
    "escape_smooth": ("escape_smooth_kernel<0,0,0>", {}),
}


# K6's uncounted form, escape_state_kernel<F, COUNT>: one thread a pixel.
K6_FORM = "escape_state_kernel<0,0>"
# K7's uncounted form, escape_resume_kernel<F, COUNT>: one thread a lane
# of a list, in 8-step groups.
K7_FORM = "escape_resume_kernel<0,0>"


def persistent_fields(ce, ptxas: dict, groups, form: str, issued: int,
                      needed: int) -> dict:
    """The persistent loop's own numbers for a kernel's row: lane
    steps issued (measured by the instrumented form) over the steps the
    pixels need, registers and spills, occupancy, and the inner step
    group's SASS."""
    inst, kw = PERSISTENT_FORMS[form]
    regs = ptxas.get(inst, {})
    return {"lane_steps_issued": issued,
            "lane_steps_over_needed": issued / needed if needed else None,
            "instantiation": inst, "registers": regs.get("registers"),
            "spill_stores": regs.get("spill_stores"),
            "occupancy": ce.persistent_occupancy(
                "_".join(form.split("_")[:2]), **kw),
            "step_group_sass": (groups.get(inst, "not found")
                                if isinstance(groups, dict) else groups)}


def bound(f32_steps: int, scout_steps: int, out_bytes: int,
          per_step: int = OPS_PER_STEP, extra_ops: int = 0,
          scout_per_step: int = OPS_PER_STEP):
    """(bound_ms, bound_by, ops): the kernel's operations (``per_step``
    per f32 step, the bf16 scout's ``scout_per_step`` scalar ops counted
    at the same rate, plus ``extra_ops``) over the f32 non-FMA rate,
    against its output bytes over the memory rate."""
    ops = f32_steps * per_step + scout_steps * scout_per_step + extra_ops
    t_ops = ops / F32_OPS_PER_S
    t_bytes = out_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops)


def neighbour(spec):
    """The window a quarter span to the right of ``spec``."""
    return type(spec)(spec.start_real + spec.range_real / 4,
                      spec.start_imag, spec.range_real, spec.range_imag,
                      spec.width, spec.height)


def render_view(mode: str, TileSpec):
    """A render path view at 4096^2: the fractal's default center (the
    ship's at -0.5-0.5i), span 3."""
    cx, cy = {"julia": (0.0, 0.0), "ship": (-0.5, -0.5)}.get(mode,
                                                             (-0.5, 0.0))
    return TileSpec(cx - 1.5, cy - 1.5, 3.0, 3.0, width=4096, height=4096)


def time_k1_modes(ce, TileSpec, dev, ptxas, groups) -> dict:
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
        row = ce._params_row(spec, kw.get("julia_c"))
        issued = issued_lane_steps(lambda c: ce.compute_tile_row_cuda(
            row, mi, 4096, 4096, device=dev, lane_steps=c, **mode_args(kw)))
        out[mode] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "ops": ops,
                     "f32_steps": int(steps.sum()),
                     "f32_warp_steps": warp_steps(steps),
                     **persistent_fields(ce, ptxas, groups,
                                         f"escape_tile_{mode}", issued,
                                         int(steps.sum())),
                     "input": f"{mode} render view (span 3) at 4096^2, "
                              f"max_iter {mi}"}
    return out


def compact_warp_steps(steps, phase: int):
    """Warp lane-steps of the compacted pipeline for these per-pixel
    steps: K6 runs every pixel for at most ``phase`` steps in the tile
    layout; K7 runs the live lanes in pixel order, in one launch (warps
    of 32 consecutive lanes, each until its slowest lane ends).  Returns
    (K6, K7) lane-steps."""
    s = steps.reshape(-1).to(torch.int64)
    k6 = warp_steps(s.clamp(max=phase))
    live = s[s > phase] - phase
    run = torch.nn.functional.pad(live, (0, -live.numel() % 32))
    return k6, int(run.reshape(-1, 32).max(dim=1).values.sum()) * 32


# K3's light batch: four level-4 chunks at budget 256 (the probe off),
# where the persistent loop has little divergence to remove; K6 takes it
# at 700, inside the compacted route's band of budgets (513-1023).
K3_LIGHT = [(4, 1, 1), (4, 1, 2), (4, 2, 1), (4, 2, 2)]
K6_LIGHT_BUDGET = 700


def smooth_need(nu, steps, mi: int) -> int:
    """The steps K4's pixels need: the plain loop's, except that a pixel
    in the set (nu = 0) needs at most the budget's dyn steps, whatever
    the loop runs after (its value is 0 from then on)."""
    return int(torch.where(nu == 0, steps.clamp(max=mi - 1), steps).sum())


def time_smooth_light(ce, TileSpec, dev) -> dict:
    """K4 on a light input: chunk (4, 1, 1) at 4096^2 and budget 256 (the
    probe off), bulbs beside the proven cardioid."""
    spec = TileSpec.for_chunk(4, 1, 1)
    want, steps = plain_smooth(ce, spec, 256, {}, dev, return_steps=True)
    if bit_diff(ce.compute_tile_smooth_cuda(spec, 256, device=dev),
                want)[0]:
        raise AssertionError("K4 (light) differs from its plain version")
    need = smooth_need(want, steps, 256)
    issued = issued_lane_steps(lambda c: ce.compute_tile_smooth_cuda(
        spec, 256, device=dev, lane_steps=c))
    b_ms, b_by, _ = bound(need, 0, 4 * 4096 * 4096,
                          extra_ops=int((want > 0).sum())
                          * SMOOTH_EPILOGUE_OPS)
    return {"input": "chunk (4, 1, 1) at 4096^2, max_iter 256, probe off",
            "ms": median_ms(lambda: ce.compute_tile_smooth_cuda(
                spec, 256, device=dev), reps=30),
            "bound_ms": b_ms, "bound_by": b_by, "f32_steps": need,
            "lane_steps_issued": issued,
            "lane_steps_over_needed": issued / need}


def time_state_light(ce, cx, TileSpec, dev) -> dict:
    """K6 on the light batch K3_LIGHT at K6_LIGHT_BUDGET."""
    specs = [TileSpec.for_chunk(*key) for key in K3_LIGHT]
    rows = np.asarray([ce._params_row(sp) for sp in specs], np.float32)
    mis = [K6_LIGHT_BUDGET] * len(specs)
    got = cx.escape_state_cuda(rows, mis, height=4096, width=4096,
                               device=dev)
    want = cx.escape_state_plain(rows, mis, height=4096, width=4096,
                                 device=dev)
    if any(bit_diff(g, w)[0] for g, w in zip(got, want)):
        raise AssertionError("K6 (light) differs from its plain version")
    _, steps = ce.escape_batch_plain(rows, mis, height=4096, width=4096,
                                     device=dev, return_steps=True)
    need = int(steps.clamp(max=cx.PHASE1_BUDGET).sum())
    issued = issued_lane_steps(lambda c: cx.escape_state_cuda(
        rows, mis, height=4096, width=4096, device=dev, lane_steps=c))
    b_ms, b_by, _ = bound(need, 0, STATE_BYTES_PER_PIXEL * len(specs)
                          * 4096 * 4096)
    return {"input": "k=4: level-4 chunks (4,1,1), (4,1,2), (4,2,1), "
                     f"(4,2,2) at 4096^2, max_iter {K6_LIGHT_BUDGET}, "
                     "phase 1 (256 steps)",
            "ms": median_ms(lambda: cx.escape_state_cuda(
                rows, mis, height=4096, width=4096, device=dev), reps=30),
            "bound_ms": b_ms, "bound_by": b_by, "f32_steps": need,
            "lane_steps_issued": issued,
            "lane_steps_over_needed": issued / need}


def time_mesh_kernels(ce, TileSpec, dev, ptxas, groups) -> dict:
    """K3, K6 and K7 on the 4-chunk batch at the seahorse valley's edge
    (EDGE4): K3 at budget 5000 (its route's class, the probe armed) with
    its persistent loop's numbers (lane steps by the instrumented form,
    registers, occupancy), K3 on the light batch K3_LIGHT at 256, and K3
    at 1000 beside the compacted pipeline (wall time, host clock around
    the call and a synchronize, which includes its host reads), K6 on the
    batch and K7's first round on its packed lanes."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    specs = [TileSpec.for_chunk(10, i, j) for i, j in EDGE4]
    rows = np.asarray([ce._params_row(sp) for sp in specs], np.float32)
    k, n_pix = len(specs), len(specs) * 4096 * 4096
    out = {}

    def k3(mi):
        return ce.compute_tiles_batch_cuda(rows, [mi] * k, height=4096,
                                           width=4096, device=dev)

    def k3_plain(mi, **kw):
        return ce.escape_batch_plain(
            rows, [mi] * k, height=4096, width=4096, device=dev,
            cycle_check=ce.escape_time.resolve_cycle_check(None, mi), **kw)

    got = k3(5000)
    want, steps = k3_plain(5000, return_steps=True)
    b_ms, b_by, ops = bound(int(steps.sum()), 0, n_pix)
    issued = issued_lane_steps(lambda c: ce.compute_tiles_batch_cuda(
        rows, [5000] * k, height=4096, width=4096, device=dev, lane_steps=c))
    light = [TileSpec.for_chunk(*key) for key in K3_LIGHT]
    lrows = np.asarray([ce._params_row(sp) for sp in light], np.float32)

    def k3_light():
        return ce.compute_tiles_batch_cuda(lrows, [256] * len(light),
                                           height=4096, width=4096,
                                           device=dev)

    lwant, lsteps = ce.escape_batch_plain(
        lrows, [256] * len(light), height=4096, width=4096, device=dev,
        cycle_check=ce.escape_time.resolve_cycle_check(None, 256),
        return_steps=True)
    lb_ms, lb_by, _ = bound(int(lsteps.sum()), 0, len(light) * 4096 * 4096)
    l_issued = issued_lane_steps(lambda c: ce.compute_tiles_batch_cuda(
        lrows, [256] * len(light), height=4096, width=4096, device=dev,
        lane_steps=c))
    out["escape_batch"] = {
        "ms": median_ms(lambda: k3(5000), reps=20),
        "plain_ms": median_ms(lambda: k3_plain(5000), reps=1, warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
        "bitwise_vs_plain": bool(torch.equal(got, want)
                                 and torch.equal(k3_light(), lwant)),
        "f32_steps": int(steps.sum()), "f32_warp_steps": warp_steps(steps),
        **persistent_fields(ce, ptxas, groups, "escape_batch", issued,
                            int(steps.sum())),
        "input": "k=4: level-10 chunks (3,5), (3,4), (2,4), (2,5) at "
                 "4096^2, max_iter 5000, probe armed",
        "light_batch": {
            "input": "k=4: level-4 chunks (4,1,1), (4,1,2), (4,2,1), "
                     "(4,2,2) at 4096^2, max_iter 256, probe off",
            "ms": median_ms(k3_light, reps=30), "bound_ms": lb_ms,
            "bound_by": lb_by, "f32_steps": int(lsteps.sum()),
            "f32_warp_steps": warp_steps(lsteps),
            "lane_steps_issued": l_issued,
            "lane_steps_over_needed": l_issued / int(lsteps.sum())}}

    mi = 1000
    got = k3(mi)
    want, steps = k3_plain(mi, return_steps=True)
    needed = int(steps.sum())

    def wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def compact():
        return cx.compact_escape_batch(rows, [mi] * k, k=k, height=4096,
                                       width=4096, max_iter=mi, device=dev)

    k6_lanes, k7_lanes = compact_warp_steps(steps, cx.PHASE1_BUDGET)
    # K3's warp lane-steps under a one-pixel-a-thread loop (a model),
    # beside what K3 issues (its instrumented form).
    k3_lanes = warp_steps(steps)
    k3_issued = issued_lane_steps(lambda c: ce.compute_tiles_batch_cuda(
        rows, [mi] * k, height=4096, width=4096, device=dev, lane_steps=c))
    finding = {
        "input": "k=4: level-10 chunks (3,5), (3,4), (2,4), (2,5) at "
                 "4096^2, max_iter 1000",
        "k3_ms": median_ms(lambda: k3(mi), reps=20),
        "k3_wall_ms": wall(lambda: k3(mi)),
        "compact_wall_ms": wall(compact),
        "compact_bitwise_vs_k3": bool(torch.equal(compact(), got)),
        "f32_steps_needed": needed,
        "k3_warp_lane_steps": k3_lanes,
        "compact_warp_lane_steps": {"escape_state": k6_lanes,
                                    "escape_resume": k7_lanes},
        "k3_lane_steps_over_needed": k3_lanes / needed,
        "k3_lane_steps_issued": k3_issued,
        "k3_issued_over_needed": k3_issued / needed,
        "compact_lane_steps_over_needed": (k6_lanes + k7_lanes) / needed,
        "live_after_phase1": int((steps > cx.PHASE1_BUDGET).sum())}

    state = cx.escape_state_cuda(rows, [mi] * k, height=4096, width=4096,
                                 device=dev)
    plain = cx.escape_state_plain(rows, [mi] * k, height=4096, width=4096,
                                  device=dev)
    state_bitwise = all(bit_diff(a, b)[0] == 0 for a, b in zip(state, plain))
    k6_need = int(steps.clamp(max=cx.PHASE1_BUDGET).sum())
    b_ms, b_by, ops = bound(k6_need, 0, STATE_BYTES_PER_PIXEL * n_pix)
    k6_issued = issued_lane_steps(lambda c: cx.escape_state_cuda(
        rows, [mi] * k, height=4096, width=4096, device=dev, lane_steps=c))
    out["escape_state"] = {
        "ms": median_ms(lambda: cx.escape_state_cuda(
            rows, [mi] * k, height=4096, width=4096, device=dev), reps=20),
        "plain_ms": median_ms(lambda: cx.escape_state_plain(
            rows, [mi] * k, height=4096, width=4096, device=dev), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
        "bitwise_vs_plain": state_bitwise,
        "f32_steps": k6_need, "f32_warp_steps": k6_lanes,
        "lane_steps_issued": k6_issued,
        "lane_steps_over_needed": k6_issued / k6_need,
        "instantiation": K6_FORM,
        "registers": ptxas.get(K6_FORM, {}).get("registers"),
        "spill_stores": ptxas.get(K6_FORM, {}).get("spill_stores"),
        "input": finding["input"] + ", phase 1 (256 steps)",
        "light_batch": time_state_light(ce, cx, TileSpec, dev)}

    # K7 as the pipeline launches it (the row): one launch over the live
    # lanes' indices into K6's planes, steps 257-999; and its flat form
    # on the first round of 256 steps over the packed live lanes (a form
    # off the pipeline's path, the table's input before PR 8).  Each
    # timed launch runs on a fresh copy of what it updates in place.
    cr, ci, zr, zi, n, act = (t.reshape(-1) for t in plain)
    live = torch.nonzero(act).squeeze(1)
    flat_dyn = torch.full_like(n, mi - 1)
    dyn = flat_dyn[live]
    lanes = [t[live].contiguous() for t in (cr, ci, zr, zi, n)]
    lanes.append(torch.ones_like(dyn))
    whole = {"it0": 257, "seg": mi - 1 - cx.PHASE1_BUDGET, "dyn": flat_dyn,
             "planes": [cr, ci, zr, zi, n, act], "idx": live, "end": mi - 1,
             "plain_reps": (1, 0)}
    first = {"it0": 257, "seg": cx.RESUME_SEG, "dyn": dyn, "planes": lanes,
             "idx": None, "end": 512, "plain_reps": (3, 1)}

    def k7_call(case, planes=None, **kw):
        return cx.escape_resume_cuda(case["it0"], case["seg"], case["dyn"],
                                     *(planes or case["planes"]),
                                     idx=case["idx"], **kw)

    def fresh(case):
        return case["planes"][:2] + [t.clone() for t in case["planes"][2:]]

    def k7_times(case, reps=22):
        times = []
        for _ in range(reps):
            planes = fresh(case)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            k7_call(case, planes)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times[2:])

    lane_steps = steps.reshape(-1)[live].to(torch.int64)
    for case in (whole, first):
        want = cx.escape_resume_plain(case["it0"], case["seg"], case["dyn"],
                                      *case["planes"], idx=case["idx"])
        got = k7_call(case, fresh(case))
        sel = live if case["idx"] is not None else slice(None)
        need = int((lane_steps.clamp(max=case["end"])
                    - cx.PHASE1_BUDGET).clamp(min=0).sum())
        per_lane = RESUME_BYTES_PER_LANE + (8 if case["idx"] is not None
                                            else 0)
        b_ms, b_by, ops = bound(need, 0, per_lane * live.numel())
        issued = issued_lane_steps(lambda c: k7_call(case, fresh(case),
                                                     lane_steps=c))
        reps, warmup = case["plain_reps"]
        case.update({
            "ms": k7_times(case),
            "plain_ms": median_ms(lambda: cx.escape_resume_plain(
                case["it0"], case["seg"], case["dyn"], *case["planes"],
                idx=case["idx"]), reps=reps, warmup=warmup),
            "bound_ms": b_ms, "bound_by": b_by,
            "ops": ops, "f32_steps": need, "lane_steps_issued": issued,
            "lane_steps_over_needed": issued / need,
            "bitwise_vs_plain": all(bit_diff(a[sel], b[sel])[0] == 0
                                    for a, b in zip(got, want))})
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "ops", "f32_steps",
             "lane_steps_issued", "lane_steps_over_needed",
             "bitwise_vs_plain")
    regs = ptxas.get(K7_FORM, {})
    out["escape_resume"] = {
        **{k: whole[k] for k in timed},
        "lanes": live.numel(),
        "instantiation": K7_FORM, "registers": regs.get("registers"),
        "spill_stores": regs.get("spill_stores"),
        "input": finding["input"] + ", steps 257-999 in one launch over "
                 "the live lanes' indices into K6's planes, as the "
                 "pipeline launches it",
        "first_round": {
            "input": finding["input"] + ", steps 257-512 over the packed "
                     "live lanes: the flat form, which the pipeline does "
                     "not launch",
            **{k: first[k] for k in timed}}}
    finding["split"] = split_in_child()
    out["compaction_vs_k3"] = finding
    return out


def time_mxu_and_modes(ce, TileSpec, dev, specs, mis, k2_tiles, ptxas,
                       groups) -> dict:
    """K8 in K2 on the main path's heaviest pair (``specs`` at ``mis``),
    against its plain version and, where the probe admits full mode, the
    cached-form tiles ``k2_tiles``; K8 in K1 on the first chunk; K2 in
    each mode on its render view and the neighbouring window at 1024."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    out = {}
    rows, mrds, kw = ce.mega_dispatch_plan(specs, mis, use_mxu=True)
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, use_mxu=True,
                                               device=dev)
    ptiles, pcensus, psteps, pscout = ce.escape_mega_plain(
        rows, mrds, device=dev, return_steps=True, **kw)
    admitted = mxu.mxu_parity_proven(dev)
    b_ms, b_by, ops = bound(int(psteps.sum()), sum(pscout),
                            len(specs) * 4096 * 4096)
    out["escape_mega_mxu"] = {
        "ms": median_ms(lambda: ce.compute_tiles_mega_cuda(
            specs, mis, use_mxu=True, device=dev), reps=50),
        "plain_ms": median_ms(lambda: ce.escape_mega_plain(
            rows, mrds, device=dev, **kw), reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
        "ops_per_step": OPS_PER_STEP,
        "ops_per_step_as_written": MXU_OPS_AS_WRITTEN,
        "bitwise_vs_plain": bool(torch.equal(tiles, ptiles)
                                 and torch.equal(census, pcensus)),
        "probe_admits_full": admitted,
        "bitwise_vs_cached_k2": bool(torch.equal(tiles, k2_tiles)),
        "k1_mxu_ms": median_ms(lambda: ce.compute_tile_cuda_device(
            specs[0], mis[0], use_mxu=True, device=dev), reps=50),
        "f32_steps": int(psteps.sum()), "f32_warp_steps": warp_steps(psteps),
        "scout_steps": sum(pscout),
        **persistent_fields(ce, ptxas, groups, "escape_mega_mxu",
                            issued_lane_steps(
                                lambda c: ce.compute_tiles_mega_cuda(
                                    specs, mis, use_mxu=True, device=dev,
                                    lane_steps=c)), int(psteps.sum())),
        "input": "k=2: chunks (10, 3, 5) and (10, 3, 4) at 4096^2, "
                 "max_iter 1024, census armed, use_mxu=True"}
    if admitted and not out["escape_mega_mxu"]["bitwise_vs_cached_k2"]:
        raise AssertionError("K8 differs from the cached form where the "
                             "probe admits it")
    for mode, mkw in MEGA_MODES.items():
        view = render_view(mode, TileSpec)
        mspecs, mmis = [view, neighbour(view)], [1024, 1024]
        kwm = mega_kw(mkw, 2)
        rows, mrds, pkw = ce.mega_dispatch_plan(mspecs, mmis, **kwm)
        tiles, census = ce.compute_tiles_mega_cuda(mspecs, mmis, device=dev,
                                                   **kwm)
        ptiles, pcensus, psteps, pscout = ce.escape_mega_plain(
            rows, mrds, device=dev, return_steps=True, **pkw)
        per = ops_per_step(mkw)
        b_ms, b_by, ops = bound(int(psteps.sum()), sum(pscout),
                                2 * 4096 * 4096, per_step=per,
                                scout_per_step=per)
        out[f"escape_mega_{mode}"] = {
            "ms": median_ms(lambda: ce.compute_tiles_mega_cuda(
                mspecs, mmis, device=dev, **kwm), reps=20),
            "plain_ms": median_ms(lambda: ce.escape_mega_plain(
                rows, mrds, device=dev, **pkw), reps=2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
            "ops_per_step": per,
            "bitwise_vs_plain": bool(torch.equal(tiles, ptiles)
                                     and torch.equal(census, pcensus)),
            "f32_steps": int(psteps.sum()),
            "f32_warp_steps": warp_steps(psteps),
            "scout_steps": sum(pscout),
            **persistent_fields(ce, ptxas, groups, f"escape_mega_{mode}",
                                issued_lane_steps(
                                    lambda c: ce.compute_tiles_mega_cuda(
                                        mspecs, mmis, device=dev,
                                        lane_steps=c, **kwm)),
                                int(psteps.sum())),
            "input": f"k=2: the {mode} render view (span 3"
                     f"{', d = 3' if mode == 'multibrot' else ''}) and the "
                     "window a quarter span right, at 4096^2, max_iter "
                     "1024, census armed"}
    return out


def phase_kernels(ce, TileSpec, launches, err, build):
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
    listing = sass_listing(build)
    groups = sass_step_group(listing)
    ptxas = {kernel_name(r["kernel"]): r for r in build.ptxas_report()}
    k1_issued = issued_lane_steps(lambda c: ce.compute_tile_row_cuda(
        row_a, mi, 4096, 4096, device=dev, lane_steps=c))

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
    k2_issued = issued_lane_steps(lambda c: ce.compute_tiles_mega_cuda(
        specs, mis, device=dev, lane_steps=c))
    # Lighter pairs of the main path: a sky pair and a level-4 pair at
    # 256 (the probe off), where little divergence was left to remove.
    k2_light = {}
    for name, (keys, lmi) in {"sky (10,0,0)+(10,0,1), max_iter 1024":
                              (((10, 0, 0), (10, 0, 1)), 1024),
                              "level 4 (4,1,1)+(4,1,2), max_iter 256":
                              (((4, 1, 1), (4, 1, 2)), 256)}.items():
        pair = [TileSpec.for_chunk(*k) for k in keys]
        k2_light[name] = median_ms(lambda: ce.compute_tiles_mega_cuda(
            pair, [lmi, lmi], device=dev), reps=30)
    # K4 on the same chunk: f32 nu, 4 bytes a pixel.
    k4_ms = median_ms(lambda: ce.compute_tile_smooth_cuda(a, mi, device=dev),
                      reps=50)
    k4_plain_ms = median_ms(lambda: plain_smooth(ce, a, mi, {}, dev),
                            reps=3, warmup=1)
    k4_got = ce.compute_tile_smooth_cuda(a, mi, device=dev)
    k4_want, k4_steps = plain_smooth(ce, a, mi, {}, dev, return_steps=True)
    k4_bitwise = bit_diff(k4_got, k4_want)[0] == 0
    k4_need = smooth_need(k4_want, k4_steps, mi)
    k4_bound, k4_by, k4_ops = bound(
        k4_need, 0, 4 * 4096 * 4096,
        extra_ops=int((k4_want > 0).sum()) * SMOOTH_EPILOGUE_OPS)
    # The same under the plain loop's count (in-set pixels run on to the
    # step limit), the count the K4 row used before K4's loop retired
    # in-set pixels early.
    k4_plain_steps = int(k4_steps.sum())
    k4_bound_plain_loop = bound(
        k4_plain_steps, 0, 4 * 4096 * 4096,
        extra_ops=int((k4_want > 0).sum()) * SMOOTH_EPILOGUE_OPS)[0]
    k4_issued = issued_lane_steps(lambda c: ce.compute_tile_smooth_cuda(
        a, mi, device=dev, lane_steps=c))
    k4_light = time_smooth_light(ce, TileSpec, dev)

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
    k5_issued = issued_lane_steps(lambda c: ce.compute_tiles_packed_cuda(
        win, [mi] * 4, device=dev, lane_steps=c))
    modes = time_k1_modes(ce, TileSpec, dev, ptxas, groups)
    mesh = time_mesh_kernels(ce, TileSpec, dev, ptxas, groups)
    finding = mesh.pop("compaction_vs_k3")
    mxu_modes = time_mxu_and_modes(ce, TileSpec, dev, specs, mis, tiles,
                                   ptxas, groups)

    if not (k1_bitwise and k2_bitwise and k4_bitwise and k5_bitwise
            and all(m["bitwise_vs_plain"] for m in mesh.values())
            and all(m["bitwise_vs_plain"] for m in mxu_modes.values())
            and finding["compact_bitwise_vs_k3"]):
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
         **persistent_fields(ce, ptxas, groups, "escape_tile", k1_issued,
                             int(k1_steps.sum())),
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
         "ops": k2_ops,
         **persistent_fields(ce, ptxas, groups, "escape_mega", k2_issued,
                             int(psteps.sum())),
         "light_pairs_ms": k2_light},
        {"name": "escape_smooth", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["escape_smooth"], **runs("escape_smooth"),
         "max_abs_err": err["escape_smooth"], "ms": k4_ms,
         "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
         "library_ms": None, "library_reason": NO_LIBRARY,
         "bitwise_vs_plain": k4_bitwise,
         "input": "chunk (10, 3, 5) at 4096^2, max_iter 1024, bailout 256",
         "f32_steps": k4_need, "f32_steps_plain_loop": k4_plain_steps,
         "bound_ms_plain_loop": k4_bound_plain_loop,
         "lane_steps_over_needed_plain_loop": k4_issued / k4_plain_steps,
         "f32_warp_steps": warp_steps(k4_steps), "ops": k4_ops,
         **persistent_fields(ce, ptxas, groups, "escape_smooth", k4_issued,
                             k4_need),
         "light": k4_light},
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
         "f32_warp_steps": sum(warp_steps(st) for st in k5_steps),
         **persistent_fields(ce, ptxas, groups, "escape_pack", k5_issued,
                             int(k5_steps.sum()))},
    ]
    for name, m in mesh.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], **runs(name),
            "max_abs_err": err[name], "library_ms": None,
            "library_reason": NO_LIBRARY, **m})
    kernels[-1]["compaction_vs_k3"] = finding
    sass = sass_f32_ops(listing)
    for name, m in mxu_modes.items():
        row = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
               "replaces": REPLACES[name], **runs(name),
               "max_abs_err": err[name], "library_ms": None,
               "library_reason": NO_LIBRARY, **m}
        if name == "escape_mega_mxu":
            row["k1_mxu"] = runs("escape_tile_mxu")
            row["k2_cached_ms_same_run"] = k2_ms
            row["sass_f32_ops"] = sass
        kernels.append(row)
    return (kernels + perturb_rows(err, launches, ptxas)
            + colormap_rows(launches, ptxas))


# The farm phase: the main path's profile (level 20 left to a
# benchmark) over TCP, the serving leg's level, and the animation (the
# config-5 shape cut to 12 frames at 1024^2).
FARM_LEVELS = "4:256,10:1024"
SERVE_LEVELS = "2:256"
FARM_TIMEOUT_S = 120
# Sampled chunks of each level held to the plain version: sky,
# interior and boundary.
FARM_SAMPLES = [(4, 256, 3, 3), (4, 256, 1, 1), (4, 256, 1, 2),
                (4, 256, 0, 1), (10, 1024, 0, 0), (10, 1024, 4, 4),
                (10, 1024, 3, 5), (10, 1024, 2, 4)]
# The drain again with more upload lanes (the default on one card is
# one): the upload stage holds the TCP drain back.
FARM_UPLOAD_LANES = (2, 4)
ANIMATE = {"center": "-0.77568377,0.13646737", "span_start": 4.0,
           "span_end": 1e-16, "frames": 12, "definition": 1024,
           "max_iter": 1000, "max_iter_end": 20000}
ANIMATE_CHECKED = (0, 6, 11)
_FRAME_LINE = re.compile(r"^frame (\d+)/\d+ span \S+ mi (\d+)( \(deep\))?")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_farm_process(command: str, args: list, log: str):
    """``python -m distributedmandelbrot_tpu_torch <command> ...`` from
    this script's directory, its output to ``log``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "distributedmandelbrot_tpu_torch",
             command, *args], cwd=here, env=env, stdout=fh,
            stderr=subprocess.STDOUT)


def wait_listening(port: int, proc, log: str) -> None:
    import socket
    deadline = time.monotonic() + FARM_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            with open(log) as fh:
                raise AssertionError(f"farm process exited {proc.returncode}"
                                     f": {fh.read()[-2000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"nothing listens on port {port}")


def stop_farm_process(proc) -> int:
    """Interrupt (the coordinator's clean shutdown), then kill."""
    import signal
    proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def varz_of(port: int) -> dict:
    """A farm process's exporter's ``/varz``: counters, gauges and
    histograms."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/varz",
                                timeout=30) as resp:
        return json.loads(resp.read())


def counters_of(port: int) -> dict:
    return varz_of(port)["counters"]


def read_rgba_png(path: str) -> np.ndarray:
    """Decode an RGBA8 PNG as ``serve.render.encode_png`` writes it
    (colour type 6, filter 0): the card's machine has no imaging
    library."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos, idat, ihdr = 8, bytearray(), None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat += body
    width, height = (int.from_bytes(ihdr[i:i + 4], "big") for i in (0, 4))
    if ihdr[8:10] != b"\x08\x06":
        raise AssertionError(f"{path}: not an RGBA8 PNG")
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8).reshape(
        height, width * 4 + 1)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a scanline filter other than 0")
    return raw[:, 1:].reshape(height, width, 4)


def all_launches(ce, cp) -> dict:
    from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
    return {**ce.launch_counts(), **cp.launch_counts(),
            **cc.launch_counts()}


def reset_launches(ce, cp) -> None:
    from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    cp.reset_launch_counts()
    cc.reset_launch_counts()


def add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def plain_chunk(ce, TileSpec, key) -> torch.Tensor:
    level, mi, i, j = key
    spec = TileSpec.for_chunk(level, i, j)
    return ce.escape_tile_plain(
        ce._params_row(spec), mi, 4096, 4096,
        cycle_check=ce.escape_time.resolve_cycle_check(None, mi),
        device="cuda").cpu().view(-1)


def tcp_drain(cli, ce, cp, tmp, name, worker_args, inspect=None):
    """``coordinator`` (``FARM_LEVELS``) as a process of its own, in a
    data directory of its own, drained by ``worker --backend cuda`` in
    this process with ``worker_args``; ``inspect(dataserver_port)`` runs
    before the coordinator stops.  Returns the drain's wall seconds, the
    worker's stats, its launches (counted around the drain only) and
    what ``inspect`` returned."""
    dist, data, exp = free_port(), free_port(), free_port()
    log = os.path.join(tmp, f"{name}.log")
    proc = start_farm_process("coordinator", [
        "-l", FARM_LEVELS, "-o", os.path.join(tmp, name), "--host",
        "127.0.0.1", "--distributer-port", str(dist), "--dataserver-port",
        str(data), "--exporter-port", str(exp), "--stats-period", "0"], log)
    try:
        wait_listening(dist, proc, log)
        wait_listening(exp, proc, log)
        stats_path = os.path.join(tmp, f"{name}_stats.json")
        reset_launches(ce, cp)
        t0 = time.monotonic()
        rc = cli.main(["worker", "--host", "127.0.0.1", "--port", str(dist),
                       "--backend", "cuda", "--stats-json", stats_path,
                       *worker_args, "-q"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = all_launches(ce, cp)
        if rc != 0:
            raise AssertionError(f"the worker exited {rc}")
        with open(stats_path) as fh:
            stats = json.load(fh)
        # The coordinator's side of each upload: decode, accept, persist.
        stats["coordinator_histograms"] = {
            k: v for k, v in varz_of(exp)["histograms"].items()
            if k.startswith(("coord_", "store_"))}
        inspected = inspect(data) if inspect is not None else None
    finally:
        code = stop_farm_process(proc)
    if code != 0:
        raise AssertionError(f"the coordinator exited {code} on SIGINT")
    return wall, stats, launches, inspected


def farm_keys() -> list:
    from distributedmandelbrot_tpu_torch.core.workload import \
        parse_level_settings
    return [(s.level, s.max_iter, i, j)
            for s in parse_level_settings(FARM_LEVELS)
            for j in range(s.level) for i in range(s.level)]


def fetch_checked(wk, ce, TileSpec, Workload, keys, port_of,
                  want=None, on_chunk=None) -> tuple:
    """Fetch every chunk of ``keys`` through the port's ``DataClient``
    from the data server ``port_of(key)`` (polled: saves land after the
    upload) and hold it to ``CudaBackend``'s bytes for its grant, or to
    ``want[key]`` (a SHA-256) when given; ``FARM_SAMPLES`` also to the
    plain version.  ``on_chunk(pixels)`` sees each fetched chunk.
    Returns the fetch seconds and each chunk's SHA-256."""
    import hashlib
    from distributedmandelbrot_tpu_torch.viewer import (DataClient,
                                                        FetchStatus)
    backend = wk.CudaBackend()
    differ, missing, samples, digests = [], [], {}, {}
    clients: dict = {}
    t_fetch = time.monotonic()
    try:
        for key in keys:
            level, mi, i, j = key
            port = port_of(key)
            if port not in clients:
                clients[port] = DataClient("127.0.0.1", port, timeout=60)
            for _ in range(100):
                pixels, status = clients[port].fetch(level, i, j)
                if status is not FetchStatus.NOT_AVAILABLE:
                    break
                time.sleep(0.05)
            if status is not FetchStatus.OK:
                missing.append((key, status.value))
                continue
            digests[key] = hashlib.sha256(pixels.tobytes()).hexdigest()
            if on_chunk is not None:
                on_chunk(pixels)
            if want is not None:
                same = digests[key] == want[key]
            else:
                same = np.array_equal(pixels, backend.materialize_tile(
                    backend.dispatch_tile(Workload(*key))))
            if not same:
                differ.append(key)
            if key in FARM_SAMPLES:
                samples[key] = pixels
    finally:
        for client in clients.values():
            client.close()
    fetch_s = time.monotonic() - t_fetch
    if missing or differ:
        raise AssertionError(f"stored chunks missing {missing[:5]}, "
                             f"differing from CudaBackend {differ[:5]}")
    off_plain = [key for key in samples if not torch.equal(
        torch.from_numpy(samples[key]), plain_chunk(ce, TileSpec, key))]
    if off_plain:
        raise AssertionError(f"sampled chunks differ from the plain "
                             f"version: {off_plain}")
    return fetch_s, digests


def farm_drain(cli, wk, ce, cp, TileSpec, Workload, tmp, main_rate):
    """``coordinator`` drained by ``worker --backend cuda`` (one upload
    lane, the default on one card; K2 and K1 must launch): every stored
    chunk fetched back through the port's ``DataClient`` equals
    ``CudaBackend``'s bytes for its grant, the samples the plain
    version's.  Then the same drain with 2 and 4 upload lanes."""
    keys = farm_keys()

    def check_stored(data: int) -> float:
        return fetch_checked(wk, ce, TileSpec, Workload, keys,
                             lambda key: data)[0]

    wall, stats, launches, fetch_s = tcp_drain(cli, ce, cp, tmp, "farm", [],
                                               check_stored)
    if launches.get("escape_mega", 0) <= 0 \
            or launches.get("escape_tile", 0) <= 0:
        raise AssertionError(f"the drain launched {launches}: K2 and K1 "
                             "must both run")
    n = len(keys)
    total = dict(launches)
    by_lanes = {}
    for lanes in FARM_UPLOAD_LANES:
        lwall, lstats, more, _ = tcp_drain(
            cli, ce, cp, tmp, f"lanes{lanes}", ["--upload-lanes", str(lanes)])
        add_launches(total, more)
        by_lanes[lanes] = {
            "chunks_per_s_tcp": n / lwall,
            "stage_stats": lstats["stage_stats"],
            "coordinator_histograms": lstats["coordinator_histograms"]}
    return total, {
        "levels": FARM_LEVELS, "chunks": n, "seconds": wall,
        "chunks_per_s_tcp": n / wall, "chunks_per_s_main_path": main_rate,
        "timing": "host clock around the in-process cli.main(['worker', "
                  "...]) to its drained exit, ended by "
                  "torch.cuda.synchronize()",
        "worker_rounds": stats.get("rounds"),
        "stage_stats": stats.get("stage_stats"),
        "coordinator_histograms": stats["coordinator_histograms"],
        "wire_bytes": {k: v for k, v in stats["counters"].items()
                       if k.startswith("wire_") or k == "upload_us"},
        "launches": launches, "equal_to_cuda_backend": n,
        "sample_bitwise_vs_plain": len(FARM_SAMPLES),
        "fetch_and_recheck_s": fetch_s, "by_upload_lanes": by_lanes}


def farm_serve(cli, wk, ce, cp, srender, TileSpec, tmp):
    """``serve`` as a process of its own with no chunk on disk: an absent
    tile read through the gateway is computed on read by a port worker
    attached once the read waits, is the plain version's bytes, and is a
    cache hit the second time; the rendered tiles in the three colormaps
    decode to the colormap of the tile; ``viewer`` writes the chunk and
    the stitched level as the PNGs their values colour to."""
    from distributedmandelbrot_tpu_torch.net import protocol as proto
    from distributedmandelbrot_tpu_torch.viewer import (DataClient,
                                                        FetchStatus)
    dist, data, gate, exp = (free_port() for _ in range(4))
    log = os.path.join(tmp, "serve.log")
    proc = start_farm_process("serve", [
        "-l", SERVE_LEVELS, "-o", os.path.join(tmp, "serve"), "--host",
        "127.0.0.1", "--distributer-port", str(dist), "--dataserver-port",
        str(data), "--gateway-port", str(gate), "--exporter-port", str(exp),
        "--stats-period", "0"], log)
    stop = threading.Event()
    worker_thread = None
    launches: dict = {}
    try:
        wait_listening(gate, proc, log)
        wait_listening(exp, proc, log)
        backend = wk.CudaBackend()
        worker = wk.Worker(wk.DistributerClient("127.0.0.1", dist), backend,
                           window=4, depth=2)
        first = {}
        client = DataClient("127.0.0.1", gate, timeout=FARM_TIMEOUT_S)

        def read():
            t = time.monotonic()
            first["got"] = client.fetch(2, 1, 1)
            first["done"] = time.monotonic()
            first["wall"] = first["done"] - t

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        deadline = time.monotonic() + FARM_TIMEOUT_S
        while counters_of(exp).get("ondemand_requests", 0) < 1:
            if time.monotonic() > deadline:
                raise AssertionError("the gateway never took the read")
            time.sleep(0.02)
        reset_launches(ce, cp)
        t_attach = time.monotonic()
        worker_thread = threading.Thread(
            target=worker.run_forever,
            kwargs=dict(poll_interval=0.05, stop=stop), daemon=True)
        worker_thread.start()
        reader.join(timeout=FARM_TIMEOUT_S)
        pixels, status = first.get("got", (None, None))
        if status is not FetchStatus.OK:
            raise AssertionError(f"compute on read: {status}")
        tile = plain_chunk(ce, TileSpec, (2, 256, 1, 1)).numpy()
        if not np.array_equal(pixels, tile):
            raise AssertionError("the tile computed on read differs from "
                                 "the plain version")
        before = counters_of(exp)
        t = time.monotonic()
        again, status = client.fetch(2, 1, 1)
        hit_s = time.monotonic() - t
        after = counters_of(exp)
        if status is not FetchStatus.OK or not np.array_equal(again, tile) \
                or after.get("tile_cache_hits", 0) != \
                before.get("tile_cache_hits", 0) + 1 \
                or after.get("workloads_granted") != \
                before.get("workloads_granted"):
            raise AssertionError("the second read was not a cache hit")
        rendered = {}
        for cid, name in proto.COLORMAPS.items():
            body, status = client.fetch_render(2, 1, 1, cid)
            if status is not FetchStatus.OK or not np.array_equal(
                    srender.decode_rendered_png(body),
                    srender.value_lut(name)[tile.reshape(4096, 4096)]):
                raise AssertionError(f"rendered tile, {name}: {status}")
            rendered[name] = len(body)
        client.close()
        # The attached worker drains the level's other chunks.
        with DataClient("127.0.0.1", data, timeout=60) as reader_client:
            values = {}
            for j in range(2):
                for i in range(2):
                    for _ in range(600):
                        px, status = reader_client.fetch(2, i, j)
                        if status is FetchStatus.OK:
                            break
                        time.sleep(0.05)
                    values[(i, j)] = px
        stop.set()
        worker_thread.join(timeout=FARM_TIMEOUT_S)
        add_launches(launches, all_launches(ce, cp))
        lut = srender.imsave_bytes(srender.value_to_rgba(
            np.arange(256, dtype=np.uint8).reshape(16, 16))).reshape(256, 4)
        one = os.path.join(tmp, "chunk.png")
        level = os.path.join(tmp, "level.png")
        t = time.monotonic()
        rc = (cli.main(["viewer", "2", "1", "1", "--port", str(data),
                        "--out", one, "-q"]),
              cli.main(["viewer", "--stitch", "2", "--port", str(data),
                        "--out", level, "-q"]))
        viewer_s = time.monotonic() - t
        stitched = np.zeros((8192, 8192), np.uint8)
        for (i, j), px in values.items():
            stitched[j * 4096:(j + 1) * 4096, i * 4096:(i + 1) * 4096] = \
                px.reshape(4096, 4096)
        if rc != (0, 0) or not np.array_equal(
                read_rgba_png(one), lut[tile.reshape(4096, 4096)]) \
                or not np.array_equal(read_rgba_png(level), lut[stitched]):
            raise AssertionError(f"viewer PNGs (exit codes {rc}) differ "
                                 "from the colormap of the fetched values")
        counters = counters_of(exp)
    finally:
        stop.set()
        if worker_thread is not None:
            worker_thread.join(timeout=FARM_TIMEOUT_S)
        code = stop_farm_process(proc)
    if code != 0:
        raise AssertionError(f"serve exited {code} on SIGINT")
    if not counters.get("ondemand_served"):
        raise AssertionError("the first read was not served on demand")
    return launches, {
        "levels": SERVE_LEVELS,
        "compute_on_read_s": first["done"] - t_attach,
        "compute_on_read_timing": "host clock from the port worker's "
                                  "attach (the read already waiting at "
                                  "the gateway) to the tile's bytes back",
        "first_read_wall_s": first["wall"], "cache_hit_read_s": hit_s,
        "rendered_png_bytes": rendered, "viewer_s": viewer_s,
        "counters": {k: counters.get(k) for k in (
            "ondemand_requests", "ondemand_served", "tile_cache_hits",
            "workloads_granted", "gateway_render_served")},
        "launches": launches, "serve_exit": code}


def farm_animate(cli, ce, cp, tmp):
    """``animate`` of the config-5 shape: K1 (shallow frames) and K9
    (deep frames) launch; frames 0, 6 and 11 are the PNG ``render``
    writes for the same span and budget."""
    import contextlib
    import io
    a = ANIMATE
    out_dir = os.path.join(tmp, "frames")
    args = ["animate", f"--center={a['center']}", "--span-start",
            repr(a["span_start"]), "--span-end", repr(a["span_end"]),
            "--frames", str(a["frames"]), "--definition",
            str(a["definition"]), "--max-iter", str(a["max_iter"]),
            "--max-iter-end", str(a["max_iter_end"]), "--out-dir", out_dir]
    buf = io.StringIO()
    reset_launches(ce, cp)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = all_launches(ce, cp)
    lines = [m for m in map(_FRAME_LINE.match, buf.getvalue().splitlines())
             if m]
    if rc != 0 or len(lines) != a["frames"]:
        raise AssertionError(f"animate exited {rc} after {len(lines)} "
                             "frames")
    if launches.get("escape_tile", 0) <= 0 \
            or launches.get("perturb_scan", 0) <= 0:
        raise AssertionError(f"animate launched {launches}: K1 and K9 "
                             "must both run")
    # The sweep as cmd_animate computes it.
    ratio = (a["span_end"] / a["span_start"]) ** (1.0 / (a["frames"] - 1))
    mi_ratio = (a["max_iter_end"] / a["max_iter"]) ** (
        1.0 / (a["frames"] - 1))
    equal = {}
    for f in ANIMATE_CHECKED:
        span = a["span_start"] * ratio ** f
        mi = max(1, round(a["max_iter"] * mi_ratio ** f))
        if int(lines[f][2]) != mi:
            raise AssertionError(f"frame {f}: budget {lines[f][2]} != {mi}")
        out = os.path.join(tmp, f"render_{f}.png")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["render", f"--center={a['center']}", "--span",
                           repr(span), "--max-iter", str(mi),
                           "--definition", str(a["definition"]), "--out",
                           out, "-q"])
        with open(out, "rb") as fh, open(os.path.join(
                out_dir, f"frame_{f:04d}.png"), "rb") as gh:
            equal[f] = rc == 0 and fh.read() == gh.read()
    if not all(equal.values()):
        raise AssertionError(f"animate frames against render: {equal}")
    return launches, {
        **a, "seconds": wall, "seconds_per_frame": wall / a["frames"],
        "timing": "host clock around the in-process cli.main(['animate', "
                  "...]), PNG writes included, ended by "
                  "torch.cuda.synchronize()",
        "deep_frames": [int(m[1]) - 1 for m in lines if m[3]],
        "frames_equal_render": sorted(equal), "launches": launches}


def phase_farm_path(cli, wk, ce, srender, TileSpec, Workload, main_rate):
    """The pull-based farm in the port alone: its coordinator, its
    worker, its gateway and viewer, and animate; each leg's launches
    counted around the leg's drive only."""
    import shutil
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    tmp = tempfile.mkdtemp(prefix="dm_farm_")
    launches: dict = {}
    t0 = time.monotonic()
    try:
        drained, drain = farm_drain(cli, wk, ce, cp, TileSpec, Workload, tmp,
                                    main_rate)
        served, serve = farm_serve(cli, wk, ce, cp, srender, TileSpec, tmp)
        animated, animate = farm_animate(cli, ce, cp, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for more in (drained, served, animated):
        add_launches(launches, more)
    emit({"phase": "farm_path", "ok": True,
          "seconds": time.monotonic() - t0, "drain": drain, "serve": serve,
          "animate": animate, "launches": launches})
    return launches, drain["chunks_per_s_tcp"]


# The sharded control plane (control_path): shards of the farm's cut, the
# escape kernels' names in a torch.profiler trace, the child's limit.
CONTROL_SHARDS = 2
ESCAPE_KERNELS = r"escape_(tile|mega|smooth|pack|batch|state|resume)"
CONTROL_TIMEOUT_S = 400


def run_cli(cli, args: list) -> tuple:
    """``cli.main(args)`` in this process with its standard output
    captured: (exit code, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


class Shards:
    """``CONTROL_SHARDS`` ``coord`` processes over ``data_dir``, on the
    ports of ``ring`` (which ``ring_path`` holds)."""

    def __init__(self, ring, ring_path: str, data_dir: str, tmp: str,
                 tag: str):
        self.ring, self.procs = ring, []
        n = len(ring.shards)
        for k, info in enumerate(ring.shards):
            log = os.path.join(tmp, f"coord{k}_{tag}.log")
            self.procs.append((start_farm_process("coord", [
                "--shard", f"{k}/{n}", "--ring", ring_path, "-l",
                FARM_LEVELS, "-o", data_dir, "--host", "127.0.0.1",
                "--distributer-port", str(info.distributer_port),
                "--dataserver-port", str(info.dataserver_port),
                "--exporter-port", str(info.exporter_port),
                "--stats-period", "0"], log), log))
        try:
            for (proc, log), info in zip(self.procs, ring.shards):
                for port in (info.distributer_port, info.dataserver_port,
                             info.exporter_port):
                    wait_listening(port, proc, log)
        except BaseException:
            self.stop()
            raise

    def dataserver_of(self, key) -> int:
        level, _, i, j = key
        return self.ring.shards[self.ring.owner(level, i, j)] \
            .dataserver_port

    def stop(self) -> list:
        return [stop_farm_process(proc) if proc.poll() is None
                else proc.returncode for proc, _ in self.procs]

    def stop_clean(self) -> None:
        codes = self.stop()
        if codes != [0] * len(codes):
            raise AssertionError(f"the shards exited {codes} on SIGINT")

    def logs(self) -> list:
        out = []
        for _, log in self.procs:
            with open(log) as fh:
                out.append(fh.read())
        return out


def ring_drain(cli, ce, cp, ring_path: str, worker_args: list) -> tuple:
    """``worker --backend cuda --ring`` in this process, its launches
    counted around the drain only and its own ``/varz`` (its exporter
    on an ephemeral port, found in its output) read while it drains.
    Returns the wall seconds, launches, the last ``/varz`` read, the
    number of reads and the worker's output."""
    import contextlib
    import io
    buf = io.StringIO()
    done = threading.Event()
    reads: list = []

    def poll():
        port = None
        while not done.wait(0.1):
            if port is None:
                m = re.search(r"worker exporter on port (\d+)",
                              buf.getvalue())
                port = int(m.group(1)) if m else None
                continue
            try:
                reads.append(varz_of(port))
            except OSError:
                pass

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    reset_launches(ce, cp)
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["worker", "--backend", "cuda", "--ring",
                           ring_path, *worker_args])
        torch.cuda.synchronize()
    finally:
        done.set()
        poller.join(timeout=30)
    wall = time.monotonic() - t0
    launches = all_launches(ce, cp)
    if rc != 0:
        raise AssertionError(f"the ring worker exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    return wall, launches, (reads[-1] if reads else None), len(reads), \
        buf.getvalue()


def profile_kernel_events(prof_dir: str) -> dict:
    """The escape kernels' device events in the worker's ``--profile``
    Chrome trace, by kernel name."""
    (path,) = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
               if f.startswith("worker-") and f.endswith(".trace.json")]
    with open(path) as fh:
        trace = json.load(fh)
    counts: dict = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        m = re.search(rf"\b{ESCAPE_KERNELS}_kernel\b", ev.get("name", ""))
        if m:
            name = f"escape_{m.group(1)}"
            counts[name] = counts.get(name, 0) + 1
    return {"events": counts, "trace_bytes": os.path.getsize(path)}


def launches_by_kernel(launches: dict) -> dict:
    """The escape launch counters summed per kernel (a kernel's variants,
    ``escape_mega_mxu`` and the like, are launches of the same
    ``__global__``)."""
    out: dict = {}
    for name, n in launches.items():
        m = re.match(ESCAPE_KERNELS, name)
        if m and n:
            out[f"escape_{m.group(1)}"] = out.get(f"escape_{m.group(1)}",
                                                  0) + n
    return out


def upload_split(varz: dict) -> dict:
    """The upload lane's histograms and counters from a worker's or a
    shard's ``/varz``."""
    keep = ("upload", "stage", "phase", "coord_", "store_", "wire_")
    return {
        "histograms": {k: v for k, v in varz.get("histograms", {}).items()
                       if any(t in k for t in keep)},
        "counters": {k: v for k, v in varz.get("counters", {}).items()
                     if any(t in k for t in keep)}}


def upload_encode_s(pixels) -> float:
    """Host seconds of the session upload's body encoding for one chunk
    (``DistributerSession._encode_body``: the RLE estimate, then the
    encode where the estimate clears the bar), outside any drain."""
    from distributedmandelbrot_tpu_torch.codecs.rle import (RleCodec,
                                                            estimate_ratio)
    from distributedmandelbrot_tpu_torch.worker.client import (
        MIN_WIRE_RATIO, DistributerClient)
    t = time.perf_counter()
    arr = np.frombuffer(DistributerClient._pixel_bytes(pixels), np.uint8)
    if estimate_ratio(arr, MIN_WIRE_RATIO) > MIN_WIRE_RATIO:
        RleCodec().encode(arr)
    return time.perf_counter() - t


def control_path(cli, wk, ce, cp, TileSpec, Workload) -> dict:
    """The phase's drive and checks (see the module's docstring)."""
    import shutil
    from distributedmandelbrot_tpu_torch.control.ring import (HashRing,
                                                              ShardInfo)
    keys = farm_keys()
    tmp = tempfile.mkdtemp(prefix="dm_control_")
    t0 = time.monotonic()

    def new_ring(name: str) -> tuple:
        ring = HashRing([ShardInfo("127.0.0.1",
                                   distributer_port=free_port(),
                                   dataserver_port=free_port(),
                                   exporter_port=free_port())
                         for _ in range(CONTROL_SHARDS)], version=1)
        path = os.path.join(tmp, f"{name}.json")
        ring.save(path)
        return ring, path

    shards = None
    try:
        ring, ring_path = new_ring("ring")
        data_dir = os.path.join(tmp, "farm")
        prof_dir = os.path.join(tmp, "profile")
        stats_path = os.path.join(tmp, "worker.json")
        os.makedirs(data_dir)
        shards = Shards(ring, ring_path, data_dir, tmp, "drain")
        wall, launches, worker_varz, reads, out = ring_drain(
            cli, ce, cp, ring_path, ["--exporter-port", "0", "--profile",
                                     prof_dir, "--stats-json", stats_path,
                                     "-q"])
        if launches.get("escape_mega", 0) <= 0 \
                or launches.get("escape_tile", 0) <= 0:
            raise AssertionError(f"the ring drain launched {launches}: K2 "
                                 "and K1 must both run")
        if worker_varz is None:
            raise AssertionError("the worker's /varz was never read during "
                                 "the drain")
        profiled = profile_kernel_events(prof_dir)
        if profiled["events"] != launches_by_kernel(launches):
            raise AssertionError(f"profile kernel events "
                                 f"{profiled['events']} != launches "
                                 f"{launches_by_kernel(launches)}")
        with open(stats_path) as fh:
            stats = json.load(fh)
        encode_s: list = []
        fetch_s, digests = fetch_checked(
            wk, ce, TileSpec, Workload, keys, shards.dataserver_of,
            on_chunk=lambda px: encode_s.append(upload_encode_s(px)))
        shard_varz = [varz_of(info.exporter_port) for info in ring.shards]
        granted = [v["counters"].get("workloads_granted", 0)
                   for v in shard_varz]
        completed = [v["scheduler"]["completed"] for v in shard_varz]
        owned = [sum(ring.owner(k[0], k[2], k[3]) == n for k in keys)
                 for n in range(CONTROL_SHARDS)]
        if sum(granted) != len(keys) or completed != owned:
            raise AssertionError(f"shards granted {granted}, completed "
                                 f"{completed}; they own {owned}")
        rc, top_out = run_cli(cli, ["top", "--ring", ring_path, "--once",
                                    "--json", "--interval", "0.2"])
        top = json.loads(top_out)
        if rc != 0 or top["roles"].get("shard", {}).get("healthy") != \
                CONTROL_SHARDS or sorted(
                    r["shard"] for r in top["shards"]) != \
                list(range(CONTROL_SHARDS)):
            raise AssertionError(f"top (exit {rc}) does not list both "
                                 f"shards: {top.get('roles')}")
        for n, info in enumerate(ring.shards):
            rc, text = run_cli(cli, ["stats", "--port",
                                     str(info.exporter_port), "--json"])
            if rc != 0 or json.loads(text)["scheduler"]["completed"] != \
                    owned[n]:
                raise AssertionError(f"stats of shard {n}: exit {rc}")
        shards.stop_clean()
        listing = sorted((f, os.path.getsize(os.path.join(data_dir, "Data",
                                                          f)))
                         for f in os.listdir(os.path.join(data_dir, "Data")))
        try:
            run_cli(cli, ["compact", "-o", data_dir])
            compact = "rewrote"
        except SystemExit as e:
            compact = f"refused: {e}"
        after = sorted((f, os.path.getsize(os.path.join(data_dir, "Data",
                                                        f)))
                       for f in os.listdir(os.path.join(data_dir, "Data")))
        if not compact.startswith("refused: compact: no tile index") \
                or after != listing:
            raise AssertionError(f"compact on the sharded store: {compact}")
        shards = Shards(ring, ring_path, data_dir, tmp, "restart")
        refetch_s, _ = fetch_checked(wk, ce, TileSpec, Workload, keys,
                                     shards.dataserver_of, want=digests)
        on_disk = [re.findall(r"\((\d+) already complete on disk\)", log)
                   for log in shards.logs()]
        shards.stop_clean()
        if on_disk != [[str(n)] for n in owned]:
            raise AssertionError(f"restarted shards found {on_disk} "
                                 f"complete on disk; they own {owned}")
        # The same drain without the profiler, on fresh shards.
        ring2, ring2_path = new_ring("ring2")
        os.makedirs(os.path.join(tmp, "farm2"))
        shards = Shards(ring2, ring2_path, os.path.join(tmp, "farm2"), tmp,
                        "plain")
        plain_stats_path = os.path.join(tmp, "worker_plain.json")
        plain_wall, plain_launches, _, _, _ = ring_drain(
            cli, ce, cp, ring2_path, ["--stats-json", plain_stats_path,
                                      "-q"])
        plain_varz = [varz_of(i.exporter_port) for i in ring2.shards]
        plain_granted = [v["counters"].get("workloads_granted", 0)
                         for v in plain_varz]
        with open(plain_stats_path) as fh:
            plain_stats = json.load(fh)
        shards.stop_clean()
        shards = None
        if sum(plain_granted) != len(keys):
            raise AssertionError(f"the plain ring drain granted "
                                 f"{plain_granted}")
    finally:
        if shards is not None:
            shards.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    total = dict(launches)
    add_launches(total, plain_launches)
    return {
        "phase": "control_path", "ok": True, "card": nvidia_smi_line(),
        "seconds": time.monotonic() - t0, "levels": FARM_LEVELS,
        "shards": CONTROL_SHARDS, "chunks": len(keys),
        "chunks_per_s_ring": len(keys) / plain_wall,
        "chunks_per_s_ring_profiled": len(keys) / wall,
        "timing": "host clock around the in-process cli.main(['worker', "
                  "'--ring', ...]) to its drained exit, ended by "
                  "torch.cuda.synchronize(); the profiled drain with "
                  "--exporter-port 0 --profile",
        "granted_by_shard": granted, "owned_by_shard": owned,
        "granted_by_shard_plain": plain_granted,
        "launches_profiled": launches_by_kernel(launches),
        "launches_plain": launches_by_kernel(plain_launches),
        "profile": profiled, "worker_varz_reads": reads,
        "worker_varz": upload_split(worker_varz),
        "stage_stats": stats.get("stage_stats"),
        "shard_varz": [upload_split(v) for v in shard_varz],
        "plain_drain": {"stage_stats": plain_stats.get("stage_stats"),
                        "shard_varz": [upload_split(v)
                                       for v in plain_varz]},
        "worker_output": out.strip().splitlines(),
        "top_totals": top.get("totals"), "compact": compact,
        "restart_complete_on_disk": on_disk,
        "upload_encode_ms": {
            "median": 1e3 * statistics.median(encode_s),
            "max": 1e3 * max(encode_s), "sum": 1e3 * sum(encode_s),
            "timing": "host clock (perf_counter) around the session "
                      "upload's body encoding of each fetched chunk, one "
                      "thread, after the drains"},
        "fetch_and_recheck_s": fetch_s, "refetch_after_restart_s": refetch_s,
        "equal_to_cuda_backend": len(keys),
        "sample_bitwise_vs_plain": len(FARM_SAMPLES), "launches": total}


def run_control(argv: list[str]) -> int:
    """``--control [--out PATH]``: control_path in a process of its own
    (the build first), its record as the last line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch import worker as wk
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.ops import _build
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    _build.load()
    record = control_path(cli, wk, ce, cp, TileSpec, Workload)
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as fh:
            json.dump(record, fh, indent=1)
    emit(record)
    return 0


def phase_control_path(farm_rate: float) -> dict:
    """control_path in a fresh process of this script; its record with
    farm_path's single-coordinator chunks/s beside the ring's.  Returns
    the phase's launches."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--control"], capture_output=True, text=True,
                          timeout=CONTROL_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"control_path's process failed:\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    record["chunks_per_s_farm_path"] = farm_rate
    emit(record)
    return record["launches"]


# The port's static analysis, in a child that must import neither torch,
# jax nor the JAX package.
CHECK_TIMEOUT_S = 300
CHECK_GATE = """\
import sys
from distributedmandelbrot_tpu_torch.cli import main
rc = main(["check", "--json", "--profile"])
loaded = sorted(n for n in sys.modules if n.split(".")[0]
                in ("jax", "torch", "distributedmandelbrot_tpu"))
assert not loaded, f"check imported {loaded}"
sys.exit(rc)
"""
_PROFILE_LINE = re.compile(r"^dmtpu check: (\S+)\s+([0-9.]+)s$")


def kernel_entry(name: str, entries) -> str | None:
    """The kernel library's entry that launches the kernel ``name``: its
    own ``dm_<name>``, or the entry it is a mode of (K2's Julia,
    Multibrot and Ship modes and K8's matrix form are template flags of
    ``dm_escape_mega``)."""
    full = f"dm_{name}"
    found = [e for e in entries if full == e or full.startswith(e + "_")]
    return max(found, key=len) if found else None


def phase_check_path(kernels: list, smi: str) -> None:
    """``check --json --profile`` in a child process (CHECK_GATE): clean,
    no stale baseline entry, none of torch, jax or the JAX package
    imported; and every kernel of the kernels line launched from a
    function in the torch family's scope."""
    from distributedmandelbrot_tpu_torch import analysis
    from distributedmandelbrot_tpu_torch.analysis import rules_torch
    root = os.path.dirname(os.path.abspath(__file__))
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHECK_GATE], cwd=root,
                          capture_output=True, text=True,
                          timeout=CHECK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    if proc.returncode != 0:
        raise AssertionError(f"check failed (exit {proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    doc = json.loads(proc.stdout)
    if doc["counts"]["total"] != 0 or doc["stale_baseline"]:
        raise AssertionError(f"check is not clean: {doc}")
    profile = {m.group(1): float(m.group(2))
               for m in map(_PROFILE_LINE.match, proc.stderr.splitlines())
               if m}
    if "total" not in profile or "rules_torch" not in profile:
        raise AssertionError(f"no --profile lines: {proc.stderr[-3000:]}")
    launchers = rules_torch.launching_functions(
        analysis.Project.from_root(root))
    by_entry = {e: f"{x.path}::{x.name}" for x in launchers
                for e in x.entries}
    launched_from = {}
    for k in kernels:
        entry = kernel_entry(k["name"], by_entry)
        if entry is None:
            raise AssertionError(f"kernel {k['name']} has no launching "
                                 f"function in the torch family's scope")
        launched_from[k["name"]] = by_entry[entry]
    emit({"phase": "check_path", "ok": True, "card": smi,
          "wall_s": wall,
          "cpu_s": (after.ru_utime - before.ru_utime)
          + (after.ru_stime - before.ru_stime),
          "timing": "host clock (perf_counter) around the child; its CPU "
                    "from RUSAGE_CHILDREN; per family from --profile",
          "profile_s": profile, "counts": doc["counts"],
          "launched_from": launched_from})


def perturb_rows(err: dict, launches: dict, ptxas: dict) -> list:
    """The kernels line's rows of K9 and K10."""
    timed = time_perturb_kernels(ptxas)
    rows = []
    for name in ("perturb_scan", "perturb_scan_smooth"):
        main, *more = [t for t in timed if t["name"] == name]
        inputs = {4096: "the config-4 view at 4096^2, f32, 16 row chunks "
                        "of 256 as the route launches them",
                  1024: "the config-4 view at 1024^2"}
        by_path = {path: counts.get(name, 0)
                   for path, counts in launches.items()}
        rows.append({
            **main, "route": "cuda", "source": PERTURB_SOURCE,
            "replaces": PERTURB_REPLACES[name], "replaces_note": NO_PALLAS,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err[name], "library_ms": None,
            "library_reason": NO_PERTURB_LIBRARY,
            "input": (inputs[main["side"]] if name == "perturb_scan" else
                      "the config-4 view at 1024^2, smooth, f64, 2 row "
                      "chunks of 512"),
            "other_inputs": more})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from distributedmandelbrot_tpu_torch import cli, parallel
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
    main_launches, workloads, main_rate = phase_main_path(
        wk, ce, names, TileSpec, Workload)
    phase_main_path_profile(wk, workloads)
    render_launches = phase_render_path(ce, cli, srender, TileSpec)
    mesh_launches = phase_mesh_path(wk, ce, parallel, TileSpec, Workload)
    mxu_launches = phase_mxu_path(wk, ce, names, TileSpec, Workload)
    multihost_launches = phase_multihost(ce, TileSpec)
    deep_launches = phase_deep_path(cli, ce)["launches"]
    farm_launches, farm_rate = phase_farm_path(cli, wk, ce, srender,
                                               TileSpec, Workload, main_rate)
    control_launches = phase_control_path(farm_rate)
    kernels = phase_kernels(ce, TileSpec, {"main_path": main_launches,
                                           "render_path": render_launches,
                                           "mesh_path": mesh_launches,
                                           "mxu_path": mxu_launches,
                                           "multihost": multihost_launches,
                                           "deep_path": deep_launches,
                                           "farm_path": farm_launches,
                                           "control_path": control_launches},
                            err, _build)
    emit({"phase": "kernels", "ok": True,
          "seconds_total": time.monotonic() - t_start,
          "card": smi, "kernels": kernels})
    phase_check_path(kernels, smi)
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        sys.exit(run_rank(int(args["--rank"]), int(args["--port"]),
                          args["--out"]))
    if "--split" in sys.argv:
        sys.exit(run_split())
    if "--deep" in sys.argv:
        sys.exit(run_deep(sys.argv))
    if "--control" in sys.argv:
        sys.exit(run_control(sys.argv))
    sys.exit(main())
