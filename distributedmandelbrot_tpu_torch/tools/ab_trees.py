"""Parent against change on one card: the worker's main-path drain, a
mesh drain and the kernels, each tree in processes of its own.

    python3 distributedmandelbrot_tpu_torch/tools/ab_trees.py PARENT_DIR \\
        [--out FILE] [--drains N] [--repeat R] [--k7-only]

``PARENT_DIR`` holds another commit's files (``git archive`` unpacked);
``change`` is the checkout that holds this script.  They run in the
order parent, change, change, parent, three times over
(``--repeat``), each run a fresh process that builds its own kernels,
so that a drift of the card or the host over the call weighs on both
trees alike and shows as a spread between a tree's own runs.

Each run, on ``cuda:0``, times:

- the main-path drain of that tree's ``chip_smoke.py`` (116 full 4096^2
  chunks: 16 of level 4 at max_iter 256, 100 of level 10 at 1024; the
  pipelined ``Worker`` with ``CudaBackend``, depth 2, window 4, batches
  of 4): one warm-up drain, then ``--drains`` drains on the host clock,
  each ended by ``torch.cuda.synchronize()``; then one drain under
  ``torch.profiler`` (that tree's ``phase_main_path_profile``) for the
  card's busy share;
- one mesh drain of that tree's ``chip_smoke.py`` (``MESH_DRAINS[0]``:
  16 chunks of level 4 at max_iter 5000, the K3 route; ``MeshBackend``
  on ``cuda:0``, the classic loop, batches of 4), after a warm-up drain,
  on the host clock;
- K2 on the chunks (10, 3, 5) and (10, 3, 4) at max_iter 1024, census
  armed; K1 on (10, 3, 5); K2 in Julia mode (c = -0.8 + 0.156i) on the
  render view (span 3) and the window a quarter span right; K2 on two
  lighter pairs of the profile (``LIGHT``); K3 on the level-10 batch
  (3,5), (3,4), (2,4), (2,5) at max_iter 5000 and on the light batch
  (4,1,1), (4,1,2), (4,2,1), (4,2,2) at 256; K5 at n = 4 on the
  supersample windows of (10, 3, 5) at 1024; K4 on (10, 3, 5) at 1024
  and on the light (4, 1, 1) at 256; K6 (phase 1 of the compacted
  pipeline) on the level-10 batch at 1000 and on the level-4 batch at 700
  (inside the compacted route's budgets 513-1023): the median of 50
  launches each by CUDA events (20 for K3's and K6's heavy batches);
- K7 on the level-10 batch at 1000 after K6: its first round (steps
  257-512) over the packed live lanes, and the whole resume as that
  tree's pipeline runs it: one launch over the live lanes' indices
  (steps 257-999) where the tree's K7 takes an index list, else the sum
  of the reference's three rounds' launches (re-compaction between them
  untimed); each launch on a fresh copy of the lanes it updates, the
  median by CUDA events; and the compacted pipeline's wall time on that
  batch (host clock, ended by a synchronize; median of 10), with its
  device time split by operation under torch.profiler (this checkout's
  ``chip_smoke.compact_split``).

``--k7-only`` times only the last item (about 30 s a run).

It prints one JSON line per run, the card's name and power limit, and a
last JSON line with each tree's medians over its runs, for each pair of
adjacent runs of the two trees the change's ratio to the parent, and
whether each instantiation of K1, K2, K3 and K5 compiled to the same
SASS in both trees (``cuobjdump -sass`` of each tree's build, the
instructions compared with their operands).  It needs a CUDA card and
exits 1 without one.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

CHANGE = Path(__file__).resolve().parents[2]
ORDER = ("parent", "change", "change", "parent") * 3
JULIA_C = complex(-0.8, 0.156)
# Lighter K2 pairs of the main path's profile: a sky pair (every pixel
# escapes at once) and a level-4 pair at 256 (the probe off; bulbs that
# spend the budget beside the proven cardioid).
LIGHT = {"k2_sky_ms": ((10, 0, 0), (10, 0, 1), 1024),
         "k2_level4_ms": ((4, 1, 1), (4, 1, 2), 256)}
# K3's batches: the level-10 edge at 5000 and level 4 at 256.
K3_HEAVY = ([(10, 3, 5), (10, 3, 4), (10, 2, 4), (10, 2, 5)], 5000)
K3_LIGHT = ([(4, 1, 1), (4, 1, 2), (4, 2, 1), (4, 2, 2)], 256)
# The supersampled render's subpixel offsets (cli._SS_OFFSETS).
SS4 = ((-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25))
# K4's chunks and K6's batches: heavy and light.
K4 = {"k4_ms": ((10, 3, 5), 1024), "k4_light_ms": ((4, 1, 1), 256)}
K6 = {"k6_ms": (K3_HEAVY[0], 1000, 20), "k6_light_ms": (K3_LIGHT[0], 700, 50)}
K7_TIMED = ("k7_round1_ms", "k7_resume_ms", "compact_wall_ms")
TIMED = ("drain_chunks_per_s_median", "k2_ms", "k1_ms", "k2_julia_ms",
         *LIGHT, "k3_ms", "k3_light_ms", "k5_ms", *K4, *K6, *K7_TIMED,
         "mesh_drain_chunks_per_s")


def cuda_ms(torch, fn, reps: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def median_or_not(values: list):
    """The median, or "not measured" where a run measured nothing (the
    profiler saw no device time)."""
    if any(isinstance(v, str) for v in values):
        return "not measured"
    return statistics.median(values)


def pair_ratios(runs: list[dict], timed: tuple) -> list[dict]:
    """The change's ratio to the parent in every pair of adjacent runs of
    the two trees."""
    out = []
    for a, b in zip(runs, runs[1:]):
        if {a["tree"], b["tree"]} == {"parent", "change"}:
            p, c = (a, b) if a["tree"] == "parent" else (b, a)
            out.append({key: c[key] / p[key] for key in timed})
    return out


def byte_kernel_sass(library: str) -> dict:
    """The SASS instructions of each instantiation of K1, K2, K3 and K5 in
    the kernel library at ``library``, by demangled name."""
    sys.path.insert(0, str(CHANGE))
    import chip_smoke as cs
    listing = cs.sass_listing(SimpleNamespace(
        library_path=lambda: Path(library)))
    out, cur = {}, None
    for line in (listing or "").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = cs.kernel_name(m.group(1))
            cur = out.setdefault(name, []) if name.startswith((
                "escape_tile", "escape_mega", "escape_batch",
                "escape_pack")) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if cur is not None and m:
            cur.append(m.group(1).strip())
    return out


def k7_and_pipeline(torch, ce, cx, TileSpec, dev) -> dict:
    """K7 and the compacted pipeline on K3_HEAVY's batch at 1000 (see
    the module's docstring), with the tree's own functions."""
    import importlib.util
    import inspect

    import numpy as np
    chunks, mi = K3_HEAVY[0], 1000
    k = len(chunks)
    rows = np.asarray([ce._params_row(TileSpec.for_chunk(*c))
                       for c in chunks], np.float32)
    cr, ci, zr, zi, n, act = (t.reshape(-1) for t in cx.escape_state_cuda(
        rows, [mi] * k, height=4096, width=4096, device=dev))
    live = torch.nonzero(act).squeeze(1)
    packed = [t[live].contiguous() for t in (cr, ci, zr, zi, n)]
    packed.append(torch.ones_like(packed[4]))
    dyn = torch.full_like(packed[4], mi - 1)

    def launch_ms(fn, lanes) -> float:
        fresh = lanes[:2] + [t.clone() for t in lanes[2:]]
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(fresh)
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def median_of(fn, reps):
        fn()
        return statistics.median(fn() for _ in range(reps))

    round1 = median_of(lambda: launch_ms(
        lambda l: cx.escape_resume_cuda(257, 256, dyn, *l), packed), 20)

    def rounds() -> float:
        lanes, bdyn, total = packed, dyn, 0.0
        for it0 in range(257, mi, 256):
            fresh = lanes[:2] + [t.clone() for t in lanes[2:]]
            total += launch_ms(lambda l: cx.escape_resume_cuda(
                it0, 256, bdyn, *l), fresh)
            # launch_ms ran on copies of ``fresh``: run it once more in
            # place to carry the lanes to the next round.
            cx.escape_resume_cuda(it0, 256, bdyn, *fresh)
            keep = torch.nonzero(fresh[5]).squeeze(1)
            lanes = [t[keep].contiguous() for t in fresh]
            bdyn = bdyn[keep].contiguous()
        return total

    one_launch = "idx" in inspect.signature(cx.escape_resume_cuda).parameters
    bitwise = None
    if one_launch:
        flat_dyn = torch.full_like(n, mi - 1)
        planes = [cr, ci, zr, zi, n, act]
        resume = median_of(lambda: launch_ms(
            lambda l: cx.escape_resume_cuda(257, mi - 257, flat_dyn, *l,
                                            idx=live), planes), 10)
        got = cx.escape_resume_cuda(
            257, mi - 257, flat_dyn,
            *(planes[:2] + [t.clone() for t in planes[2:]]), idx=live)
        want = cx.escape_resume_plain(257, mi - 257, flat_dyn, *planes,
                                      idx=live)
        bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, want))
    else:
        resume = median_of(rounds, 10)

    def compact():
        return cx.compact_escape_batch(rows, [mi] * k, k=k, height=4096,
                                       width=4096, max_iter=mi, device=dev)

    def wall() -> float:
        t0 = time.perf_counter()
        compact()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_change", CHANGE / "chip_smoke.py")
    change_cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(change_cs)
    return {"k7_round1_ms": round1, "k7_resume_ms": resume,
            "k7_resume_bitwise": bitwise,
            "k7_lanes": live.numel(), "compact_wall_ms": median_of(wall, 10),
            "compact_split": change_cs.compact_split(compact)}


def child(tree: Path, drains: int, k7_only: bool) -> dict:
    """One run of ``tree``: its package and chip_smoke.py, on cuda:0."""
    sys.path.insert(0, str(tree))
    import contextlib
    import io

    import torch

    import chip_smoke as cs
    import numpy as np
    from distributedmandelbrot_tpu_torch import parallel
    from distributedmandelbrot_tpu_torch import worker as wk
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.ops import _build
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    for mod in (cs, ce):
        if not Path(mod.__file__).resolve().is_relative_to(tree.resolve()):
            raise SystemExit(f"ab_trees: {mod.__name__} came from "
                             f"{mod.__file__}, not {tree}")
    t0 = time.monotonic()
    _build.load()
    build_s = time.monotonic() - t0
    dev = torch.device("cuda", 0)
    if k7_only:
        return {"build_s": build_s, "library": str(_build.library_path()),
                **k7_and_pipeline(torch, ce, cx, TileSpec, dev)}
    workloads = ([Workload(4, 256, i, j) for j in range(4) for i in range(4)]
                 + [Workload(10, 1024, i, j) for j in range(10)
                    for i in range(10)])

    def drain() -> tuple[float, dict]:
        source = cs.GrantSource(workloads, [])
        worker = wk.Worker(source, wk.CudaBackend(), batch_size=4, window=4,
                           depth=2)
        torch.cuda.synchronize()
        ce.reset_launch_counts()
        start = time.monotonic()
        worker.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - start
        if len(source.crc) != len(workloads) or source.bad_sizes:
            raise SystemExit("ab_trees: the drain lost chunks")
        return wall, ce.launch_counts()

    drain()
    walls, launches = [], None
    for _ in range(drains):
        wall, launches = drain()
        walls.append(wall)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_main_path_profile(wk, workloads)
    profile = json.loads(buf.getvalue().strip().splitlines()[-1])
    specs = [TileSpec.for_chunk(10, 3, 5), TileSpec.for_chunk(10, 3, 4)]
    k2_ms = cuda_ms(torch, lambda: ce.compute_tiles_mega_cuda(
        specs, [1024, 1024], device=dev))
    k1_ms = cuda_ms(torch, lambda: ce.compute_tile_cuda_device(
        specs[0], 1024, device=dev))
    view = TileSpec(-1.5, -1.5, 3.0, 3.0, width=4096, height=4096)
    right = TileSpec(-0.75, -1.5, 3.0, 3.0, width=4096, height=4096)
    k2_julia_ms = cuda_ms(torch, lambda: ce.compute_tiles_mega_cuda(
        [view, right], [1024, 1024], julia_cs=[JULIA_C, JULIA_C],
        device=dev))
    light = {}
    for key, (a, b, mi) in LIGHT.items():
        pair = [TileSpec.for_chunk(*a), TileSpec.for_chunk(*b)]
        light[key] = cuda_ms(torch, lambda: ce.compute_tiles_mega_cuda(
            pair, [mi, mi], device=dev))
    timed = {}
    for key, (chunks, mi), reps in (("k3_ms", K3_HEAVY, 20),
                                    ("k3_light_ms", K3_LIGHT, 50)):
        rows = np.asarray([ce._params_row(TileSpec.for_chunk(*c))
                           for c in chunks], np.float32)
        timed[key] = cuda_ms(torch, lambda: ce.compute_tiles_batch_cuda(
            rows, [mi] * len(chunks), height=4096, width=4096, device=dev),
            reps=reps)
    win = [cs.shifted(specs[0], dx, dy) for dx, dy in SS4]
    k5_ms = cuda_ms(torch, lambda: ce.compute_tiles_packed_cuda(
        win, [1024] * 4, device=dev))
    for key, (chunk, mi) in K4.items():
        spec = TileSpec.for_chunk(*chunk)
        timed[key] = cuda_ms(torch, lambda: ce.compute_tile_smooth_cuda(
            spec, mi, device=dev))
    for key, (chunks, mi, reps) in K6.items():
        rows = np.asarray([ce._params_row(TileSpec.for_chunk(*c))
                           for c in chunks], np.float32)
        timed[key] = cuda_ms(torch, lambda: cx.escape_state_cuda(
            rows, [mi] * len(chunks), height=4096, width=4096, device=dev),
            reps=reps)
    timed.update(k7_and_pipeline(torch, ce, cx, TileSpec, dev))
    _, grants, _, _ = cs.MESH_DRAINS[0]
    mesh_work = [Workload(*g) for g in grants]
    cs.drain_mesh(wk, parallel, mesh_work)
    _, _, _, mesh_wall = cs.drain_mesh(wk, parallel, mesh_work)
    n = len(workloads)
    return {"build_s": build_s, "library": str(_build.library_path()),
            "drain_walls_s": walls,
            "drain_chunks_per_s": [n / w for w in walls],
            "drain_chunks_per_s_median": statistics.median(n / w
                                                           for w in walls),
            "drain_launches": launches,
            "profile_wall_s": profile["wall_s"],
            "device_busy_share": profile["device_busy_share"],
            "device_ms_by_kind": profile["device_ms_by_kind"],
            "k2_ms": k2_ms, "k1_ms": k1_ms, "k2_julia_ms": k2_julia_ms,
            **light, **timed, "k5_ms": k5_ms,
            "mesh_drain_s": mesh_wall,
            "mesh_drain_chunks_per_s": len(mesh_work) / mesh_wall}


def main(argv: list[str]) -> int:
    k7_only = "--k7-only" in argv
    argv = [a for a in argv if a != "--k7-only"]
    if "--child" in argv:
        i = argv.index("--child")
        drains = int(argv[argv.index("--drains") + 1])
        print(json.dumps(child(Path(argv[i + 1]), drains, k7_only)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_trees: no CUDA device", file=sys.stderr)
        return 1
    args = dict(zip(argv[1::2], argv[2::2]))
    parent = Path(argv[0]).resolve()
    if not (parent / "distributedmandelbrot_tpu_torch").is_dir():
        print(f"ab_trees: {parent} holds no port package", file=sys.stderr)
        return 2
    drains = args.get("--drains", "5")
    order = ORDER[:4] * int(args.get("--repeat", "3"))
    timed = K7_TIMED if k7_only else TIMED + ("device_busy_share",)
    trees = {"parent": parent, "change": CHANGE}
    runs = []
    for label in order:
        env = dict(os.environ, PYTHONPATH=str(trees[label]))
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[label]),
             "--drains", drains] + ["--k7-only"] * k7_only, env=env,
            cwd=trees[label], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        run = {"tree": label, **json.loads(proc.stdout.strip()
                                           .splitlines()[-1])}
        runs.append(run)
        print(json.dumps(run), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    summary = {}
    for label in trees:
        mine = [r for r in runs if r["tree"] == label]
        summary[label] = {key: median_or_not([r[key] for r in mine])
                          for key in timed}
    sass = {label: byte_kernel_sass(next(r["library"] for r in runs
                                         if r["tree"] == label))
            for label in trees}
    out = {"order": order, "card": card.strip(), "medians": summary,
           "pairs": pair_ratios(runs, K7_TIMED if k7_only else TIMED),
           "byte_kernel_sass_equal": {
               name: sass["parent"].get(name) == code
               for name, code in sorted(sass["change"].items())}}
    if "--out" in args:
        Path(args["--out"]).write_text(json.dumps({"runs": runs, **out},
                                                  indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
