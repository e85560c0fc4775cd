"""Parent against change on one card: the worker's main-path drain and
the fused kernel (K2, Mandelbrot), each tree in processes of its own;
and the change's K2 against the same kernel with its compile-time Julia
flag made a runtime select.

    python3 distributedmandelbrot_tpu_torch/tools/ab_trees.py PARENT_DIR \\
        [--out FILE] [--drains N]

``PARENT_DIR`` holds another commit's files (``git archive`` unpacked);
``change`` is the checkout that holds this script; ``runtime_julia`` is
a copy of the change's package and chip_smoke.py (under the package's
git-ignored ``_build/``) whose K2 selects the Julia constant at run
time, as K1 does: two source lines substituted.  They run in the order
parent, change, runtime_julia, runtime_julia, change, parent, twice
over, each run a fresh process that builds its own kernels, so that a
drift of the card or the host over the call weighs on every tree alike
and shows as a spread between a tree's own runs.

Each run, on ``cuda:0``, times:

- the main-path drain of that tree's ``chip_smoke.py`` (116 full 4096^2
  chunks: 16 of level 4 at max_iter 256, 100 of level 10 at 1024; the
  pipelined ``Worker`` with ``CudaBackend``, depth 2, window 4, batches
  of 4): one warm-up drain, then ``--drains`` drains on the host clock,
  each ended by ``torch.cuda.synchronize()``; then one drain under
  ``torch.profiler`` (that tree's ``phase_main_path_profile``) for the
  card's busy share;
- K2 on the chunks (10, 3, 5) and (10, 3, 4) at max_iter 1024, census
  armed, and K1 on (10, 3, 5): the median of 50 launches by CUDA events.

It prints one JSON line per run, the card's name and power limit, and a
last JSON line with each tree's medians over its runs and, for each
pair of adjacent runs of two trees, the ratio of the later-listed tree
in ``PAIRS`` to the other.  It needs a CUDA
card and exits 1 without one.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

CHANGE = Path(__file__).resolve().parents[2]
ORDER = ("parent", "change", "runtime_julia", "runtime_julia", "change",
         "parent") * 2
# (reference, subject): adjacent runs of these trees form a pair.
PAIRS = (("parent", "change"), ("change", "runtime_julia"))
# K2's compile-time Julia select and the runtime select that replaces it
# in the runtime_julia tree.
JULIA_FLAG_LINES = {
    "const float cr = JULIA ? p.row[t][4] : gr;":
        "const float cr = p.julia ? p.row[t][4] : gr;",
    "const float ci = JULIA ? p.row[t][5] : gi;":
        "const float ci = p.julia ? p.row[t][5] : gi;",
}
KERNELS_CU = Path("distributedmandelbrot_tpu_torch/ops/csrc/"
                  "escape_kernels.cu")


def runtime_julia_tree(change: Path) -> Path:
    """A copy of ``change``'s package and chip_smoke.py whose K2 selects
    the Julia constant at run time."""
    dst = (change / "distributedmandelbrot_tpu_torch" / "_build"
           / "ab_runtime_julia")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(change / "distributedmandelbrot_tpu_torch",
                    dst / "distributedmandelbrot_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(change / "chip_smoke.py", dst / "chip_smoke.py")
    cu = dst / KERNELS_CU
    src = cu.read_text()
    for old, new in JULIA_FLAG_LINES.items():
        if src.count(old) != 1:
            raise SystemExit(f"ab_trees: expected one {old!r} in {cu}")
        src = src.replace(old, new)
    cu.write_text(src)
    return dst


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


def pair_ratios(runs: list[dict]) -> dict:
    """For each (reference, subject) of ``PAIRS``, the subject's ratio to
    the reference in every pair of adjacent runs of those two trees."""
    out = {f"{subj}_over_{ref}": [] for ref, subj in PAIRS}
    for a, b in zip(runs, runs[1:]):
        for ref, subj in PAIRS:
            if {a["tree"], b["tree"]} == {ref, subj}:
                r, s = (a, b) if a["tree"] == ref else (b, a)
                out[f"{subj}_over_{ref}"].append(
                    {key: s[key] / r[key] for key in (
                        "drain_chunks_per_s_median", "k2_ms", "k1_ms")})
    return out


def child(tree: Path, drains: int) -> dict:
    """One run of ``tree``: its package and chip_smoke.py, on cuda:0."""
    sys.path.insert(0, str(tree))
    import contextlib
    import io

    import torch

    import chip_smoke as cs
    from distributedmandelbrot_tpu_torch import worker as wk
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.ops import _build
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    for mod in (cs, ce):
        if not Path(mod.__file__).resolve().is_relative_to(tree.resolve()):
            raise SystemExit(f"ab_trees: {mod.__name__} came from "
                             f"{mod.__file__}, not {tree}")
    t0 = time.monotonic()
    _build.load()
    build_s = time.monotonic() - t0
    dev = torch.device("cuda", 0)
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
    n = len(workloads)
    return {"build_s": build_s, "drain_walls_s": walls,
            "drain_chunks_per_s": [n / w for w in walls],
            "drain_chunks_per_s_median": statistics.median(n / w
                                                           for w in walls),
            "drain_launches": launches,
            "profile_wall_s": profile["wall_s"],
            "device_busy_share": profile["device_busy_share"],
            "device_ms_by_kind": profile["device_ms_by_kind"],
            "k2_ms": k2_ms, "k1_ms": k1_ms}


def main(argv: list[str]) -> int:
    if "--child" in argv:
        i = argv.index("--child")
        drains = int(argv[argv.index("--drains") + 1])
        print(json.dumps(child(Path(argv[i + 1]), drains)), flush=True)
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
    trees = {"parent": parent, "change": CHANGE,
             "runtime_julia": runtime_julia_tree(CHANGE)}
    runs = []
    for label in ORDER:
        env = dict(os.environ, PYTHONPATH=str(trees[label]))
        proc = subprocess.run(
            [sys.executable, __file__, "--child", str(trees[label]),
             "--drains", drains], env=env, cwd=trees[label],
            capture_output=True, text=True, timeout=600)
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
                          for key in ("drain_chunks_per_s_median",
                                      "device_busy_share", "k2_ms",
                                      "k1_ms")}
    out = {"order": ORDER, "card": card.strip(), "medians": summary,
           "pairs": pair_ratios(runs)}
    if "--out" in args:
        Path(args["--out"]).write_text(json.dumps({"runs": runs, **out},
                                                  indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
