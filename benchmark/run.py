#!/usr/bin/env python3
"""Benchmark of distributedmandelbrot_tpu_torch on CUDA cards: one cell,
one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Reads ``BENCHMARK.json``, finds the cell's
configuration, traffic mix, driver and metric readers by name
(``benchmark/harness/spec.py``), makes set-up, measures for ``--seconds``
and checks what the window produced against the plain references in
``benchmark/reference``.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a device trace of the
window.  The numbers compared, each beside its limit, are the last lines
on standard error; the last line on standard output is the result:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, ["breakdown": {...},] "checks": {...}}

Exits non-zero, printing no result, without the cards the cell asks for,
or if JAX, a relative of it or the JAX package was loaded.
``--control`` puts the cell's control in the program's place (the check
must then fail); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _number(v):
    return v if isinstance(v, (int, bool)) or v is None else float(v)


def report(cell, rec, trace: bool) -> dict:
    """The result line of a run's record: the cell's end-to-end metrics
    (``trace`` False) or per-layer metrics, each its reader's number;
    the checks last."""
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(rec.device)
    result = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = {name: {"value": _number(c["value"]),
                               "limit": _number(c["limit"])}
                        for name, c in rec.checks.items()}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    # A library the port uses may not load JAX by itself.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import chip
    from benchmark.harness.spec import Cell
    cell = Cell(args.workload, ROOT)
    try:
        chip.require_cards(cell.chips)
    except chip.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    print(f"benchmark: {cell.name} on {chip.power_limit()}", file=sys.stderr)
    rec = cell.driver().run(cell, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), t_process=T_PROCESS,
                            control=args.control)
    found = chip.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    result = report(cell, rec, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
