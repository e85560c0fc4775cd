"""The controls, on a CUDA card at each cell's own size: the reference in
the next precision below the configuration's put in the program's place
(the drains: the plain loop in bfloat16 as the worker's backend), or the
program's own lower-precision path (the deep views: ``--dtype f32`` for
float64).  Every run must come out not correct.

    python -m pytest -m gpu benchmark/tests/test_bench_control.py -s

Each run prints its checks, the upper readings the limits are set below.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import Cell
from conftest import ROOT

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
# Long enough to compare as many chunks or views as a run does: the
# drains' control (about 23 chunks a second on an H100) passes every
# drawn chunk, the views' checks as many views as a window holds.
SECONDS = {"drain": 50, "views": 50}


def _cells() -> list[str]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda, cell, seed):
    seconds = SECONDS[Cell(cell, ROOT).traffic["kind"]]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", str(seconds), "--control"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps({"cell": cell, "seed": seed,
                      "checks": result["checks"]}))
    assert result["correct"] is False
