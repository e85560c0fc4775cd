"""Fixtures of the benchmark's own tests: a copy of the benchmark with
tiny cells that run on the CPU (the kernels' plain versions), and the
``gpu`` marker.

    python -m pytest benchmark/tests            # here: the CPU tests
    python -m pytest -m gpu benchmark/tests     # on a CUDA card
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The tiny cells: the canonical farm at one level of four chunks and a
# budget of 12 (chunks stay 4096^2, as the program computes them), the
# deep views at 48^2 on a walk of 12, and one 32^2 view in the seahorse
# valley at 1e-10 whose deepest pixels the route repairs.
TINY = {"canonical.drain-inproc": ["tiny.drain-inproc"],
        "deep-config4.views-1024": ["tinydeep.views-48",
                                    "tinyglitch.views-32"]}
SEAHORSE = ["-0.743643887037158704752191506114774",
            "0.131825904205311970493132056385139"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def with_held(bench: dict) -> dict:
    """``bench`` with the held-out cells' entries added back, as a later
    change adds them (``benchmark/held/``)."""
    for path in sorted((ROOT / "benchmark" / "held").glob("*.json")):
        held = json.loads(path.read_text())
        for group in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[group] += held[group]
    return bench


def make_root(base: Path) -> Path:
    """A checkout holding the benchmark with the held-out cells added
    back and the tiny cells added, as files and entries (nothing else
    edited)."""
    root = base / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = with_held(json.loads((root / "BENCHMARK.json").read_text()))
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "canonical.json").read_text())
    # Four chunks: a window as wide as the configuration's would hold a
    # chunk twice and fuse it with itself, so the tiny drain keeps the
    # worker's default window and depth.
    cfg.update(levels="2:12", steps_table=None)
    cfg["worker"].update(window=4, depth=2)
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    shutil.copy(b / "configs" / "deep-config4.json",
                b / "configs" / "tinydeep.json")
    tr = json.loads((b / "traffic" / "drain-inproc.json").read_text())
    tr.update(check={"2": 4}, warmup_levels="1:12")
    (b / "traffic" / "tiny-drain-inproc.json").write_text(json.dumps(tr))
    tv = json.loads((b / "traffic" / "views-1024.json").read_text())
    tv["definition"] = 48
    tv["path"]["views"] = 12
    tv["check"].update(views=2, among_first=4, pixels=8, deepest=2)
    (b / "traffic" / "views-48.json").write_text(json.dumps(tv))
    deep = json.loads((b / "configs" / "deep-config4.json").read_text())
    deep.update(center=SEAHORSE, span=1e-10, max_iter=20000)
    (b / "configs" / "tinyglitch.json").write_text(json.dumps(deep))
    tv["definition"] = 32
    tv["path"].update(views=2, span_min=1e-10, span_max=1e-10, zoom_min=1.0,
                      zoom_max=1.0, pan_max=0.0, radius=0.0)
    tv["check"].update(views=1, among_first=1)
    (b / "traffic" / "views-32.json").write_text(json.dumps(tv))
    bench["configs"] += [
        {"name": "tiny", "source": "a test", "file":
         "benchmark/configs/tiny.json", "reduced": ["levels"], "why": "t"},
        {"name": "tinydeep", "source": "a test", "file":
         "benchmark/configs/tinydeep.json", "reduced": [], "why": "t"},
        {"name": "tinyglitch", "source": "a test", "file":
         "benchmark/configs/tinyglitch.json", "reduced": [], "why": "t"}]
    bench["workloads"] += [
        {"name": "tiny.drain-inproc", "config": "tiny",
         "traffic": "tiny-drain-inproc", "chips": 1, "why": "t"},
        {"name": "tinydeep.views-48", "config": "tinydeep",
         "traffic": "views-48", "chips": 1, "why": "t"},
        {"name": "tinyglitch.views-32", "config": "tinyglitch",
         "traffic": "views-32", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for w in m["workloads"]
                               for t in TINY.get(w, [])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


def run_cpu(root: Path, name: str, *, seconds: float = 6.0,
            seed: int = 2**31 + 77, trace: bool = False,
            control: bool = False):
    """A run of a tiny cell on the CPU, past the look for a card: the
    driver's record and the result line."""
    from benchmark.harness.spec import Cell
    from benchmark.run import report
    cell = Cell(name, root)
    rec = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace,
                            t_process=time.monotonic(), device="cpu",
                            control=control)
    return rec, report(cell, rec, trace)
