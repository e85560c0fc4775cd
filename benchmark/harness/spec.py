"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration's file
is the one ``BENCHMARK.json`` gives it; the traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/drivers/<kind>.py`` that runs it; each metric is read by
``benchmark/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it names is missing or inconsistent."""


def load_json(path: Path) -> dict:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except FileNotFoundError:
        raise SpecError(f"missing {path}") from None


def _module(path: Path, name: str):
    if not path.is_file():
        raise SpecError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    driver and metrics."""

    def __init__(self, name: str, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json; it "
                            f"has {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(self.root / configs[self.entry["config"]]
                                ["file"])
        self.traffic = load_json(self.root / "benchmark" / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])

    def driver(self):
        kind = self.traffic["kind"]
        return _module(self.root / "benchmark" / "drivers" / f"{kind}.py",
                       f"benchmark_driver_{kind}")

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` False) or per-layer
        metrics (True): those listing this cell, or listing none."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return _module(self.root / "benchmark" / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))

    def path(self, relative: str) -> Path:
        return self.root / relative
