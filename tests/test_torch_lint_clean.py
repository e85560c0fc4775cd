"""The port's gate: ``python -m distributedmandelbrot_tpu_torch check``
is clean on the port's own tree, as cheap as the JAX package's check on
its tree, and imports neither torch, jax nor the JAX package; the port's
baseline is its own and stays empty; the port's metric-name audit
(``distributedmandelbrot_tpu_torch/tools/check_metrics.py``) passes.

"Cheap" is CPU time, not wall time: the child's CPU seconds
(``RUSAGE_CHILDREN``) against the JAX package's ``check --json`` child
in the same test, so a loaded machine slows both alike.
"""

from __future__ import annotations

import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributedmandelbrot_tpu_torch"
PORT_BASELINE = PORT / "tools" / "lint_baseline.json"
REF_BASELINE = REPO / "tools" / "lint_baseline.json"
CHECK_METRICS = PORT / "tools" / "check_metrics.py"

# The check's CPU time may exceed the reference's by this factor.
CPU_RATIO = 1.25

GATE_SCRIPT = """\
import sys
from distributedmandelbrot_tpu_torch.cli import main
rc = main(["check", "--json"])
loaded = sorted(n for n in sys.modules if n.split(".")[0]
                in ("jax", "torch", "distributedmandelbrot_tpu"))
assert not loaded, f"check imported {loaded}"
sys.exit(rc)
"""


def _run_timed(argv: list, env: dict | None = None):
    """The child's result and its CPU seconds (user + system)."""
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    result = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                            timeout=120, env=env)
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (after.ru_utime - before.ru_utime) \
        + (after.ru_stime - before.ru_stime)
    return result, cpu


def test_port_is_lint_clean_cheap_and_torch_free():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result, port_cpu = _run_timed([sys.executable, "-c", GATE_SCRIPT], env)
    assert result.returncode == 0, \
        f"check found problems:\n{result.stdout}\n{result.stderr}"
    doc = json.loads(result.stdout)
    assert doc["counts"]["total"] == 0, doc["findings"]
    assert doc["stale_baseline"] == []

    ref, ref_cpu = _run_timed(
        [sys.executable, "-m", "distributedmandelbrot_tpu", "check",
         "--json"], dict(env, JAX_PLATFORMS="cpu"))
    assert "counts" in json.loads(ref.stdout), ref.stderr
    assert port_cpu <= CPU_RATIO * ref_cpu, \
        f"check took {port_cpu:.2f} s of CPU, the reference's " \
        f"{ref_cpu:.2f} s (budget x{CPU_RATIO})"


def test_port_families_are_registered_and_jax_is_not():
    from distributedmandelbrot_tpu_torch import analysis
    families = {r.family for r in analysis.all_rules().values()}
    assert {"proto", "res", "obs", "taint", "exc", "fsm",
            "torch"} <= families
    assert "jax" not in families
    assert set(analysis.expand_rule_ids(["torch"])) == \
        {"torch-host-sync", "torch-dtype-mix"}


def test_port_baseline_is_its_own_and_empty():
    """Committed empty, in the JAX package's baseline format."""
    doc = json.loads(PORT_BASELINE.read_text())
    assert doc == {"findings": [], "version": 1}
    assert PORT_BASELINE.read_text() == REF_BASELINE.read_text()


def test_update_baseline_writes_the_port_baseline_only(tmp_path, capsys):
    from distributedmandelbrot_tpu_torch.cli import main
    root = tmp_path / "tree"
    shutil.copytree(PORT, root / PORT.name,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(REPO / "tools", root / "tools")
    ref_before = REF_BASELINE.read_bytes()
    # One planted finding, so the rewrite has something to grandfather.
    (root / PORT.name / "serve" / "planted.py").write_text(
        "import threading\n\nclass Cache:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._items = {}\n\n"
        "    def put(self, k, v):\n"
        "        with self._lock:\n"
        "            self._items[k] = v\n\n"
        "    def rogue(self, k):\n"
        "        self._items.pop(k, None)\n")
    assert main(["check", "--root", str(root)]) == 1
    assert main(["check", "--root", str(root), "--update-baseline"]) == 0
    written = json.loads(
        (root / PORT.name / "tools" / "lint_baseline.json").read_text())
    assert [fp.split("::")[:2] for fp in written["findings"]] == \
        [["lock-guard", f"{PORT.name}/serve/planted.py"]]
    assert (root / "tools" / "lint_baseline.json").read_bytes() \
        == ref_before
    assert REF_BASELINE.read_bytes() == ref_before
    assert PORT_BASELINE.read_text() == REF_BASELINE.read_text()
    capsys.readouterr()
    assert main(["check", "--root", str(root), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"]["baselined"] == 1
    assert doc["stale_baseline"] == []


def test_check_diff_head_runs_clean(capsys):
    if shutil.which("git") is None or subprocess.run(
            ["git", "-C", str(REPO), "rev-parse", "HEAD"],
            capture_output=True).returncode != 0:
        pytest.skip("not a git checkout")
    from distributedmandelbrot_tpu_torch.cli import main
    assert main(["check", "--diff", "HEAD", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"]["total"] == 0
    assert doc["stale_baseline"] == []


def _load_check_metrics():
    spec = importlib.util.spec_from_file_location("port_check_metrics",
                                                  CHECK_METRICS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_render_prometheus_validates_against_spec_parser():
    from distributedmandelbrot_tpu_torch.obs.exporter import \
        render_prometheus
    check = _load_check_metrics()
    reg = check._sample_registry()
    families = check.parse_exposition(render_prometheus(reg))
    check.check_invariants(families)
    assert families["latency_seconds"]["type"] == "histogram"


def test_spec_parser_rejects_malformed_text():
    check = _load_check_metrics()
    with pytest.raises(check.MetricsFormatError):
        check.parse_exposition("no_type_line 1\n")
    with pytest.raises(check.MetricsFormatError):
        check.parse_exposition("# TYPE x counter\nx 1")  # no trailing \n


def test_metric_name_literals_are_registered():
    result = subprocess.run(
        [sys.executable, str(CHECK_METRICS), "--offline", "--names",
         "--dead"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, \
        f"check_metrics --names --dead failed:\n" \
        f"{result.stdout}\n{result.stderr}"
    assert "names:" in result.stdout
    assert "dead:" in result.stdout
