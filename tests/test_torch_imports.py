"""The port stands alone: it imports neither JAX nor the JAX package, and
the modules it carries from the JAX package stay the same code."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "distributedmandelbrot_tpu"
PORT = REPO / "distributedmandelbrot_tpu_torch"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import distributedmandelbrot_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(port.__path__,
                                                     port.__name__ + "."))
for name in names:
    importlib.import_module(name)
loaded = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith("jax.")
    or n == "distributedmandelbrot_tpu"
    or n.startswith("distributedmandelbrot_tpu."))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""

# Pure-Python modules carried from the JAX package: the same source with
# the package name renamed, so a fix on one side shows up as a diff here.
CARRIED = [
    "core/geometry.py", "core/workload.py", "ops/reference.py",
    "obs/events.py", "obs/metrics.py", "obs/flight.py", "obs/spans.py",
    "utils/metrics.py", "utils/faults.py", "net/framing.py",
    "net/protocol.py", "worker/client.py", "worker/pipeline.py",
    "worker/worker.py", "native/__init__.py", "native/bindings.py",
    "core/chunk.py", "codecs/__init__.py", "codecs/base.py", "codecs/raw.py",
    "codecs/checkpoint.py", "storage/__init__.py", "storage/index.py",
    "storage/backends.py", "storage/store.py", "storage/ownership.py",
    "coordinator/clock.py", "coordinator/scheduler.py",
    "coordinator/recovery.py", "coordinator/dataserver.py",
    "coordinator/distributer.py", "coordinator/app.py",
    "coordinator/embed.py", "coordinator/__init__.py", "obs/trace.py",
    "obs/chrome.py", "obs/exporter.py", "obs/timeseries.py", "obs/slo.py",
    "serve/coalesce.py", "serve/cache.py", "serve/ondemand.py",
    "serve/gateway.py", "sessions/__init__.py", "sessions/table.py",
    "sessions/predict.py", "sessions/prefetch.py", "sessions/refine.py",
    "sessions/service.py", "viewer/client.py",
    "control/__init__.py", "control/ring.py", "control/sharded.py",
    "obs/fleet.py", "obs/top.py", "obs/postmortem.py",
    "loadgen/__init__.py", "loadgen/driver.py", "loadgen/recorder.py",
    "loadgen/replicas.py", "loadgen/runner.py", "loadgen/schedule.py",
    "loadgen/trajectory.py", "chaos/__init__.py", "chaos/driver.py",
    "chaos/runner.py",
]


def _renamed(path: Path) -> str:
    return re.sub(r"\bdistributedmandelbrot_tpu\b",
                  "distributedmandelbrot_tpu_torch", path.read_text())


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module imports in a fresh interpreter without loading
    ``jax`` or any module of the JAX package (matched exactly: the port's
    own name shares the prefix)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    for mod in ("ops.cuda_escape", "ops.escape_time", "ops._build",
                "ops.families", "ops.compact_escape", "ops.mxu_iteration",
                "ops.mixed_precision", "parallel",
                "parallel.mesh", "parallel.sharding", "parallel.backend",
                "parallel.multihost", "serve.render", "viewer.render",
                "worker.backends", "worker.pipeline", "cli", "__main__",
                "ops.perturbation", "ops.cuda_perturb", "ops.bla", "native",
                "native.bindings", "native.build", "core.chunk", "codecs",
                "codecs.base", "codecs.raw", "codecs.checkpoint", "storage",
                "storage.index", "storage.backends", "storage.store",
                "storage.ownership", "coordinator", "coordinator.app",
                "coordinator.clock", "coordinator.scheduler",
                "coordinator.recovery", "coordinator.dataserver",
                "coordinator.distributer", "coordinator.embed", "obs.trace",
                "obs.chrome", "obs.exporter", "obs.timeseries", "obs.slo",
                "serve", "serve.coalesce", "serve.cache", "serve.ondemand",
                "serve.gateway", "sessions", "sessions.table",
                "sessions.predict", "sessions.prefetch", "sessions.refine",
                "sessions.service", "viewer", "viewer.client", "control",
                "control.ring", "control.sharded", "obs.fleet", "obs.top",
                "obs.postmortem", "loadgen", "loadgen.driver",
                "loadgen.recorder", "loadgen.replicas", "loadgen.runner",
                "loadgen.schedule", "loadgen.trajectory", "chaos",
                "chaos.driver", "chaos.runner"):
        assert f"distributedmandelbrot_tpu_torch.{mod}" in report["modules"]


_RENDER = r"""
import json, sys
from distributedmandelbrot_tpu_torch import cli
out = sys.argv[1]
for flags in ([], ["--fractal", "julia", "--smooth", "--dtype", "f32"],
              ["--fractal", "ship", "--supersample", "4"],
              ["--fractal", "multibrot", "--smooth"],
              ["--deep", "--center=-0.77568377,0.13646737", "--span", "1e-10"],
              ["--fractal", "julia", "--span", "1e-13", "--smooth"]):
    assert cli.main(["render", *flags, "--definition", "64", "--max-iter",
                     "200", "--device", "cpu", "--out", out, "-q"]) == 0
loaded = sorted(
    n for n in sys.modules
    if n.split(".")[0] in ("jax", "distributedmandelbrot_tpu", "matplotlib",
                           "PIL", "sympy"))
print(json.dumps({"forbidden": loaded}))
"""


def test_render_needs_neither_jax_nor_matplotlib(tmp_path):
    """A CPU render of every kind, in a fresh interpreter, loads no
    module of JAX, the JAX package, matplotlib or PIL (the machine with
    the card has none of the last two), nor sympy (which
    ``torch.broadcast_shapes`` imports: seconds of a first render)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = tmp_path / "view.png"
    proc = subprocess.run([sys.executable, "-c", _RENDER, str(out)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    assert out.read_bytes().startswith(b"\x89PNG")


@pytest.mark.parametrize("rel", CARRIED)
def test_carried_module_matches_the_jax_package(rel):
    assert (PORT / rel).read_text() == _renamed(REF / rel)


def test_names_only_add_the_demotion_counter():
    """``obs/names.py`` is carried with two additions: the port counts its
    demotions by route, and the MXU census shadows that failed."""
    ref = _renamed(REF / "obs/names.py").splitlines()
    port = (PORT / "obs/names.py").read_text().splitlines()
    assert set(ref) <= set(port)
    code = [line for line in port
            if line not in ref and line and not line.startswith("#")]
    assert code == ['WORKER_KERNEL_DEMOTIONS = "worker_kernel_demotions"',
                    'ROUTE_FUSED_TO_PER_TILE = "fused_to_per_tile"',
                    'ROUTE_PER_TILE_TO_TORCH = "per_tile_to_torch"',
                    'ROUTE_MESH_TO_FUSED = "mesh_to_fused"',
                    'ROUTE_BATCH_TO_TORCH = "batch_to_torch"',
                    'WORKER_MXU_CENSUS_FAILURES = '
                    '"worker_mxu_census_failures"']
