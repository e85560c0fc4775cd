"""The port's native library (``distributedmandelbrot_tpu_torch/native``):
the same C++ sources as the JAX package's, built without the race its
build has under several processes, and the same results.

The JAX package's build step compiles every process to one temporary and
guards the build with a thread lock only, so concurrent first loads in
several processes can fail; the port's holds a file lock across the
check, the build and the rename, and compiles to a temporary of its own
per process.  Skips where no g++ is found."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributedmandelbrot_tpu.ops import perturbation as RP
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.native import bindings, build
from distributedmandelbrot_tpu_torch.worker import NativeBackend, NumpyBackend

REPO = Path(__file__).resolve().parent.parent
REF_SRC = REPO / "distributedmandelbrot_tpu" / "native" / "src"
PORT_SRC = REPO / "distributedmandelbrot_tpu_torch" / "native" / "src"
PROCESSES = 6

_LOAD_IN = r"""
import json, sys
from distributedmandelbrot_tpu_torch.native import bindings, build
build.BUILD_DIR = sys.argv[1]
ok = bindings.native_supported()
print(json.dumps({"ok": ok, "escape": int(bindings.fixed_escape(
    -3 << 60, 1 << 59, -3 << 60, 1 << 59, 100, 62)) if ok else None}))
"""


@pytest.fixture(autouse=True)
def _reference_in_python(monkeypatch):
    """The JAX package's fixed-point functions on their pure-Python path
    (exact, the same results): its own native library is left to its
    own tests, whose build is not safe under concurrent first use."""
    monkeypatch.setattr(RP, "_native_fixed", lambda *a, **k: False)


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library with")
    if not bindings.native_supported():
        pytest.fail("g++ is present but the port's native library did not "
                    "build")
    return bindings


@pytest.mark.parametrize("name", ["fixed.cc", "escape.cc", "rle.cc"])
def test_sources_are_the_jax_packages(name):
    assert (PORT_SRC / name).read_bytes() == (REF_SRC / name).read_bytes()


def test_six_processes_load_from_an_empty_build_directory(native, tmp_path):
    """Six fresh interpreters load the library at once from an empty
    build directory: every one loads it, and one library is left."""
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("DMTPU_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_IN,
                               str(build_dir)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROCESSES)]
    reports = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        reports.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["ok"] for r in reports] == [True] * PROCESSES
    assert len({r["escape"] for r in reports}) == 1
    assert sorted(f.name for f in build_dir.iterdir()
                  if not f.name.endswith(".lock")) == [
        "libdmtpu_native.so"]


def test_fixed_point_kernels_equal_the_jax_packages(native):
    bits = 128
    for c_re, c_im in (("-0.77568377", "0.13646737"), ("0.25", "0.5"),
                       ("-1.7548776662466927", "0"), ("2.5", "0.1")):
        za, zb = RP._to_fixed(c_re, bits), RP._to_fixed(c_im, bits)
        for mi in (50, 3000):
            assert native.fixed_escape(za, zb, za, zb, mi, bits) == \
                RP._escape_count_fixed(za, zb, mi, bits)
            got = native.fixed_orbit(za, zb, za, zb, mi, bits, 12)
            want = RP._orbit_fixed_impl(za, zb, za, zb, mi, bits, 12)
            assert got[2] == want[2]
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
    pts = [(RP._to_fixed(repr(x), bits), RP._to_fixed(repr(y), bits))
           for x, y in ((-0.75, 0.1), (0.3, 0.5), (-2.0, 0.0))]
    for jc in (None, (RP._to_fixed("-0.8", bits),
                      RP._to_fixed("0.156", bits))):
        ca, cb = jc or (None, None)
        assert np.array_equal(
            native.fixed_escape_batch(pts, 500, bits, julia_c=jc),
            np.array([RP._escape_count_fixed(a, b, 500, bits, ca, cb)
                      for a, b in pts], np.int32))


def test_rle_and_escape_pixels_equal_the_golden(native):
    rng = np.random.default_rng(3)
    data = np.repeat(rng.integers(0, 4, 300, dtype=np.uint8),
                     rng.integers(1, 40, 300))
    body = native.rle_encode(data)
    assert np.array_equal(native.rle_decode(body, data.size), data)
    cr, ci = np.meshgrid(np.linspace(-2, 1, 40), np.linspace(-1.5, 1.5, 30))
    from distributedmandelbrot_tpu_torch.ops import reference
    want = reference.scale_counts_to_uint8(
        reference.escape_counts(cr, ci, 300), 300).ravel()
    assert np.array_equal(native.escape_pixels(cr, ci, 300), want)


@pytest.mark.parametrize("key", [(2, 0, 1, 64), (4, 2, 1, 300)])
def test_native_backend_equals_the_numpy_backend(native, key):
    level, i, j, mi = key
    w = Workload(level, mi, i, j)
    got = NativeBackend(definition=64).compute_batch([w])[0]
    want = NumpyBackend(definition=64).compute_batch([w])[0]
    assert np.array_equal(got, want)


def test_worker_takes_the_native_backend(native):
    from distributedmandelbrot_tpu_torch import cli
    assert isinstance(cli._make_backend("native", None, "cpu"),
                      NativeBackend)


def test_disabled_native_falls_back(tmp_path):
    """``DMTPU_NATIVE=0`` leaves the library unloaded in a fresh
    interpreter, and the fixed-point paths then take the Python loop."""
    env = dict(os.environ, PYTHONPATH=str(REPO), DMTPU_NATIVE="0")
    proc = subprocess.run(
        [sys.executable, "-c", "from distributedmandelbrot_tpu_torch.ops "
         "import perturbation as P; from distributedmandelbrot_tpu_torch."
         "native import build; print(build.available(), "
         "P.escape_counts_exact('-0.5', '0.1', 100))"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "0"]
    assert build.BUILD_DIR.endswith("_build")
