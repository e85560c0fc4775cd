"""The perturbation deep-zoom route of the port (``ops/perturbation.py``,
``ops/cuda_perturb.py``) against the JAX package's
``ops/perturbation.py`` on the CPU.

- The host side (fixed point, the reference orbit, the exact counts, the
  reference search, the secondary candidates) equals the JAX package's
  exactly.
- The plain scans (K9's and K10's plain versions) against the JAX scans,
  f32 and f64, Mandelbrot and Julia, the stagnation stop armed and not:
  equal except where XLA:CPU contracts a multiply and an add into an FMA
  and the port does not (the differing pixels are counted and bounded;
  ROADMAP queue 3 has the counts).  The segment loop equals the JAX
  package's exactly.
- The kernels' per-pixel loops (``ops/csrc/perturb.cuh``), built for the
  host by g++ through ``ops/csrc/host/perturb_scan.cpp``
  (``-ffp-contract=off``), run through the wrappers' own host loops:
  bitwise the plain versions, over segment seams, short orbits and the
  stagnation stop.  Skips where no C++ compiler is found.
- The whole routes: sampled pixels equal the exact fixed-point counts,
  and the port's mismatch against the exact counts is at most the JAX
  package's own plus 0.5 percentage points.

The JAX package's fixed-point functions run on their pure-Python path
here (exact, the same results; its native build is not safe under
several first users at once and is left to its own tests)."""

import ctypes
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.ops import perturbation as RP
from distributedmandelbrot_tpu_torch.ops import cuda_perturb as CP
from distributedmandelbrot_tpu_torch.ops import perturbation as P

CSRC = Path(CP.__file__).resolve().parent / "csrc"
CONFIG4 = ("-0.77568376995", "0.13646737005")
M_RE, M_IM = "-0.77568377", "0.13646737"
SEAHORSE = ("-0.74529", "0.11307")
# The seahorse valley's Misiurewicz point, boundary at every depth.
MISIUREWICZ = ("-0.743643887037158704752191506114774",
               "0.131825904205311970493132056385139")
MINIBROT3 = ("-1.7548776662466927", "0.0")
JULIA_C = ("-0.8", "0.156")
JULIA_PT = ("1.5275031186435346", "-0.07591217835228786")
DTYPES = {"f32": np.float32, "f64": np.float64}


@pytest.fixture(autouse=True)
def _reference_in_python(monkeypatch):
    monkeypatch.setattr(RP, "_native_fixed", lambda *a, **k: False)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build perturb.cuh's loop with")
    out = tmp_path_factory.mktemp("dm_perturb") / "libdm_perturb_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(CSRC / "host"), "-I",
                    str(CSRC), str(CSRC / "host" / "perturb_scan.cpp"), "-o",
                    str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, i, d, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_longlong)
    dc = [vp, ll, ll, vp, ll, ll]
    lib.dm_perturb_scan.argtypes = [i, i, vp, vp, *dc, i, i, vp, vp, vp,
                                    vp, ll, ll, i, i, vp, vp]
    lib.dm_perturb_scan.restype = i
    lib.dm_perturb_scan_smooth.argtypes = [i, i, vp, vp, *dc, i, i, d, d,
                                           vp, vp, vp, vp, vp, vp, vp, ll,
                                           ll, i, vp]
    lib.dm_perturb_scan_smooth.restype = i
    lib.dm_error_string.argtypes = [i]
    lib.dm_error_string.restype = ctypes.c_char_p
    return lib


def _bits(spec) -> int:
    need = int(-np.log2(spec.step)) + 64
    return max(P.DEFAULT_PREC_BITS, -(-need // 128) * 128)


def _scan_inputs(center, span, side, max_iter, dtype, julia_c=None,
                 orbit_len=None):
    """A view's reference orbit (the port's search) and its separable
    deltas as numpy, the way ``_compute_perturb`` feeds the scans."""
    spec = P.DeepTileSpec(*center, span, width=side, height=side)
    bits = _bits(spec)
    za, zb = P._to_fixed(center[0], bits), P._to_fixed(center[1], bits)
    ca, cb = ((za, zb) if julia_c is None else
              (P._to_fixed(julia_c[0], bits), P._to_fixed(julia_c[1], bits)))
    z_re, z_im, _, o_re, o_im = P._find_reference(
        za, zb, ca, cb, span, max_iter, bits, add_dc=julia_c is None)
    if orbit_len is not None:
        z_re, z_im = z_re[:orbit_len], z_im[:orbit_len]
    dre, dim = spec.delta_grids(np.float64)
    return z_re, z_im, (dre - o_re).astype(dtype), (dim - o_im).astype(dtype)


def _torch_inputs(z_re, z_im, dre, dim):
    return (torch.as_tensor(z_re), torch.as_tensor(z_im),
            torch.as_tensor(dre[0])[None, :].expand(dre.shape),
            torch.as_tensor(dim[:, 0])[:, None].expand(dim.shape))


def _exact_plane(spec, max_iter, julia_c=None) -> np.ndarray:
    """Every pixel's exact fixed-point count (the port's native batch)."""
    bits = _bits(spec)
    za, zb = P._to_fixed(spec.center_re, bits), P._to_fixed(spec.center_im,
                                                            bits)
    pts = []
    for r in range(spec.height):
        for c in range(spec.width):
            pts.append((za + P._to_fixed(float((c - (spec.width - 1) / 2)
                                               * spec.step), bits),
                        zb + P._to_fixed(float((r - (spec.height - 1) / 2)
                                               * spec.step), bits)))
    jc = None if julia_c is None else (P._to_fixed(julia_c[0], bits),
                                       P._to_fixed(julia_c[1], bits))
    return P._escape_counts_exact_batch(pts, max_iter, bits, jc).reshape(
        spec.height, spec.width)


# --- the host side, exactly ---------------------------------------------


@pytest.mark.parametrize("value", ["0.5", "-1.75", "0.1", "-0.77568377",
                                   "1e-20", "-2.5e-3", "3", "+0.25E+1",
                                   0.1, -1.75, 3.0 / 7.0])
@pytest.mark.parametrize("bits", [96, 128, 384])
def test_to_fixed_equals_the_jax_packages(value, bits):
    v = P._to_fixed(value, bits)
    assert v == RP._to_fixed(value, bits)
    assert P._fixed_to_float(v, bits) == RP._fixed_to_float(v, bits)


@pytest.mark.parametrize("center,max_iter", [
    (("-0.5", "0.1"), 60), (CONFIG4, 3000), (SEAHORSE, 1500),
    (("0.3", "0.5"), 200), (("-2.5", "0"), 20)])
def test_reference_orbit_equals_the_jax_packages(center, max_iter):
    got = P.reference_orbit(*center, max_iter)
    want = RP.reference_orbit(*center, max_iter)
    assert got[2] == want[2]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_escape_counts_exact_equals_the_jax_packages():
    for c in (-0.5 + 0.1j, 0.3 + 0.5j, -1.8 + 0.05j, 2.5 + 0j, -0.1 + 0j,
              -0.75 + 0.01j):
        assert P.escape_counts_exact(repr(c.real), repr(c.imag), 400) == \
            RP.escape_counts_exact(repr(c.real), repr(c.imag), 400)


@pytest.mark.parametrize("center,span,max_iter,julia_c", [
    (CONFIG4, 1e-10, 3000, None), (("-0.7453", "0.1127"), 2e-4, 800, None),
    (SEAHORSE, 1e-5, 1500, None), (MINIBROT3, 5e-2, 2000, None),
    (JULIA_PT, 1e-6, 1500, JULIA_C)],
    ids=["config4", "escaping_center", "seahorse", "minibrot", "julia"])
def test_find_reference_equals_the_jax_packages(center, span, max_iter,
                                                julia_c):
    """The hop search (its f64 probe scans on the port's device) picks
    the same reference and offset."""
    spec = P.DeepTileSpec(*center, span, width=32, height=32)
    bits = _bits(spec)
    za, zb = P._to_fixed(center[0], bits), P._to_fixed(center[1], bits)
    ca, cb = ((za, zb) if julia_c is None else
              (P._to_fixed(julia_c[0], bits), P._to_fixed(julia_c[1], bits)))
    got = P._find_reference(za, zb, ca, cb, span, max_iter, bits,
                            add_dc=julia_c is None)
    want = RP._find_reference(za, zb, ca, cb, span, max_iter, bits,
                              add_dc=julia_c is None)
    assert got[2:] == want[2:]
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


def test_deep_tile_spec_and_candidates_equal_the_jax_packages():
    spec = P.DeepTileSpec(*CONFIG4, 1e-10, width=40, height=24)
    ref = RP.DeepTileSpec(*CONFIG4, 1e-10, width=40, height=24)
    assert spec.step == ref.step
    for dt in (np.float32, np.float64):
        for a, b in zip(spec.delta_grids(dt), ref.delta_grids(dt)):
            assert np.array_equal(a, b)
    rng = np.random.default_rng(0)
    bad = np.argwhere(rng.random((24, 40)) < 0.2)
    scanned = rng.integers(0, 5, len(bad))
    assert np.array_equal(P._secondary_candidates(bad, scanned, 24, 40),
                          RP._secondary_candidates(bad, scanned, 24, 40))
    for name in ("DEFAULT_PREC_BITS", "GLITCH_TOL",
                 "SECONDARY_REFERENCE_TRIES", "PERTURB_SEGMENT",
                 "STAGNATION_QUIET_STEPS", "STAGNATION_MAX_LIVE",
                 "BLA_AUTO_MIN_BUDGET", "BLA_AUTO_PROBE_STEPS",
                 "BLA_AUTO_PROBE_LANES", "BLA_AUTO_SURVIVOR_FRAC",
                 "ORBIT_CACHE_MAX_STEPS"):
        assert getattr(P, name) == getattr(RP, name), name


# --- the segment loop and the plain scans --------------------------------


@pytest.mark.parametrize("steps,n_live,cap", [
    (4096, 4, 16), (4096, 64, 16), (4096 + 77, 4, 16), (300, 4, 16),
    (2048 + 256 * 3, 10, 64), (100, 1, 8)])
def test_segment_loop_equals_the_jax_loop(steps, n_live, cap):
    """A synthetic lane set whose live count stops changing: the port's
    segment loop stops where the JAX package's stops (or runs on), with
    the same suspect lanes and counts, a ragged tail included."""
    def port_step(carry, zs):
        alive, n = carry
        return alive, n + alive.to(torch.int32)

    def ref_step(carry, zs):
        alive, n = carry
        return (alive, n + alive.astype(jnp.int32)), None

    z = np.zeros(steps)
    alive0 = np.arange(128) < n_live
    init = (torch.as_tensor(alive0), torch.zeros(128, dtype=torch.int32))
    (alive, n), suspect = P._segmented_orbit_scan(
        port_step, init,
        torch.as_tensor(z), torch.as_tensor(z), lambda c: bool(c[0].any()),
        stagnation=(lambda c: int(c[0].sum()), lambda c: c[0], cap))
    (ralive, rn), rsuspect = RP._segmented_orbit_scan(
        ref_step, (jnp.asarray(alive0), jnp.zeros(128, jnp.int32)),
        jnp.asarray(z), jnp.asarray(z), lambda c: jnp.any(c[0]),
        stagnation=(lambda c: jnp.sum(c[0], dtype=jnp.int32),
                    lambda c: c[0], cap))
    assert np.array_equal(n.numpy(), np.asarray(rn))
    assert np.array_equal(suspect.numpy(), np.asarray(rsuspect))
    n2 = P._segmented_orbit_scan(
        port_step, init,
        torch.as_tensor(z), torch.as_tensor(z), lambda c: bool(c[0].any()))
    assert int(n2[1].max()) == steps


SCAN_VIEWS = {
    "config4": (CONFIG4, 1e-10, 32, 3000, None),
    "minibrot": (MINIBROT3, 5e-2, 16, 3000, None),
    "julia": (JULIA_PT, 1e-6, 32, 1500, JULIA_C),
    "misiurewicz": (MISIUREWICZ, 1e-13, 64, 4000, None),
}
# Share of pixels allowed to differ, where it is not 2%: at the
# Misiurewicz point every rounding step grows along the orbit, and in
# f32 the contracted JAX scan differs on 739 of 4096 counts (110 glitch,
# 74 alive); in f64 on 6 counts.  Without FMA on the host both are 0
# (``test_plain_scan_is_the_jax_scan_without_fma``).
SCAN_DIFF_SHARE = {("misiurewicz", "f32"): 0.19}


@pytest.mark.parametrize("stagnation", [True, False], ids=["stop", "nostop"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("view", sorted(SCAN_VIEWS))
def test_plain_scan_against_the_jax_scan(view, dtype, stagnation):
    """Counts, glitch and alive masks of the plain K9 scan against the
    JAX scan on the same orbit and deltas: equal but for the pixels
    XLA:CPU's FMA contraction moves (at most 2% here but at the
    Misiurewicz point in f32, printed)."""
    center, span, side, mi, jc = SCAN_VIEWS[view]
    z_re, z_im, dre, dim = _scan_inputs(center, span, side, mi,
                                        DTYPES[dtype], jc)
    add_dc = jc is None
    got = P._perturb_scan(*_torch_inputs(z_re, z_im, dre, dim), max_iter=mi,
                          add_dc=add_dc, stagnation=stagnation)
    want = RP._perturb_scan(jnp.asarray(z_re), jnp.asarray(z_im),
                            jnp.asarray(dre), jnp.asarray(dim), max_iter=mi,
                            add_dc=add_dc, stagnation=stagnation)
    diffs = [int((g.numpy() != np.asarray(w)).sum())
             for g, w in zip(got, want)]
    print(f"{view} {dtype} stagnation={stagnation}: counts, glitched, "
          f"active differ on {diffs} of {side * side} pixels")
    assert max(diffs) <= SCAN_DIFF_SHARE.get((view, dtype), 0.02) * \
        side * side


_JAX_SCANS_WITHOUT_FMA = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from distributedmandelbrot_tpu.ops import perturbation as RP
cases = json.loads(sys.argv[1])
for name, (mi, add_dc) in cases.items():
    a = np.load(sys.argv[2] + "/" + name + ".npz")
    out = RP._perturb_scan(*(jnp.asarray(a[k]) for k in
                             ("z_re", "z_im", "dre", "dim")),
                           max_iter=mi, add_dc=add_dc, stagnation=True)
    np.savez(sys.argv[2] + "/" + name + ".out.npz",
             *(np.asarray(o) for o in out))
"""


@pytest.fixture(scope="module")
def jax_scans_without_fma(tmp_path_factory):
    """The JAX scans of every ``SCAN_VIEWS`` case, f32 and f64, in an
    interpreter whose XLA:CPU may use no ISA past AVX (none with FMA),
    so nothing is contracted; the inputs are the port's."""
    work = tmp_path_factory.mktemp("no_fma")
    cases = {}
    for view, (center, span, side, mi, jc) in SCAN_VIEWS.items():
        for dtype in DTYPES:
            z_re, z_im, dre, dim = _scan_inputs(center, span, side, mi,
                                                DTYPES[dtype], jc)
            name = f"{view}-{dtype}"
            np.savez(work / f"{name}.npz", z_re=z_re, z_im=z_im, dre=dre,
                     dim=dim)
            cases[name] = (mi, jc is None)
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parent.parent),
               JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    proc = subprocess.run([sys.executable, "-c", _JAX_SCANS_WITHOUT_FMA,
                           json.dumps(cases), str(work)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return work


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("view", sorted(SCAN_VIEWS))
def test_plain_scan_is_the_jax_scan_without_fma(jax_scans_without_fma,
                                                view, dtype):
    """With FMA contraction ruled out (XLA:CPU held to AVX), the JAX scan
    and the plain K9 scan agree bit for bit on every view: the pixels
    ``test_plain_scan_against_the_jax_scan`` counts are all FMA
    contraction, none a fault of the port."""
    center, span, side, mi, jc = SCAN_VIEWS[view]
    inputs = _scan_inputs(center, span, side, mi, DTYPES[dtype], jc)
    got = P._perturb_scan(*_torch_inputs(*inputs), max_iter=mi,
                          add_dc=jc is None, stagnation=True)
    want = np.load(jax_scans_without_fma / f"{view}-{dtype}.out.npz")
    for i, g in enumerate(got):
        assert np.array_equal(g.numpy(), want[f"arr_{i}"]), (view, dtype, i)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("view", ["config4", "julia"])
def test_plain_smooth_scan_against_the_jax_scan(view, dtype):
    center, span, side, mi, jc = SCAN_VIEWS[view]
    z_re, z_im, dre, dim = _scan_inputs(center, span, side, mi,
                                        DTYPES[dtype], jc)
    nu, g = P._perturb_scan_smooth(*_torch_inputs(z_re, z_im, dre, dim),
                                   max_iter=mi, bailout=256.0,
                                   add_dc=jc is None)
    rnu, rg = RP._perturb_scan_smooth(
        jnp.asarray(z_re), jnp.asarray(z_im), jnp.asarray(dre),
        jnp.asarray(dim), max_iter=mi, bailout=256.0, add_dc=jc is None)
    nu, rnu = nu.numpy(), np.asarray(rnu)
    assert np.array_equal(nu == 0, rnu == 0)
    # Relative 1e-3 (f32) or 1e-6 (f64) on 95% of the pixels: at the
    # Julia view's repelling fixed point a rounding step that XLA:CPU
    # contracts grows with every iteration, so the values it moves are
    # counted, not required equal.
    close = np.abs(nu - rnu) <= (1e-3 if dtype == "f32" else 1e-6) * \
        np.maximum(np.abs(rnu), 1)
    print(f"{view} {dtype}: nu beyond tolerance on {int((~close).sum())}, "
          f"glitch mask on {int((g.numpy() != np.asarray(rg)).sum())}")
    assert close.mean() >= 0.95
    assert (g.numpy() != np.asarray(rg)).mean() <= 0.02


# --- the kernels' loops on the host, bitwise -----------------------------

# (view, orbit entries kept): whole segments, a ragged tail, an orbit
# shorter than one segment, the stagnation stop (minibrot at 20000).
LOOP_CASES = {
    "config4": (CONFIG4, 1e-10, 24, 3000, None, None),
    "config4_short_orbit": (CONFIG4, 1e-10, 24, 3000, None, 200),
    "seam_513": (SEAHORSE, 1e-5, 24, 1500, None, 513),
    "seam_768": (SEAHORSE, 1e-5, 24, 1500, None, 768),
    "stagnation_stop": (MINIBROT3, 5e-2, 16, 20000, None, None),
    "julia": (JULIA_PT, 1e-6, 24, 1500, JULIA_C, None),
}


@pytest.mark.parametrize("stagnation", [True, False], ids=["stop", "nostop"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_scan_loop_is_bitwise_the_plain_version(host_lib, case, dtype,
                                                stagnation):
    """K9's per-pixel loop through the wrapper's host loop (segments,
    counts, the stagnation rule, the tail) equals the plain version's
    n, active, glitched and suspect bit for bit."""
    center, span, side, mi, jc, keep = LOOP_CASES[case]
    inputs = _torch_inputs(*_scan_inputs(center, span, side, mi,
                                         DTYPES[dtype], jc, keep))
    add_dc = jc is None
    launches = []
    got = CP.scan_state_with(host_lib, *inputs, add_dc=add_dc,
                             stagnation=stagnation,
                             on_launch=lambda: launches.append(1))
    want = CP.perturb_state_plain(*inputs, add_dc=add_dc,
                                  stagnation=stagnation)
    for name, g, w in zip(("n", "active", "glitched", "suspect"), got, want):
        assert torch.equal(g, w), name
    if case == "stagnation_stop" and stagnation:
        # One launch of the first nine segments, then the tail.
        assert int(want[3].sum()) > 0 and len(launches) == 2
    if not stagnation:
        assert len(launches) == 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_smooth_loop_is_bitwise_the_plain_version(host_lib, case, dtype):
    center, span, side, mi, jc, keep = LOOP_CASES[case]
    if mi > 5000:
        mi = 3000
    inputs = _torch_inputs(*_scan_inputs(center, span, side, mi,
                                         DTYPES[dtype], jc, keep))
    got = CP.smooth_state_with(host_lib, *inputs, bailout=256.0,
                               add_dc=jc is None)
    want = CP.perturb_smooth_state_plain(*inputs, bailout=256.0,
                                         add_dc=jc is None)
    for name, g, w in zip(("n", "n2", "fzr", "fzi", "act_b", "act2",
                           "glitched"), got, want):
        assert torch.equal(g, w), name


def test_safe_segments_never_pass_a_stop():
    """The launch length rule: a stop for stagnation can only come at the
    launch's last segment end."""
    quiet = P.STAGNATION_QUIET_STEPS // P.PERTURB_SEGMENT
    assert P._safe_segments(0, 0, 10_000, 100) == quiet + 1
    assert P._safe_segments(5, 5, 10, 100) == quiet
    assert P._safe_segments(12, 5, 10, 100) == 1
    assert P._safe_segments(98, 90, 100_000, 100) == 2


def _segment_rule(counts, live0, cap, quiet):
    """The JAX package's segment loop over a sequence of live counts, one
    segment at a time -> the segments it runs."""
    seg, last_change, prev = 0, 0, live0
    while (seg < len(counts) and prev > 0
           and (seg - last_change < quiet or prev > cap)):
        if counts[seg] != prev:
            last_change = seg + 1
        prev = counts[seg]
        seg += 1
    return seg


@pytest.mark.parametrize("seed", range(6))
def test_stagnation_loop_stops_where_the_segment_rule_does(seed):
    """The shared driver, fed K9's way (k segments a launch, as
    ``_safe_segments`` allows) and the plain way (one at a time, the
    generator stopped where the loop ends), stops at the same segment as
    the one-segment-at-a-time rule, and never asks for segments past
    it."""
    rng = np.random.default_rng(seed)
    full, live0, cap = 60, 500, 16
    quiet = P.STAGNATION_QUIET_STEPS // P.PERTURB_SEGMENT
    # The count falls to a floor: retired (0), stagnant under the cap
    # (a stop), at the cap, or above it (the loop runs to the end).
    floor = (0, 5, 16, 17, 40, 1)[seed]
    counts, live = [], live0
    for _ in range(full):
        if rng.random() < 0.4:
            live = max(floor, live - int(rng.integers(1, 120)))
        counts.append(live)
    want = _segment_rule(counts, live0, cap, quiet)
    assert (want < full) == (floor <= cap)

    asked = []

    def batched(seg, k):
        asked.append((seg, k))
        return counts[seg:seg + k]

    def one_by_one(seg, k):
        for s in range(seg, seg + k):
            asked.append((s, 1))
            yield counts[s]

    for segments in (batched, one_by_one):
        asked.clear()
        got = P._stagnation_loop(segments, live0, full, cap=cap)
        assert got == want
        ran = max(s + k for s, k in asked)
        # Only segments whose lanes are all retired may run past the stop.
        assert all(c == 0 for c in counts[want:ran])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_orbit_table_holds_the_plain_steps_terms(dtype):
    """The kernels' orbit table: Z, 2Z and tol |Z|^2 in ``dtype``, each
    bitwise the plain step's own 0-d computation."""
    rng = np.random.default_rng(3)
    z_re = torch.as_tensor(rng.standard_normal(300))
    z_im = torch.as_tensor(rng.standard_normal(300))
    steps, ztol = CP.orbit_table(z_re, z_im, dtype)
    assert steps.shape == (300, 4) and steps.is_contiguous()
    tol = CP._tol(dtype, z_re.device)
    for k in (0, 1, 150, 299):
        zr, zi = z_re[k].to(dtype), z_im[k].to(dtype)
        _, _, _, zmag2 = CP._step_terms(zr, zi, zr * 0, zi * 0)
        want = torch.stack([zr, zi, zr + zr, zi + zi])
        assert torch.equal(steps[k], want)
        assert torch.equal(ztol[k], tol * zmag2)


def test_a_cuda_wrapper_without_a_card_raises(monkeypatch):
    """The wrappers take the plain version only for CPU tensors; the
    kernel path never falls back."""
    z = torch.zeros(4, dtype=torch.float64)
    d = torch.zeros(2, 2)

    def no_card():
        raise RuntimeError("no card here")

    from distributedmandelbrot_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "load", no_card)
    with pytest.raises(RuntimeError, match="no card"):
        CP.perturb_state_cuda(z, z, d, d)
    with pytest.raises(RuntimeError, match="no card"):
        CP.perturb_smooth_state_cuda(z, z, d, d, bailout=256.0)


# --- whole routes at the bar ---------------------------------------------


def _bar(ours, theirs, exact, sampled_seed):
    """The JAX tests' bar: at most 1 of 12 sampled pixels off the exact
    count, and the port's mismatch against the exact counts at most the
    JAX package's own plus 0.5 percentage points."""
    rng = np.random.default_rng(sampled_seed)
    h, w = exact.shape
    bad = sum(int(ours[r, c] != exact[r, c])
              for r, c in zip(rng.integers(h, size=12),
                              rng.integers(w, size=12)))
    mine = float((ours != exact).mean())
    ref = float((theirs != exact).mean())
    print(f"sampled off {bad}/12; mismatch port {mine:.4%}, JAX {ref:.4%}")
    assert bad <= 1
    assert mine <= ref + 0.005


@pytest.mark.parametrize("span,max_iter,dtype", [
    (1e-10, 3000, np.float32), (1e-18, 4000, np.float32),
    (1e-50, 4000, np.float64), (1e-10, 20000, np.float32)])
def test_counts_route_at_the_bar(span, max_iter, dtype):
    spec = P.DeepTileSpec(M_RE, M_IM, span, width=32, height=32)
    ours, _ = P.compute_counts_perturb(spec, max_iter, dtype=dtype,
                                       device="cpu")
    theirs, _ = RP.compute_counts_perturb(
        RP.DeepTileSpec(M_RE, M_IM, span, width=32, height=32), max_iter,
        dtype=dtype)
    _bar(ours, theirs, _exact_plane(spec, max_iter), 1)


def test_julia_route_at_the_bar():
    spec = P.DeepTileSpec(*JULIA_PT, 1e-16, width=32, height=32)
    ours, _ = P.compute_counts_perturb(spec, 1500, julia_c=JULIA_C,
                                       device="cpu")
    theirs, _ = RP.compute_counts_perturb(
        RP.DeepTileSpec(*JULIA_PT, 1e-16, width=32, height=32), 1500,
        julia_c=JULIA_C)
    _bar(ours, theirs, _exact_plane(spec, 1500, JULIA_C), 4)


def test_stagnation_stop_route_is_exact():
    """The minibrot sliver: the stop hands its stragglers to the exact
    repair, so every pixel equals its exact count (the JAX test's
    view)."""
    spec = P.DeepTileSpec(*MINIBROT3, 5e-2, width=16, height=16)
    counts, flagged = P.compute_counts_perturb(spec, 20000, device="cpu")
    assert flagged > 0 and (counts == 0).any()
    assert np.array_equal(counts, _exact_plane(spec, 20000))


def test_exterior_glitch_cluster_takes_the_exact_repair(monkeypatch):
    """The seahorse window at 1e-10: an all-exterior glitch cluster (no
    candidate covers the budget), every flagged pixel exact."""
    seen = {}
    orig = P._secondary_candidates

    def spy(bad, scanned, height, width):
        seen["bad"] = bad.copy()
        return orig(bad, scanned, height, width)

    monkeypatch.setattr(P, "_secondary_candidates", spy)
    P.reset_phase_seconds()
    spec = P.DeepTileSpec("-0.743643887037158704752191506114774",
                          "0.131825904205311970493132056385139", 1e-10,
                          width=24, height=24)
    counts, flagged = P.compute_counts_perturb(spec, 20000, device="cpu")
    assert flagged > 4 and len(seen["bad"]) == flagged
    exact = _exact_plane(spec, 20000)
    r, c = seen["bad"].T
    assert np.array_equal(counts[r, c], exact[r, c])
    phases = P.phase_seconds()
    assert phases["glitched"] == flagged
    assert phases["exact_repaired"] > 0
    with pytest.raises(ValueError, match="doubly-glitched"):
        P.compute_counts_perturb(spec, 20000, device="cpu", max_glitch_fix=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_smooth_route_against_the_jax_package(dtype):
    """Smooth values against the JAX package's f64 smooth route: the
    in-set masks equal, and the port's share of pixels off by more than
    1e-3 is at most the JAX package's own (at the same dtype) plus 0.5
    percentage points."""
    args = (*SEAHORSE, 1e-5)
    nu, _ = P.compute_smooth_perturb(P.DeepTileSpec(*args, width=32,
                                                    height=32), 1000,
                                     dtype=DTYPES[dtype], device="cpu")
    ref_spec = RP.DeepTileSpec(*args, width=32, height=32)
    theirs, _ = RP.compute_smooth_perturb(ref_spec, 1000,
                                          dtype=DTYPES[dtype])
    ref64, _ = RP.compute_smooth_perturb(ref_spec, 1000, dtype=np.float64)
    assert np.array_equal(nu == 0, ref64 == 0)
    mine = float((np.abs(nu - ref64) > 1e-3).mean())
    ref = float((np.abs(theirs - ref64) > 1e-3).mean())
    print(f"{dtype}: off by > 1e-3 on port {mine:.4%}, JAX {ref:.4%}")
    assert mine <= ref + 0.005


def test_tile_route_scales_like_the_counts():
    spec = P.DeepTileSpec(*SEAHORSE, 1e-6, width=32, height=32)
    pixels = P.compute_tile_perturb(spec, 300, device="cpu")
    counts, _ = P.compute_counts_perturb(spec, 300, device="cpu")
    assert pixels.dtype == np.uint8 and pixels.shape == (32 * 32,)
    want = (counts.astype(np.int64).ravel() * 256 + 299) // 300 & 255
    assert np.array_equal(pixels, want.astype(np.uint8))
    assert (P.compute_counts_perturb(spec, 1, device="cpu")[0] == 0).all()
    with pytest.raises(ValueError, match="delta floor"):
        P.compute_counts_perturb(P.DeepTileSpec("0", "0", 1e-31), 100,
                                 device="cpu")


def test_auto_bla_decisions_equal_the_jax_packages(caplog):
    """The auto-probe enables BLA on the bond view and declines on the
    config-4 view (its reference escapes early), as the JAX package
    decides, and the decision is cached."""
    from distributedmandelbrot_tpu_torch.ops.bla import (BOND_POINT_IM,
                                                         BOND_POINT_RE)
    mi = P.BLA_AUTO_MIN_BUDGET
    for center, span, want in (((BOND_POINT_RE, BOND_POINT_IM), 1e-15, True),
                               (CONFIG4, 1e-10, False)):
        spec = P.DeepTileSpec(*center, span, width=16, height=16)
        bits = _bits(spec)
        za, zb = P._to_fixed(center[0], bits), P._to_fixed(center[1], bits)
        z_re, z_im, _, o_re, o_im = P._find_reference(za, zb, za, zb, span,
                                                      mi, bits)
        dre, dim = spec.delta_grids(np.float64)
        dre, dim = dre - o_re, dim - o_im
        P._AUTO_BLA_CACHE.clear()
        RP._AUTO_BLA_CACHE.clear()
        with caplog.at_level(logging.INFO):
            got = P._auto_bla(z_re, z_im, torch.as_tensor(z_re),
                              torch.as_tensor(z_im), dre, dim, mi, True)
        ref = RP._auto_bla(z_re, z_im, jnp.asarray(z_re), jnp.asarray(z_im),
                           dre, dim, mi, True)
        assert got == ref == want
        assert len(P._AUTO_BLA_CACHE) == int(len(z_re) >= mi)
    assert any("BLA auto-enabled" in r.message for r in caplog.records)


def test_device_orbit_cache_reuses_and_guards():
    z_re, z_im, _ = P.reference_orbit("-0.5", "0.1", 100)
    a = P._device_orbit(z_re, z_im, "cpu")
    assert P._device_orbit(z_re, z_im, "cpu")[0] is a[0]
    assert a[0].dtype == torch.float64
    assert np.array_equal(a[0].numpy(), z_re)


def test_ops_exports_what_the_jax_package_exports():
    import distributedmandelbrot_tpu.ops as ref_ops
    import distributedmandelbrot_tpu_torch.ops as ops
    assert sorted(ops.__all__) == sorted(ref_ops.__all__)
    assert ops.DeepTileSpec is P.DeepTileSpec
    assert ops.compute_counts_perturb is P.compute_counts_perturb
