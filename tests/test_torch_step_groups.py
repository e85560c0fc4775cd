"""The per-lane loops of the persistent kernels on the CPU, bitwise
against the plain versions: ``dm::step_group`` (K1, K2, K3, K5: eight
steps a group, the cycle probe and the budget once per group),
``dm::smooth_group`` (K4) and ``dm::resume_group`` (K7: groups from any
step, single steps to a round end off a group boundary), all in
``ops/csrc/escape.cuh``.

The header is compiled by the host C++ compiler through
``ops/csrc/host/step_groups.cpp`` (``__device__`` dropped, the ``_rn``
intrinsics as plain f32 operations, ``-ffp-contract=off``); nvcc builds
the same header unchanged for the card.  Each pixel runs alone; n, the
steps it ran and its byte must equal the plain version's, in every mode
and the matrix form (K8), at budgets around the group length and deep
ones with the probe armed; K4's state and smooth value likewise.
Skips where no C++ compiler is found."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time

CSRC = Path(ce.__file__).resolve().parent / "csrc"
SIDE = 64
BUDGETS = [2, 3, 8, 9, 17, 300, 1500]
JULIA_C = complex(-0.8, 0.156)
# (view center, span) per mode: boundary windows where orbits escape at
# every step count, fall into cycles, and spend the budget.
MODES = {
    "mandelbrot": ({}, [(-0.745, 0.11, 0.05), (-0.2, 0.7, 0.4),
                        (-1.25, 0.0, 0.5)]),
    "julia": ({"julia_c": JULIA_C}, [(0.0, 0.0, 3.0), (0.3, 0.05, 0.2)]),
    "multibrot3": ({"power": 3}, [(0.0, 0.0, 3.0), (-0.6, 0.3, 0.3)]),
    "multibrot5": ({"power": 5}, [(0.0, 0.0, 2.8)]),
    "ship": ({"burning": True}, [(-0.5, -0.5, 3.0), (-1.75, -0.03, 0.1)]),
    "mxu": ({"use_mxu": True}, [(-0.745, 0.11, 0.05), (-1.25, 0.0, 0.5)]),
    "mxu_julia": ({"use_mxu": True, "julia_c": JULIA_C},
                  [(0.0, 0.0, 3.0)]),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build escape.cuh's loop with")
    out = tmp_path_factory.mktemp("dm_host") / "libdm_host.so"
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", "-I", str(CSRC / "host"), "-I",
                    str(CSRC), str(CSRC / "host" / "step_groups.cpp"), "-o",
                    str(out)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dm_host_tile.argtypes = [vp, i, i, i, i, f, i, i, i, i, i, i, vp,
                                 vp, vp]
    lib.dm_host_tile.restype = i
    lib.dm_host_census.argtypes = [vp, i, i, f, i, i, i, i, i]
    lib.dm_host_census.restype = ctypes.c_long
    lib.dm_host_smooth.argtypes = [vp, i, i, i, f, i, f, i, i, i, i, i,
                                   vp, vp, vp, vp]
    lib.dm_host_smooth.restype = None
    lib.dm_host_resume.argtypes = [vp] * 7 + [ctypes.c_long, i,
                                              ctypes.c_longlong, i, i]
    lib.dm_host_resume.restype = None
    return lib


def _spec(cx, cy, span):
    return TileSpec(cx - span / 2, cy - span / 2, span, span, width=SIDE,
                    height=SIDE)


def _host_tile(lib, row, mrd, kw, cycle):
    julia = len(row) == 6
    family, interior_mode, disk_lim = ce._mode_args(
        kw.get("power", 2), kw.get("burning", False), julia, True)
    row6 = ce._row6(row)
    n = np.zeros((SIDE, SIDE), np.int32)
    steps = np.zeros((SIDE, SIDE), np.int32)
    out = np.zeros((SIDE, SIDE), np.uint8)
    rc = lib.dm_host_tile(row6.ctypes.data, int(julia), mrd, 0,
                          interior_mode, disk_lim, int(cycle), family,
                          kw.get("power", 2), int(kw.get("use_mxu", False)),
                          SIDE, SIDE, n.ctypes.data, steps.ctypes.data,
                          out.ctypes.data)
    assert rc == 0
    return n, steps, out


def _plain_n(row, mrd, kw, cycle):
    """escape_tile_plain's n (updates survived), from the same loop."""
    zr0, zi0, cr, ci, julia = ce._kernel_orbit_inputs(row, SIDE, SIDE,
                                                      "cpu")
    power, burning = kw.get("power", 2), kw.get("burning", False)
    interior = (None if julia else
                escape_time.family_interior(cr, ci, power, burning))
    return escape_time.escape_loop(
        zr0, zi0, cr, ci, total_steps=mrd - 1, interior=interior,
        cycle_check=cycle, power=power, burning=burning,
        use_mxu=kw.get("use_mxu", False)).numpy()


@pytest.mark.parametrize("mrd", BUDGETS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_groups_equal_the_plain_loop(host_lib, mode, mrd):
    kw, views = MODES[mode]
    fam = {k: v for k, v in kw.items() if k != "julia_c"}
    for view in views:
        row = np.asarray(ce._params_row(_spec(*view), kw.get("julia_c")),
                         np.float32)
        n, steps, out = _host_tile(host_lib, row, mrd, kw, cycle=True)
        want, want_steps = ce.escape_tile_plain(
            row, mrd, SIDE, SIDE, cycle_check=True, device="cpu",
            return_steps=True, **fam)
        assert np.array_equal(n, _plain_n(row, mrd, kw, True)), view
        assert np.array_equal(steps, want_steps.numpy()), view
        assert np.array_equal(out, want.numpy()), view


@pytest.mark.parametrize("mrd", [9, 300])
def test_step_groups_without_the_probe(host_lib, mrd):
    row = np.asarray(ce._params_row(_spec(-0.745, 0.11, 0.05)), np.float32)
    n, _, out = _host_tile(host_lib, row, mrd, {}, cycle=False)
    assert np.array_equal(n, _plain_n(row, mrd, {}, False))
    want = ce.escape_tile_plain(row, mrd, SIDE, SIDE, cycle_check=False,
                                device="cpu")
    assert np.array_equal(out, want.numpy())


def test_the_loop_exercises_every_exit(host_lib):
    """The windows above reach all three exits: escape inside a group,
    the probe, and the budget."""
    row = np.asarray(ce._params_row(_spec(-0.2, 0.7, 0.4)), np.float32)
    n, steps, _ = _host_tile(host_lib, row, 1500, {}, cycle=True)
    escaped = n < 1499
    assert (steps[escaped] % 8 != 0).any()
    assert ((n == 1499) & (steps < 1499) & (steps > 0)).any()  # the probe
    assert ((n == 1499) & (steps == 1499)).any()  # the budget


@pytest.mark.parametrize("mode", ["mandelbrot", "julia", "multibrot3",
                                  "ship"])
def test_the_scout_census_equals_the_plain_census(host_lib, mode):
    """K2's bf16 scout (dm::scout_escapes) per tile against
    scout_census_plain, through the host stand-in of cuda_bf16.h."""
    kw, views = MODES[mode]
    power, burning = kw.get("power", 2), kw.get("burning", False)
    for view in views:
        row = np.asarray(ce._params_row(_spec(*view), kw.get("julia_c")),
                         np.float32)
        julia = len(row) == 6
        family, interior_mode, disk_lim = ce._mode_args(power, burning,
                                                        julia, True)
        got = host_lib.dm_host_census(ce._row6(row).ctypes.data,
                                      int(julia), interior_mode, disk_lim,
                                      family, power, 64, SIDE, SIDE)
        gr, gi, cr, ci, _ = ce._kernel_orbit_inputs(row, SIDE, SIDE, "cpu")
        inside = (None if julia
                  else escape_time.family_interior(cr, ci, power, burning))
        live0 = (torch.ones((SIDE, SIDE), dtype=torch.bool)
                 if inside is None else ~inside)
        want = ce.scout_census_plain(gr, gi, live0, 64, c_real=cr,
                                     c_imag=ci, power=power,
                                     burning=burning)
        assert got == want, view


# --- K4: dm::smooth_group ---------------------------------------------------

BAILOUT = 256.0
SMOOTH_BUDGETS = [*range(2, 10), 17, 300, 1500]
SMOOTH_MODES = ("mandelbrot", "julia", "multibrot3", "ship")
# c = -2 exactly at pixel (0, 0): an orbit on the radius-2 circle that
# never reaches the bailout, so it stops at the step limit.
TIP = (-1.75, 0.25, 0.5)


def _smooth_views(mode):
    views = MODES[mode][1][:2]
    return views + [TIP] if mode == "mandelbrot" else views


def _host_smooth(lib, row, mrd, kw, cycle):
    julia = len(row) == 6
    power = kw.get("power", 2)
    family, interior_mode, disk_lim = ce._mode_args(
        power, kw.get("burning", False), julia, True)
    n = np.zeros((SIDE, SIDE), np.int32)
    n2 = np.zeros((SIDE, SIDE), np.int32)
    mag2 = np.zeros((SIDE, SIDE), np.float32)
    exits = np.zeros((SIDE, SIDE), np.int32)
    lib.dm_host_smooth(ce._row6(row).ctypes.data, int(julia), mrd,
                       ce.smooth_step_limit(mrd, BAILOUT),
                       float(np.float32(BAILOUT * BAILOUT)), interior_mode,
                       disk_lim, int(cycle), family, power,
                       SIDE, SIDE, n.ctypes.data, n2.ctypes.data,
                       mag2.ctypes.data, exits.ctypes.data)
    return n, n2, mag2, exits


def _nu(n, n2, mag2, dyn, power):
    """escape_time.smooth_nu's operations with |z|^2 given: what K4's
    epilogue computes from the state its lane leaves."""
    f32 = torch.float32
    big = torch.finfo(f32).max
    mag2 = torch.nan_to_num(torch.from_numpy(mag2), nan=big, posinf=big)
    mag2 = torch.minimum(torch.maximum(mag2, torch.tensor(BAILOUT * BAILOUT,
                                                          dtype=f32)),
                         torch.tensor(big, dtype=f32))
    corr = torch.log2(torch.log(mag2)
                      / torch.tensor(2.0 * np.log(BAILOUT), dtype=f32))
    if power != 2:
        corr = corr / torch.tensor(np.log2(power), dtype=f32)
    nu = torch.from_numpy(n + 2).to(f32) - corr
    return torch.where(torch.from_numpy(n2 >= dyn), torch.zeros((), dtype=f32),
                       nu)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("cycle", [False, True])
@pytest.mark.parametrize("mrd", SMOOTH_BUDGETS)
@pytest.mark.parametrize("mode", SMOOTH_MODES)
def test_smooth_groups_equal_the_plain_loop(host_lib, mode, mrd, cycle):
    """K4's group: the in-set decision, n and |z|^2 of the plain
    loop's state, and the smooth value of escape_smooth_plain, bit for
    bit."""
    kw = MODES[mode][0]
    power, burning = kw.get("power", 2), kw.get("burning", False)
    dyn = mrd - 1
    for view in _smooth_views(mode):
        row = np.asarray(ce._params_row(_spec(*view), kw.get("julia_c")),
                         np.float32)
        zr0, zi0, cr, ci, julia = ce._kernel_orbit_inputs(row, SIDE, SIDE,
                                                          "cpu")
        interior = (None if julia else
                    escape_time.family_interior(cr, ci, power, burning))
        pn, pn2, pzr, pzi = (t.numpy() for t in escape_time.escape_smooth_loop(
            zr0, zi0, cr, ci, total_steps=dyn,
            step_limit=ce.smooth_step_limit(mrd, BAILOUT), bailout=BAILOUT,
            interior=interior, cycle_check=cycle, power=power,
            burning=burning))
        want = ce.escape_smooth_plain(row, mrd, SIDE, SIDE, bailout=BAILOUT,
                                      cycle_check=cycle, power=power,
                                      burning=burning, device="cpu")
        out = pn2 < dyn
        n, n2, mag2, _ = _host_smooth(host_lib, row, mrd, kw, cycle)
        assert np.array_equal(n2 < dyn, out), view
        assert np.array_equal(n[out], pn[out]), view
        assert np.array_equal(_bits(mag2[out]),
                              _bits((pzr * pzr + pzi * pzi)[out])), view
        assert np.array_equal(_bits(_nu(n, n2, mag2, dyn, power)),
                              _bits(want)), view


def test_the_smooth_step_limit_is_whole_groups():
    """K4's groups never straddle the step limit: it is a multiple of 64
    at every budget (the kernel's entry refuses any other)."""
    for mrd in [*range(2, 300), 1023, 1024, 1025, 4096, 50_000]:
        assert ce.smooth_step_limit(mrd, BAILOUT) % 64 == 0, mrd


def test_the_smooth_group_exercises_every_exit(host_lib):
    """The windows above reach every exit of K4's group: the bailout, the
    step limit, the probe, in the set by n2."""
    seen = set()
    for view, mrd, cycle in ((TIP, 300, False), ((-0.2, 0.7, 0.4), 1500,
                                                 True)):
        row = np.asarray(ce._params_row(_spec(*view)), np.float32)
        seen |= set(np.unique(_host_smooth(host_lib, row, mrd, {},
                                           cycle)[3]).tolist())
    assert {1, 2, 3, 4} <= seen, seen



# --- K7: dm::resume_group ----------------------------------------------------

# Three tiles at these budgets; rounds from it0 (after a phase of it0 - 1
# steps: 61 and 64 put the lanes' groups off and on multiples of 8) of
# these lengths, None running to the deepest budget.
RESUME_BUDGETS = (513, 700, 1023)
RESUME_IT0 = (62, 65, 257)
RESUME_SEGS = (1, 7, 8, 64, 256, None)


@functools.lru_cache(maxsize=None)
def _resume_state(mode, it0):
    """K6's plain planes, flat, of three boundary windows of ``mode`` at
    RESUME_BUDGETS after a phase of it0 - 1 steps, and the lanes'
    dyn."""
    kw, views = MODES[mode]
    rows = np.asarray([ce._params_row(_spec(*views[t % len(views)]),
                                      kw.get("julia_c"))
                       for t in range(len(RESUME_BUDGETS))], np.float32)
    planes = cx.escape_state_plain(
        rows, list(RESUME_BUDGETS), height=SIDE, width=SIDE,
        phase_budget=it0 - 1, power=kw.get("power", 2),
        burning=kw.get("burning", False))
    dyn = torch.from_numpy(np.repeat(np.asarray(RESUME_BUDGETS, np.int32) - 1,
                                     SIDE * SIDE))
    return tuple(t.reshape(-1).contiguous() for t in planes), dyn


@pytest.mark.parametrize("seg", RESUME_SEGS)
@pytest.mark.parametrize("it0", RESUME_IT0)
@pytest.mark.parametrize("mode", SMOOTH_MODES)
def test_resume_groups_equal_the_plain_round(host_lib, mode, it0, seg):
    """K7's per-lane loop over one round: z (as bits), n and act of
    escape_resume_plain, at round ends on and off group boundaries and
    at the budget."""
    kw = MODES[mode][0]
    power, burning = kw.get("power", 2), kw.get("burning", False)
    (cr, ci, zr, zi, n, act), dyn = _resume_state(mode, it0)
    seg = seg or max(RESUME_BUDGETS) - it0
    want = cx.escape_resume_plain(it0, seg, dyn, cr, ci, zr, zi, n, act,
                                  power=power, burning=burning)
    got = [t.numpy().copy() for t in (zr, zi, n, act)]
    family = ce._mode_args(power, burning, False, False)[0]
    host_lib.dm_host_resume(*(a.ctypes.data for a in got),
                            *(t.numpy().ctypes.data for t in (cr, ci, dyn)),
                            dyn.numel(), it0, seg, family, power)
    assert np.array_equal(_bits(got[0]), _bits(want[0].numpy()))
    assert np.array_equal(_bits(got[1]), _bits(want[1].numpy()))
    assert np.array_equal(got[2], want[2].numpy())
    assert np.array_equal(got[3], want[3].numpy())
    # The round moved lanes: some left the disk, and a round to the end
    # leaves no lane active.
    live = act.numpy() != 0
    assert live.any()
    assert (got[2][live] > n.numpy()[live]).any()
    if seg >= max(RESUME_BUDGETS) - it0:
        assert not got[3].any()
