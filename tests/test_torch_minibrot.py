"""The deep route at the period-349 minibrot, the benchmark's
``deep-minibrot349`` configuration (config 4's budget at the nucleus
nearest config 4's view), on the CPU.

- The smooth route is right there whatever the BLA probe decides:
  within the configuration's ``off_by`` of the 192-bit reference
  (``benchmark/reference/deep.py``) on the deepest and on seed-drawn
  escaping pixels, and of the exact scan on every pixel.  With the
  integer route's BLA ``eps`` (2^-16) it was up to 6.96 off.
- The probe's survivors say yes there, and the smooth table's check
  (``bla.smooth_table_skips``) says no: the view keeps the exact scan.
- The counts ``deep.lane_steps`` and ``deep.bla_views``.
- The configuration and its traffic load through the benchmark's spec,
  and the walk keeps to its radius and spans.

K10's per-pixel loop runs here as its host build (g++, through
``ops/csrc/host/perturb_scan.cpp``), which
``test_torch_perturbation.py`` holds bit for bit to the plain version,
where a compiler is found: the plain version takes about 11 s a view
at 50,000 steps."""

import hashlib
import json
import logging
import math
import random
import shutil
import sys
from decimal import Decimal
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.drivers.views import CENTER_UNIT, view_path  # noqa: E402
from benchmark.harness.spec import Cell  # noqa: E402
from benchmark.reference import deep as ref_deep  # noqa: E402
from distributedmandelbrot_tpu_torch.obs import names  # noqa: E402
from distributedmandelbrot_tpu_torch.obs import phases  # noqa: E402
from distributedmandelbrot_tpu_torch.ops import bla as B  # noqa: E402
from distributedmandelbrot_tpu_torch.ops import (  # noqa: E402
    cuda_perturb as CP, perturbation as P)

CELL = "deep-minibrot349.minibrot-views-1024"
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "deep-minibrot349.json").read_text())
CENTER = tuple(CONFIG["center"])
MAX_ITER = CONFIG["max_iter"]
SIDE = 32


@pytest.fixture(scope="module")
def k10_on_host(tmp_path_factory):
    """K10's plain version replaced by its host build for the module
    (the plain version where no C++ compiler is found)."""
    from test_torch_perturbation import host_build
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which(
        "clang++")
    if cxx is None:
        yield
        return
    lib = host_build(cxx, tmp_path_factory.mktemp("dm_perturb"))
    plain = CP.perturb_smooth_state_plain
    CP.perturb_smooth_state_plain = (
        lambda *a, **k: CP.smooth_state_with(lib, *a, **k))
    try:
        yield
    finally:
        CP.perturb_smooth_state_plain = plain


def _tallied_render(spec, max_iter, **kwargs):
    """A smooth f64 view on the CPU from an empty orbit store -> its
    values and its counts: ``glitched``, ``exact_repaired`` and the
    orbits computed (``deep.orbit`` entries)."""
    P.ORBITS.clear()
    phases.reset_phase_seconds()
    nu, _ = P.compute_smooth_perturb(spec, max_iter, dtype=np.float64,
                                     device="cpu", **kwargs)
    counts = phases.phase_seconds()
    return nu, (counts.get(names.COUNT_DEEP_GLITCHED, 0),
                counts.get(names.COUNT_DEEP_EXACT_REPAIRED, 0),
                phases.phase_entries().get(names.PHASE_DEEP_ORBIT, 0))


@pytest.fixture(scope="module")
def view(k10_on_host):
    """The configuration's view at 32^2: its spec, the exact scan's
    smooth values (BLA off) and its counts."""
    spec = P.DeepTileSpec(*CENTER, CONFIG["span"], width=SIDE, height=SIDE)
    exact, counts = _tallied_render(spec, MAX_ITER, bla=False)
    return spec, exact, counts


def _reference_pixels(nu: np.ndarray) -> list[int]:
    """The 8 deepest escaping pixels and 16 escaping pixels drawn from a
    fixed seed, as the benchmark's check draws them."""
    flat = nu.reshape(-1)
    escaping = np.flatnonzero(flat > 0)
    deep = escaping[np.argsort(flat[escaping], kind="stable")[-8:]]
    drawn = random.Random(349).sample(sorted(set(escaping) - set(deep)), 16)
    return [int(p) for p in deep] + drawn


@pytest.mark.parametrize("bla", [None, True], ids=["probe", "forced"])
def test_smooth_route_is_within_off_by_on_the_minibrot_view(view, bla):
    spec, exact, _ = view
    nu, _ = P.compute_smooth_perturb(spec, MAX_ITER, dtype=np.float64,
                                     bla=bla, device="cpu")
    off_by = CONFIG["off_by"]
    assert np.array_equal(nu == 0, exact == 0)
    assert 0.5 < float((nu == 0).mean()) < 0.9
    assert float(np.abs(nu - exact).max()) <= off_by
    # The f64 table offers no skip here: forced BLA runs exact bursts.
    assert np.array_equal(nu, exact)
    for p in _reference_pixels(exact):
        row, col = divmod(p, SIDE)
        want, _ = ref_deep.smooth_pixel(
            *ref_deep.pixel_c(CENTER, CONFIG["span"], SIDE, row, col),
            MAX_ITER)
        assert abs(float(nu[row, col]) - want) <= off_by, (row, col)


def test_the_probe_keeps_the_exact_scan_on_the_minibrot_view(k10_on_host,
                                                            caplog):
    """The survivors say yes (as the integer route's probe decides), the
    smooth table offers no skip anywhere at the view's deltas in
    float64, so the smooth route keeps the exact scan."""
    spec = P.DeepTileSpec(*CENTER, CONFIG["span"], width=SIDE, height=SIDE)
    bits = max(P.DEFAULT_PREC_BITS,
               -(-(int(-np.log2(spec.step)) + 64) // 128) * 128)
    za, zb = P._to_fixed(CENTER[0], bits), P._to_fixed(CENTER[1], bits)
    P.ORBITS.clear()
    orbit, o_re, o_im = P._find_reference(za, zb, za, zb, spec.span,
                                          MAX_ITER, bits)
    assert orbit.valid == MAX_ITER and (o_re, o_im) == (0.0, 0.0)
    dre, dim = spec.delta_grids(np.float64)
    dc_max = float(np.sqrt(np.max(dre * dre) + np.max(dim * dim)))
    assert P._auto_bla(orbit, dre, dim, MAX_ITER, True, dtype=np.float64)
    assert not B.smooth_table_skips(orbit, dc_max, bailout=256.0,
                                    dtype=np.float64)
    r2 = B._smooth_table(orbit, dc_max, bailout=256.0, dtype=np.float64)[4]
    assert not (r2 > dc_max * dc_max).any()
    assert B.smooth_bla_eps(np.float64) == 2.0 ** -53
    assert B.smooth_bla_eps(np.float32) == 2.0 ** -24
    assert B.DEFAULT_BLA_EPS == 2.0 ** -16
    phases.reset_phase_seconds()
    with caplog.at_level(logging.INFO, logger=P.logger.name):
        P.compute_smooth_perturb(P.DeepTileSpec(*CENTER, CONFIG["span"],
                                                width=4, height=4),
                                 MAX_ITER, dtype=np.float64, device="cpu")
    assert "table offers no skip" in caplog.text
    assert phases.phase_seconds()[names.COUNT_DEEP_BLA_VIEWS] == 0


# The smooth f64 values' SHA-256 (its first 16 hex digits) and the counts
# (glitched, exact_repaired, orbits computed) of two views from an empty
# orbit store, as the route gave them before the orbit store replaced its
# caches: config 4's view at 32^2 and budget 3000, and the configuration's
# view (BLA off).
PINNED = {"config4": ("72642b3e04863c22", (0, 0, 8)),
          "minibrot": ("e6f5a2d4461fb0ad", (0, 0, 1))}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_two_views_give_their_pinned_values_and_counts(request, name):
    if name == "minibrot":
        _, nu, counts = request.getfixturevalue("view")
    else:
        spec = P.DeepTileSpec("-0.77568376995", "0.13646737005", 1e-10,
                              width=32, height=32)
        nu, counts = _tallied_render(spec, 3000)
    digest = hashlib.sha256(nu.tobytes()).hexdigest()[:16]
    assert (digest, counts) == PINNED[name]


def test_lane_steps_count_what_the_scans_needed(monkeypatch):
    """``deep.lane_steps`` is the sum over the route's K10 scans of each
    lane's steps to its bailout crossing, or the whole orbit; the view
    takes no BLA (``deep.bla_views`` 0)."""
    seen = []
    real = CP.perturb_smooth_state

    def spy(z_re, *args, **kwargs):
        state = real(z_re, *args, **kwargs)
        n, act_b = state[0], state[4]
        seen.append(int(torch.where(act_b, z_re.shape[0], n + 1).sum()))
        return state

    monkeypatch.setattr(CP, "perturb_smooth_state", spy)
    spec = P.DeepTileSpec("-0.77568376995", "0.13646737005", 1e-10,
                          width=16, height=12)
    phases.reset_phase_seconds()
    P.compute_smooth_perturb(spec, 3000, dtype=np.float64, device="cpu")
    counts = phases.phase_seconds()
    assert seen and counts[names.COUNT_DEEP_LANE_STEPS] == sum(seen)
    assert counts[names.COUNT_DEEP_BLA_VIEWS] == 0
    P.compute_smooth_perturb(spec, 3000, dtype=np.float64, device="cpu")
    assert phases.phase_seconds()[names.COUNT_DEEP_LANE_STEPS] == sum(seen)


def test_bla_views_count_a_view_that_took_bla():
    spec = P.DeepTileSpec(B.BOND_POINT_RE, B.BOND_POINT_IM, 1e-15, width=8,
                          height=8)
    phases.reset_phase_seconds()
    P.compute_smooth_perturb(spec, 4000, device="cpu", bla=True)
    P.compute_counts_perturb(spec, 4000, device="cpu", bla=False)
    counts = phases.phase_seconds()
    assert counts[names.COUNT_DEEP_BLA_VIEWS] == 1
    assert names.COUNT_DEEP_LANE_STEPS not in counts


def test_the_configuration_and_its_walk_load_through_the_spec():
    cell = Cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config == CONFIG
    assert cell.traffic["kind"] == "views"
    assert cell.driver().__name__ == "benchmark_driver_views"
    assert {m["name"] for m in cell.metrics(True)} >= {
        "k10_roofline", "deep_bla_share", "k10_ms", "device_idle.deep"}
    assert "colormap_png_ms" not in {m["name"] for m in cell.metrics(True)}
    path = cell.traffic["path"]
    walk = view_path(CONFIG, path)
    assert len(walk) == path["views"] == 320
    base = [Decimal(v) for v in CENTER]
    slack = float(CENTER_UNIT)
    for (re_, im_), span in walk:
        off = [float(Decimal(v) - b) for v, b in zip((re_, im_), base)]
        assert math.hypot(*off) <= path["radius"] + slack
        assert path["span_min"] <= span <= path["span_max"]
    assert len({v for v in walk}) > 300
