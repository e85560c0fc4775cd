"""The port's BLA scans (``ops/bla.py``) against the JAX package's on the
CPU: the host table equal exactly, the skip selection equal on the same
values, and the scans at the route level held to the JAX package's own
contract (agreement with the exact scan, in-set classification, the
bond view in-set throughout) and to the JAX package's results, with the
pixels XLA:CPU's FMA contraction moves counted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.ops import bla as RB
from distributedmandelbrot_tpu.ops import perturbation as RP
from distributedmandelbrot_tpu_torch.ops import bla as B
from distributedmandelbrot_tpu_torch.ops import perturbation as P

CONFIG4 = ("-0.77568376995", "0.13646737005")
BOND = (B.BOND_POINT_RE, B.BOND_POINT_IM)
FILAMENT = ("0", "1")
JULIA_C = ("-0.8", "0.156")
JULIA_PT = ("1.5275031186435346", "-0.07591217835228786")


@pytest.fixture(autouse=True)
def _reference_in_python(monkeypatch):
    monkeypatch.setattr(RP, "_native_fixed", lambda *a, **k: False)


def _orbit(center, max_iter):
    return P.reference_orbit(*center, max_iter, prec_bits=192)


def _stored(center, max_iter):
    """The orbit of :func:`_orbit` as the store holds it."""
    za, zb = (P._to_fixed(v, 192) for v in center)
    return P.ORBITS.get(za, zb, za, zb, max_iter, 192)


def test_constants_equal_the_jax_packages():
    for name in ("DEFAULT_BLA_EPS", "BLA_LEVELS_MAX", "BOND_POINT_RE",
                 "BOND_POINT_IM", "BLA_MIN_SKIP", "BLA_EXACT_BURST",
                 "SMOOTH_Z_CAP"):
        assert getattr(B, name) == getattr(RB, name), name


@pytest.mark.parametrize("z_cap", [4.0, 1.0])
@pytest.mark.parametrize("dc_max", [1e-13, 3e-9])
@pytest.mark.parametrize("center,max_iter", [
    (BOND, 4000), (CONFIG4, 3000), (FILAMENT, 3000), (("0.2504", "0"), 400)],
    ids=["bond", "config4", "filament", "cusp"])
def test_build_bla_table_equals_the_jax_packages(center, max_iter, dc_max,
                                                  z_cap):
    """All five arrays, bit for bit (the same float64 numpy code)."""
    z_re, z_im, _ = _orbit(center, max_iter)
    got = B.build_bla_table(z_re, z_im, dc_max, z_cap=z_cap)
    want = RB.build_bla_table(z_re, z_im, dc_max, z_cap=z_cap)
    for name, g, w in zip(("A_re", "A_im", "B_re", "B_im", "R2"), got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_select_skip_equals_the_jax_packages(dtype):
    orbit = _stored(BOND, 4000)
    z_re = orbit.z_re
    tabs = B._table(orbit, 1e-13, B.DEFAULT_BLA_EPS, dtype)
    R2 = tabs[4]
    levels = R2.shape[0]
    rng = np.random.default_rng(2)
    r2_dev = jnp.asarray(R2)
    for n in (0, 64, 128, 192, 1024, 2048, 3968, 4000, 4011):
        for m in (0.0, *(float(R2[i, n >> (6 + i)]) if n >> (6 + i) <
                         R2.shape[1] else 0.0 for i in range(levels)),
                  *rng.uniform(0, 1e-20, 3)):
            m = float(dtype(m))
            got = B._select_skip(n, m, R2, levels, len(z_re))
            want = int(RB._select_skip(jnp.int32(n), jnp.asarray(m, dtype),
                                       r2_dev, levels, len(z_re)))
            assert got == want, (n, m)


def test_table_cache_reuses():
    """The table is kept with its orbit, one for each quantized
    ``dc_max``."""
    orbit = _stored(CONFIG4, 3000)
    a = B._table(orbit, 1e-11, B.DEFAULT_BLA_EPS, np.float32)
    assert B._table(orbit, 1.2e-11, B.DEFAULT_BLA_EPS, np.float32) is a
    assert B._table(orbit, 3e-11, B.DEFAULT_BLA_EPS, np.float32) is not a
    assert all(t.dtype == np.float32 for t in a)
    z_re, z_im, _ = _orbit(CONFIG4, 3000)
    assert z_re is orbit.z_re and z_im is orbit.z_im


def _counts(center, span, side, mi, *, bla, julia_c=None, ref=False):
    if ref:
        return RP.compute_counts_perturb(
            RP.DeepTileSpec(*center, span, width=side, height=side), mi,
            bla=bla, julia_c=julia_c)[0]
    return P.compute_counts_perturb(
        P.DeepTileSpec(*center, span, width=side, height=side), mi, bla=bla,
        julia_c=julia_c, device="cpu")[0]


def test_bla_on_the_filament_view_holds_the_contract():
    """The JAX package's contract for its BLA route, on the port: >= 99%
    agreement with the exact scan and in-set classification, and the
    port's BLA counts against the JAX package's BLA counts (differing
    pixels printed, at most the JAX BLA's own disagreement with the exact
    scan plus 0.5 percentage points)."""
    exact = _counts(FILAMENT, 1e-12, 48, 3000, bla=False)
    fast = _counts(FILAMENT, 1e-12, 48, 3000, bla=True)
    ref_fast = _counts(FILAMENT, 1e-12, 48, 3000, bla=True, ref=True)
    assert float((exact == fast).mean()) >= 0.99
    assert float(((exact == 0) == (fast == 0)).mean()) >= 0.99
    mine = float((fast != exact).mean())
    theirs = float((ref_fast != exact).mean())
    print(f"BLA vs exact: port {mine:.4%}, JAX {theirs:.4%}; port vs JAX "
          f"{int((fast != ref_fast).sum())} pixels")
    assert mine <= theirs + 0.005


def test_bla_keeps_the_bond_view_in_set():
    exact = _counts(BOND, 1e-15, 32, 4000, bla=False)
    fast = _counts(BOND, 1e-15, 32, 4000, bla=True)
    assert np.array_equal(exact, fast) and (exact == 0).all()
    assert np.array_equal(fast, _counts(BOND, 1e-15, 32, 4000, bla=True,
                                        ref=True))


def test_bla_julia_mode_holds_the_contract():
    exact = _counts(JULIA_PT, 1e-16, 32, 1500, bla=False, julia_c=JULIA_C)
    fast = _counts(JULIA_PT, 1e-16, 32, 1500, bla=True, julia_c=JULIA_C)
    assert float(((exact == 0) == (fast == 0)).mean()) >= 0.99
    assert float((exact == fast).mean()) >= 0.99


def test_bla_never_skips_through_an_escape():
    """The exterior center just past the cusp, budget just above its
    escape: BLA equals the exact scan and every pixel escapes."""
    z_re, _, n = _orbit(("0.2504", "0"), 400)
    e = n
    exact = _counts(("0.2504", "0"), 1e-13, 16, e + 3, bla=False)
    fast = _counts(("0.2504", "0"), 1e-13, 16, e + 3, bla=True)
    assert np.array_equal(exact, fast) and (exact != 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_smooth_bla_equals_the_exact_scan_on_the_config4_view(dtype):
    """SMOOTH_Z_CAP: on the config-4 boundary view the smooth BLA route
    equals the exact smooth scan bit for bit (the JAX package's test)."""
    spec = P.DeepTileSpec(*CONFIG4, 1e-10, width=48, height=48)
    e, _ = P.compute_smooth_perturb(spec, 30000, bla=False, dtype=dtype,
                                    device="cpu")
    f, _ = P.compute_smooth_perturb(spec, 30000, bla=True, dtype=dtype,
                                    device="cpu")
    assert np.array_equal(e, f)


def test_smooth_bla_on_the_filament_view_holds_the_contract():
    spec = P.DeepTileSpec(*FILAMENT, 1e-12, width=32, height=32)
    e, _ = P.compute_smooth_perturb(spec, 3000, device="cpu", bla=False)
    f, _ = P.compute_smooth_perturb(spec, 3000, device="cpu", bla=True)
    assert float(((e == 0) == (f == 0)).mean()) >= 0.99
    both = (e != 0) & (f != 0)
    assert np.percentile(np.abs(e[both] - f[both]), 95) <= 1.0
    bond = P.DeepTileSpec(*BOND, 1e-15, width=16, height=16)
    assert (P.compute_smooth_perturb(bond, 4000, device="cpu",
                                     bla=True)[0] == 0).all()


def test_bla_burst_skips_and_chunk_state():
    """A direct scan call: the skip count is positive on the bond view,
    zero when no table level validates (a huge delta), and the counts
    follow the integer scan's conventions."""
    orbit = _stored(BOND, 4000)
    z_re = orbit.z_re
    tabs = B._table(orbit, 1e-15, B.DEFAULT_BLA_EPS, np.float32)
    zr, zi = orbit.on("cpu")
    small = torch.full((4, 4), 1e-16, dtype=torch.float32)
    counts, glitched, act, skipped = B._bla_scan(
        zr, zi, tabs, small, small, orbit_len=len(z_re), max_iter=4000,
        levels=tabs[0].shape[0])
    assert skipped > 0 and (counts == 0).all() and act.all()
    big = torch.full((4, 4), 0.5, dtype=torch.float32)
    counts, _, act, skipped = B._bla_scan(
        zr, zi, tabs, big, big, orbit_len=len(z_re), max_iter=4000,
        levels=tabs[0].shape[0])
    assert skipped == 0 and (counts > 0).all() and not act.any()
