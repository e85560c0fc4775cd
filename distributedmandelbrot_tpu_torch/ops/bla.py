"""BLA (bilinear approximation) acceleration for perturbation deep zoom:
the port of the JAX package's ``ops/bla.py``.

Over an orbit segment where the quadratic term of the delta recurrence is
negligible, ``L`` perturbation steps collapse to ONE bilinear map

    dz_{n+L} = A dz_n + B dc

with ``(A, B)`` composed from the reference orbit and a conservative
validity radius ``r`` bounding ``|dz_n|``.  Tables for skip lengths 64,
128, ... are built on the host in float64 by pairwise merging
(:func:`build_bla_table`, copied from the JAX package).

Tile-granular skipping, as in the JAX package: ONE skip decision is made
per row chunk per iteration from the chunk's largest live ``|dz|``, so
the output depends on the chunking, which ``perturbation._compute_perturb``
keeps equal to the JAX package's.  Each iteration either applies one
skip or runs a burst of :data:`BLA_EXACT_BURST` exact steps.

The scans here are PyTorch on the caller's device.  The decision is made
on the host: each iteration reads the chunk's largest live ``|dz|^2``
and whether any lane is live (one device-to-host read an iteration), and
compares it, in the delta dtype, with the table's radii, which stay on
the host cast to that dtype, as do the skip's coefficients (scalars
per iteration: the chunk advances in lockstep).  Where the JAX package
gathered them on its device inside one jitted loop, the values compared
and multiplied are the same.

Accuracy contract (why this is opt-in, or auto-probed): escapes and
glitches inside a skipped segment are detected at its end; skipped steps
drop the quadratic term (relative ``eps`` per skip).  The integer scan
keeps the JAX package's ``eps`` (:data:`DEFAULT_BLA_EPS`) and with it an
approximate count.  The smooth scan's table takes the delta dtype's unit
roundoff (:func:`smooth_bla_eps`), so every skip drops a term below the
rounding of the steps it replaces; the ``SMOOTH_Z_CAP`` guard keeps
skips away from the smoothing radius.  Where it skips, its values differ
from the exact scan's by rounding, which the later steps amplify as they
amplify the exact scan's own: not bit for bit.  In float64 such a table
offers no skip at all on many deep views (the period-349 minibrot at
1.5e-17, the bond view at 1e-15): there ``perturbation``'s probe keeps
the exact scan (:func:`smooth_table_skips`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs import phases
from distributedmandelbrot_tpu_torch.ops.cuda_perturb import (_delta_step,
                                                              _shape_of,
                                                              _step_terms)
from distributedmandelbrot_tpu_torch.ops.perturbation import (GLITCH_TOL,
                                                              _smooth_nu)

logger = logging.getLogger("dmtpu.bla")

# Relative size of the dropped quadratic term at the base level:
# |dz| < eps * |Z| keeps |dz^2| below eps of the linear |2 Z dz|.
DEFAULT_BLA_EPS = 2.0 ** -16


def smooth_bla_eps(dtype) -> float:
    """The smooth table's ``eps``: the unit roundoff of the delta dtype
    (2^-24 in float32, 2^-53 in float64), so a skip drops a quadratic
    term below the rounding of the linear one.  ``DEFAULT_BLA_EPS`` put
    smooth values of the period-349 minibrot view (config 4's nucleus at
    span 1.5e-17, float64) up to 6.96 off the exact scan, and on 16.7%
    of its pixels more than 1e-6 (2^-40: 3.1e-6; 2^-53: none)."""
    return float(np.finfo(dtype).eps) / 2.0

# Deepest skip = 2^LMAX steps; the loop pays (LMAX - min level) scalar
# level checks per iteration.
BLA_LEVELS_MAX = 14

# The period-6 bond point of the main cardioid, c = 3/8 + i sqrt(3)/8
# (boundary angle pi/3) — exactly representable as decimal strings
# (imag = isqrt(3 * 10^80) * 125, digit-shifted), and the canonical
# slow-dynamics benchmark view for this module: parabolic (multiplier
# 1) dynamics keep every pixel of a deep window iterating to the full
# budget, the case BLA accelerates ~10x.  Shared by bench.py's
# deep-slow config and the test suite so they can never drift.
BOND_POINT_RE = "0.375"
BOND_POINT_IM = "0.2165063509461096616909307926882340458678500"

# Shortest STORED (and selectable) skip: skips below this aren't worth
# an iteration's overhead (level checks + gathers + the live-max
# reduction) versus just bursting exact steps, so levels under it are
# merge intermediates only — never stored, uploaded, or selected.
# Storage therefore costs ~5 * 2 * N / BLA_MIN_SKIP entries (row width
# N / min_skip, halving per level), not the dense levels * N / 2.
BLA_MIN_SKIP = 64


def build_bla_table(z_re: np.ndarray, z_im: np.ndarray, dc_max: float,
                    *, eps: float = DEFAULT_BLA_EPS,
                    levels: int | None = None,
                    z_cap: float = 4.0):
    """Pairwise-merged BLA tables over a reference orbit (host, f64).

    Returns ``(A_re, A_im, B_re, B_im, r2)`` each shaped
    ``(rows, ceil(N / BLA_MIN_SKIP))`` — row ``i`` holds the entries for
    skip length ``BLA_MIN_SKIP * 2^i`` (from orbit positions aligned to
    it), right-padded with zeros (r2 = 0 => never valid).  ``dc_max`` is
    the largest ``|dc|`` any lane will use — the merge's cross term is
    bounded with it, so one table serves a whole tile.

    Merge rule for segment1 (A1,B1,r1) followed by segment2 (A2,B2,r2):
    valid iff the input delta fits segment1 AND the output of segment1
    fits segment2 — conservatively ``|dz| < min(r1, (r2 - |B1| dc_max)
    / |A1|)``; the composed map is ``A = A2 A1, B = A2 B1 + B2``.

    ``z_cap`` zeroes base radii at orbit positions with ``|Z| >=
    z_cap``.  The default (4.0) invalidates every segment containing a
    post-escape entry beyond the first one or two steps (a bounded
    reference stays |Z| <= 2; after escape |Z| squares past 4 within a
    couple of steps toward ~1e100): segments straddling the escape
    would otherwise merge huge-but-positive-radius entries whose
    coefficients saturate to inf in f32, and a zero-delta lane skipped
    through one NaN-poisons into a false in-set (found in review;
    regression-tested).  The earliest straddling positions that slip
    the cap keep FINITE coefficients (late detection there is the
    ordinary skip-boundary contract); additionally, stored radii are
    zeroed wherever the merged coefficients exceed f32 range.  The
    smooth factory passes ``min(4, bailout/2)`` so skips also never
    cross the smoothing radius.
    """
    n = len(z_re)
    min_level = max(1, BLA_MIN_SKIP.bit_length() - 1)
    if levels is None:
        levels = min(BLA_LEVELS_MAX, max(min_level,
                                         int(np.log2(max(2, n)))))
    z = z_re.astype(np.float64) + 1j * z_im.astype(np.float64)
    # Single-step linearization at position k: dz' = 2 Z_k dz + dc.
    a = 2.0 * z
    b = np.ones_like(z)
    with np.errstate(over="ignore", invalid="ignore"):
        r = eps * np.abs(z)
        r = np.where(np.abs(z) < z_cap, r, 0.0)
    rows = max(1, levels - min_level + 1)
    width = max(1, (n + BLA_MIN_SKIP - 1) // BLA_MIN_SKIP)
    A_re = np.zeros((rows, width))
    A_im = np.zeros((rows, width))
    B_re = np.zeros((rows, width))
    B_im = np.zeros((rows, width))
    R2 = np.zeros((rows, width))

    f32_max = float(np.finfo(np.float32).max)

    def store(row, a_l, b_l, r_l):
        k = len(a_l)
        A_re[row, :k] = a_l.real
        A_im[row, :k] = a_l.imag
        B_re[row, :k] = b_l.real
        B_im[row, :k] = b_l.imag
        # A coefficient the f32 upload would saturate must never be
        # selectable (inf * 0 = NaN poisons zero-delta lanes).
        fits = (np.isfinite(a_l) & np.isfinite(b_l)
                & (np.abs(a_l.real) < f32_max)
                & (np.abs(a_l.imag) < f32_max)
                & (np.abs(b_l.real) < f32_max)
                & (np.abs(b_l.imag) < f32_max))
        R2[row, :k] = np.where(fits,
                               np.square(np.maximum(r_l, 0.0)), 0.0)

    # a/b/r start as the per-position single-step maps (skip 1 — the
    # exact path handles single steps, quadratic term included); each
    # merge pass halves the count and doubles the skip.  Levels below
    # min_level are intermediates only.
    for level in range(1, levels + 1):
        m = len(a) // 2
        if m == 0:
            break
        a1, a2 = a[0:2 * m:2], a[1:2 * m:2]
        b1, b2 = b[0:2 * m:2], b[1:2 * m:2]
        r1, r2_ = r[0:2 * m:2], r[1:2 * m:2]
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            abs_a1 = np.abs(a1)
            abs_b1 = np.abs(b1)
            r_out = np.minimum(
                r1, np.where(abs_a1 > 0,
                             (r2_ - abs_b1 * dc_max) / np.maximum(
                                 abs_a1, 1e-300), 0.0))
            a_m = a2 * a1
            b_m = a2 * b1 + b2
        r_out = np.where(np.isfinite(r_out), r_out, 0.0)
        a_m = np.where(np.isfinite(a_m), a_m, 0.0)
        b_m = np.where(np.isfinite(b_m), b_m, 0.0)
        if level >= min_level:
            store(level - min_level, a_m, b_m, r_out)
        a, b, r = a_m, b_m, np.maximum(r_out, 0.0)
    return A_re, A_im, B_re, B_im, R2


def _table(orbit, dc_max: float, eps: float, dtype, z_cap: float = 4.0):
    """The orbit's BLA table cast to the delta dtype (the JAX package's
    ``_device_table``; here host-resident, since the skip decision and
    the skip's coefficients are read on the host), made once and kept
    with the orbit (``perturbation.ReferenceOrbit``), ``dc_max``
    quantized a power of two up so nearby views share it."""
    q = float(2.0 ** np.ceil(np.log2(max(dc_max, 1e-300))))

    def build():
        with phases.timed(obs_names.PHASE_DEEP_BLA_TABLE):
            host = build_bla_table(orbit.z_re, orbit.z_im, q, eps=eps,
                                   z_cap=z_cap)
            # The cast may saturate extension-segment coefficients to
            # inf; build_bla_table zeroed those entries' radii, so they
            # are never selected.
            with np.errstate(over="ignore"):
                return tuple(t.astype(dtype) for t in host)

    return orbit.memo(("bla", q, eps, np.dtype(dtype).str, z_cap), build)


# Exact steps advanced per iteration when no skip validates: amortizes
# the level checks / gathers / live-max reduction that otherwise triple
# the cost of regions stuck on single steps.  256 matches the plain
# scan's slice length (perturbation.PERTURB_SEGMENT grade), measured
# necessary to keep burst-only regions near plain-scan speed.
BLA_EXACT_BURST = 256


_MIN_LEVEL = max(1, BLA_MIN_SKIP.bit_length() - 1)


def _select_skip(n: int, max_dz2: float, R2: np.ndarray, levels: int,
                 orbit_len: int) -> int:
    """Largest valid aligned skip LEVEL for the whole chunk, or 0: table
    row i covers skip length 2^(min_level + i).  ``max_dz2`` and ``R2``
    are values of the delta dtype, compared exactly."""
    for lv in range(_MIN_LEVEL + levels - 1, _MIN_LEVEL - 1, -1):
        span = 1 << lv
        if (n & (span - 1)) == 0 and n + span <= orbit_len \
                and max_dz2 < float(R2[lv - _MIN_LEVEL, n >> lv]):
            return lv
    return 0


def _apply_skip_map(l_sel: int, n: int, tabs, dzr, dzi, dc_re, dc_im,
                    add_dc: bool):
    """The selected level's bilinear map ``dz' = A dz + B dc`` (scalar
    coefficients of the delta dtype), advancing ``n`` by the skip."""
    A_re, A_im, B_re, B_im, _ = tabs
    li, ti = l_sel - _MIN_LEVEL, n >> l_sel
    ar, ai = float(A_re[li, ti]), float(A_im[li, ti])
    br, bi = float(B_re[li, ti]), float(B_im[li, ti])
    bla_r = ar * dzr - ai * dzi
    bla_i = ar * dzi + ai * dzr
    if add_dc:
        bla_r = bla_r + (br * dc_re - bi * dc_im)
        bla_i = bla_i + (br * dc_im + bi * dc_re)
    return n + (1 << l_sel), bla_r, bla_i


def _live_max(live, dzr, dzi):
    """(largest live |dz|^2, any lane live) as Python values: the
    iteration's one device-to-host read."""
    dz2 = torch.where(live, dzr * dzr + dzi * dzi, torch.zeros_like(dzr))
    m, any_live = torch.stack([dz2.amax(), live.any().to(dz2.dtype)]
                              ).tolist()
    return m, any_live != 0


def _bla_scan(z_re, z_im, tabs, dc_re, dc_im, *, orbit_len: int,
              max_iter: int, levels: int, add_dc: bool = True):
    """Delta advance with tile-granular BLA skips -> ``(counts, glitched,
    act, skipped)``, the conventions of ``perturbation._perturb_scan``.
    Each iteration tests position ``n``, reads the chunk's largest live
    |dz|^2, then applies ONE skip or a burst of
    :data:`BLA_EXACT_BURST` exact steps (the plain scan's steps; a lane
    failing at burst offset j has passed j tests, so its count is
    ``n0 + passes``).  Steps past the orbit's end are not run: the JAX
    package's padded steps change none of the outputs."""
    dtype = dc_re.dtype
    dev = dc_re.device
    tol = torch.tensor(GLITCH_TOL, dtype=dtype, device=dev)
    R2 = tabs[4]
    zs = list(zip(z_re.to(dtype).unbind(0), z_im.to(dtype).unbind(0)))
    shape = _shape_of(dc_re, dc_im)
    dzr, dzi = dc_re.expand(shape), dc_im.expand(shape)
    act = torch.ones(shape, dtype=torch.bool, device=dev)
    cnt = torch.full(shape, orbit_len, dtype=torch.int32, device=dev)
    glitched = torch.zeros(shape, dtype=torch.bool, device=dev)
    n, skipped = 0, 0
    while n < orbit_len:
        zr, zi = zs[n]
        _, _, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
        glitched = glitched | (act & (mag2 < tol * zmag2))
        newly_out = act & (mag2 >= 4.0)
        cnt = torch.where(newly_out, torch.full_like(cnt, n), cnt)
        act = act & ~newly_out
        max_dz2, any_live = _live_max(act, dzr, dzi)
        if not any_live:
            break
        l_sel = _select_skip(n, max_dz2, R2, levels, orbit_len)
        if l_sel > 0:
            n2, dzr, dzi = _apply_skip_map(l_sel, n, tabs, dzr, dzi, dc_re,
                                           dc_im, add_dc)
            skipped += n2 - n
            n = n2
            continue
        npass = torch.zeros(shape, dtype=torch.int32, device=dev)
        act0 = act
        for k in range(n, min(n + BLA_EXACT_BURST, orbit_len)):
            zr, zi = zs[k]
            _, _, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
            glitched = glitched | (act & (mag2 < tol * zmag2))
            act = act & (mag2 < 4.0)
            npass = npass + act.to(torch.int32)
            dzr, dzi = _delta_step(dzr, dzi, zr, zi, dc_re, dc_im, add_dc)
        cnt = torch.where(act0 & ~act, n + npass, cnt)
        n += BLA_EXACT_BURST
    if orbit_len < max_iter:
        glitched = glitched | act
    counts = torch.where(cnt >= max_iter, torch.zeros_like(cnt),
                         torch.clamp(cnt, min=1))
    return counts, glitched, act, skipped


def bla_scan_factory(orbit, dc_max: float, *, max_iter: int, dtype,
                     add_dc: bool = True, eps: float = DEFAULT_BLA_EPS):
    """A ``scan_fn(zr, zi, dre, dim) -> (counts, glitched)`` for
    ``perturbation._compute_perturb`` on the orbit's BLA table; ``zr/zi``
    passed at call time are the orbit's device copy."""
    tabs = _table(orbit, dc_max, eps, dtype)
    levels = tabs[0].shape[0]
    orbit_len = len(orbit.z_re)

    def scan_fn(zr, zi, dre, dim):
        counts, glitched, _, skipped = _bla_scan(
            zr, zi, tabs, dre, dim, orbit_len=orbit_len,
            max_iter=max_iter, levels=levels, add_dc=add_dc)
        logger.debug("BLA skipped %d of %d orbit steps on this chunk",
                     skipped, orbit_len)
        return counts, glitched

    return scan_fn


def _bla_scan_smooth(z_re, z_im, tabs, dc_re, dc_im, *, orbit_len: int,
                     max_iter: int, levels: int, bailout: float,
                     add_dc: bool = True):
    """Smooth twin of :func:`_bla_scan` -> ``(nu, glitched, skipped)``,
    the conventions of ``perturbation._perturb_scan_smooth`` (the frozen
    full value at the first radius-``bailout`` crossing, the radius-2
    count for in-set).  The table must be built with ``z_cap <=
    bailout / 2`` so skips never cross the smoothing radius."""
    dtype = dc_re.dtype
    dev = dc_re.device
    tol = torch.tensor(GLITCH_TOL, dtype=dtype, device=dev)
    b2 = torch.tensor(bailout * bailout, dtype=dtype, device=dev)
    R2 = tabs[4]
    zs = list(zip(z_re.to(dtype).unbind(0), z_im.to(dtype).unbind(0)))
    shape = _shape_of(dc_re, dc_im)
    dzr, dzi = dc_re.expand(shape), dc_im.expand(shape)
    act_b = torch.ones(shape, dtype=torch.bool, device=dev)
    act2 = torch.ones_like(act_b)
    cnt_b = torch.full(shape, orbit_len, dtype=torch.int32, device=dev)
    cnt2 = cnt_b.clone()
    fzr = torch.full(shape, bailout, dtype=dtype, device=dev)
    fzi = torch.zeros(shape, dtype=dtype, device=dev)
    glitched = torch.zeros(shape, dtype=torch.bool, device=dev)
    n, skipped = 0, 0
    while n < orbit_len:
        zr, zi = zs[n]
        fr, fi, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
        glitched = glitched | (act2 & (mag2 < tol * zmag2))
        newly = act_b & (mag2 >= b2)
        fzr = torch.where(newly, fr, fzr)
        fzi = torch.where(newly, fi, fzi)
        cnt_b = torch.where(newly, torch.full_like(cnt_b, n), cnt_b)
        act_b = act_b & ~newly
        out2 = act2 & (mag2 >= 4.0)
        cnt2 = torch.where(out2, torch.full_like(cnt2, n), cnt2)
        act2 = act2 & ~out2
        max_dz2, any_live = _live_max(act_b | act2, dzr, dzi)
        if not any_live:
            break
        l_sel = _select_skip(n, max_dz2, R2, levels, orbit_len)
        if l_sel > 0:
            n2, dzr, dzi = _apply_skip_map(l_sel, n, tabs, dzr, dzi, dc_re,
                                           dc_im, add_dc)
            skipped += n2 - n
            n = n2
            continue
        nb = torch.zeros(shape, dtype=torch.int32, device=dev)
        n2c = torch.zeros_like(nb)
        act_b0, act20 = act_b, act2
        for k in range(n, min(n + BLA_EXACT_BURST, orbit_len)):
            zr, zi = zs[k]
            fr, fi, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
            glitched = glitched | (act2 & (mag2 < tol * zmag2))
            newly = act_b & (mag2 >= b2)
            fzr = torch.where(newly, fr, fzr)
            fzi = torch.where(newly, fi, fzi)
            act_b = act_b & (mag2 < b2)
            nb = nb + act_b.to(torch.int32)
            act2 = act2 & (mag2 < 4.0)
            n2c = n2c + act2.to(torch.int32)
            dzr, dzi = _delta_step(dzr, dzi, zr, zi, dc_re, dc_im, add_dc)
        cnt_b = torch.where(act_b0 & ~act_b, n + nb, cnt_b)
        cnt2 = torch.where(act20 & ~act2, n + n2c, cnt2)
        n += BLA_EXACT_BURST
    nu, glitched = _smooth_nu(cnt_b, cnt2, fzr, fzi, act2, glitched,
                              orbit_len=orbit_len, max_iter=max_iter,
                              bailout=bailout)
    return nu, glitched, skipped


# Smooth-path skip guard: only orbit segments with |Z| below this may be
# skipped.  Measured by the JAX package at eps 2^-16 (256^2): at the
# integer path's 4.0 cap the smooth plane differed from the exact scan
# on 17.7% of the config-4 boundary view's pixels (p99 |dnu| 0.005 but
# MAX 72 bands); at 1.0 the two were bit-identical there.  The cap alone
# does not make the smooth route exact: at eps 2^-16 it still left the
# period-349 minibrot view 6.96 off, which the dtype's own eps
# (smooth_bla_eps) cures.  Mid-magnitude segments (1 <= |Z| < 4)
# amplify the dropped quadratic term right where smooth values are most
# visible; the integer path keeps 4.0 under its documented approximate
# contract.
SMOOTH_Z_CAP = 1.0


def _smooth_table(orbit, dc_max: float, *, bailout: float, dtype):
    """The smooth scan's table: ``eps`` the dtype's unit roundoff,
    ``z_cap`` the lesser of :data:`SMOOTH_Z_CAP` and bailout/2."""
    return _table(orbit, dc_max, smooth_bla_eps(dtype), dtype,
                  z_cap=min(SMOOTH_Z_CAP, bailout / 2.0))


def smooth_table_skips(orbit, dc_max: float, *, bailout: float,
                       dtype) -> bool:
    """Whether the orbit's smooth table offers a skip at the orbit's
    start to deltas as large as ``dc_max``: the first choice the smooth
    scan makes over a chunk whose lanes reach it.  In float64 the tables
    of the period-349 minibrot view at 1.5e-17 and of the bond view at
    1e-15 hold no valid skip anywhere.  The table is the one
    :func:`bla_smooth_scan_factory` then uses."""
    R2 = _smooth_table(orbit, dc_max, bailout=bailout, dtype=dtype)[4]
    dc2 = float(np.asarray(dc_max * dc_max, dtype=dtype))
    return _select_skip(0, dc2, R2, R2.shape[0], len(orbit.z_re)) > 0


def bla_smooth_scan_factory(orbit, dc_max: float, *, max_iter: int,
                            bailout: float, dtype, add_dc: bool = True):
    """Smooth counterpart of :func:`bla_scan_factory` -> ``scan_fn(zr,
    zi, dre, dim) -> (nu, glitched)``, on :func:`_smooth_table`: its
    ``z_cap`` keeps every freeze inside exact steps, its ``eps`` every
    skip within rounding."""
    tabs = _smooth_table(orbit, dc_max, bailout=bailout, dtype=dtype)
    levels = tabs[0].shape[0]
    orbit_len = len(orbit.z_re)

    def scan_fn(zr, zi, dre, dim):
        nu, glitched, skipped = _bla_scan_smooth(
            zr, zi, tabs, dre, dim, orbit_len=orbit_len,
            max_iter=max_iter, levels=levels, bailout=float(bailout),
            add_dc=add_dc)
        logger.debug("BLA skipped %d of %d orbit steps on this chunk",
                     skipped, orbit_len)
        return nu, glitched

    return scan_fn
