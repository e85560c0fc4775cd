"""Perturbation-theory deep zoom: the port of the JAX package's
``ops/perturbation.py``, for views where direct iteration runs out of
precision.

    z_n = Z_n + dz_n,   dz_{n+1} = 2 Z_n dz_n + dz_n^2 + dc

``Z`` is ONE high-precision reference orbit (host-side fixed-point
bigints, exact: the native C++ limb loops of
:mod:`distributedmandelbrot_tpu_torch.native` where g++ is available,
stdlib ints otherwise), truncated to float64; the per-pixel deltas stay
at pixel scale, so f32/f64 device math suffices.  The host side (fixed
point, the reference search, the exact glitch repair) is the JAX
package's, copied.  The device side runs the delta scans on the caller's
device: on a CUDA device through the hand-written kernels of
:mod:`~distributedmandelbrot_tpu_torch.ops.cuda_perturb` (K9 integer,
K10 smooth), on the CPU through their plain PyTorch versions, which the
kernels equal bit for bit.

Glitch handling (Pauldelbrot's criterion): where ``|z_n|`` collapses far
below ``|Z_n|`` the delta orbit is untrustworthy; such pixels are
flagged on the device, re-scanned against a secondary reference where
one covers the budget, and otherwise recomputed exactly on the host in
fixed point.  ``DeepTileSpec`` carries the center as decimal strings, so
spans far below 1e-16 render.

Where the JAX package trims the device-to-host fetch (uint16 counts, a
bit-packed glitch mask: its rig's host link was slow), the port fetches
the int32 and bool planes as they are; the output is the same.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass, field
from functools import lru_cache, partial

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs import phases
# The route's phase seconds, read and reset here as they always were.
from distributedmandelbrot_tpu_torch.obs.phases import (  # noqa: F401
    phase_seconds, reset_phase_seconds)

logger = logging.getLogger(__name__)

# Fixed-point precision floor for the reference orbit (fractional bits);
# compute_counts_perturb widens automatically with depth so the orbit
# always carries >= 64 bits below the pixel pitch — the widening formula,
# not this floor, is what enforces the precision policy.  One 128-bit
# limb pair is the floor (the auto-widening already exceeds it beyond
# span ~1e-19): the old 256 floor doubled the limb work of every orbit
# and every exact glitch repair at production depths for no added
# guarantee (this rig is single-core — the repair loop is serial), a
# measured 2x on the config-4 repair pass.
DEFAULT_PREC_BITS = 128

# Pauldelbrot criterion: |z|^2 < GLITCH_TOL * |Z|^2 marks a pixel
# glitched (cancellation ate the significand).
GLITCH_TOL = 1e-6

# How many glitched pixels to try as the secondary reference before
# giving up on the device repair pass.  A candidate whose orbit escapes
# early costs only that escape-length bigint orbit, so misses are far
# cheaper than the per-pixel exact loop the pass replaces.
SECONDARY_REFERENCE_TRIES = 8


# -- host-side exact arithmetic (stdlib bigints) --------------------------


def _to_fixed(value: str | float, bits: int) -> int:
    """Decimal string (or float) -> fixed-point integer with ``bits``
    fractional bits, exactly."""
    if isinstance(value, float):
        # Floats convert exactly: value = num/den in lowest binary terms.
        from fractions import Fraction

        f = Fraction(value)
        return (f.numerator << bits) // f.denominator
    s = str(value).strip()
    neg = s.startswith("-")
    s = s.lstrip("+-")
    exp = 0
    if "e" in s or "E" in s:
        s, e = s.replace("E", "e").split("e")
        exp = int(e)
    if "." in s:
        whole, frac = s.split(".")
    else:
        whole, frac = s, ""
    digits = int((whole + frac) or "0")
    exp -= len(frac)
    # value = digits * 10^exp; scale by 2^bits exactly.
    if exp >= 0:
        num = digits * (10 ** exp) << bits
    else:
        num = (digits << bits) // (10 ** (-exp))
    return -num if neg else num


def _fixed_to_float(v: int, bits: int) -> float:
    """Fixed-point -> float64 without materializing float(v): the orbit
    extension stores values up to ~1e100, whose bigints exceed float64
    range once ``bits`` > ~690 (deep-zoom precision widening)."""
    if v == 0:
        return 0.0
    import math

    m = abs(v)
    shift = m.bit_length() - 53
    if shift > 0:
        # Round to nearest, not truncate — keeps exact round trips.
        out = math.ldexp((m + (1 << (shift - 1))) >> shift, shift - bits)
    else:
        out = math.ldexp(m, -bits)
    return -out if v < 0 else out


def reference_orbit(center_re: str | float, center_im: str | float,
                    max_iter: int, *,
                    prec_bits: int = 256
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """High-precision escape-time orbit of the center, truncated to
    float64 arrays.  The arrays are those of the orbit store,
    :data:`ORBITS`, and read-only.

    Returns ``(Z_re, Z_im, valid_len)`` with ``Z[k] = z_{k+1}`` — the
    orbit runs ``z_1 = c`` through ``z_{max_iter}`` (the last value the
    reference convention ever tests), so a full in-set orbit has
    ``valid_len == max_iter``.  The ARRAYS extend past ``valid_len`` by
    up to 12 further true orbit values (post-escape they diverge) so
    pixels escaping near the orbit's end can reach the smooth-coloring
    radius; consumers needing only the tested orbit must slice
    ``Z[:valid_len]``.  Arithmetic is ``prec_bits``-bit fixed-point
    bigint (stdlib): per-step rounding is 2^-prec_bits — the default
    stays 256 bits (~77 decimal digits of input precision) because this
    public helper takes raw decimal strings with NO depth auto-widening,
    unlike the _compute_perturb path and its 128-bit floor.
    """
    v_re = _to_fixed(center_re, prec_bits)
    v_im = _to_fixed(center_im, prec_bits)
    orbit = ORBITS.get(v_re, v_im, v_re, v_im, max_iter, prec_bits)
    return orbit.z_re, orbit.z_im, orbit.valid


def _native_fixed(bits: int = 0, *vals: int) -> bool:
    """Use the native fixed-point kernels for these inputs?  (Exact-
    parity C++ limb loops, several times the CPython-bigint rate; tests
    pin bytewise parity.)  The native buffers bound input magnitudes at
    2^(bits+2) (|value| < 4 — anything beyond escapes at iteration 1
    but must still count CORRECTLY); wilder inputs, which the fixed
    buffers would overflow, stay on the unbounded Python path."""
    if any(abs(v).bit_length() > bits + 2 for v in vals):
        return False
    try:
        from distributedmandelbrot_tpu_torch.native import bindings

        return bindings.native_supported()
    except Exception:
        return False


def _orbit_fixed_impl(za: int, zb: int, ca: int, cb: int, max_iter: int,
                      bits: int, extra: int = 12
                      ) -> tuple[np.ndarray, np.ndarray, int]:
    """Orbit entries ``z_1..`` plus up to ``extra`` true diverging steps
    past the first escape (or past the budget), so pixels escaping near
    the orbit's end can still reach the smooth-coloring radius.  The
    returned ``valid_len`` counts only the pre-extension entries; the
    arrays may be longer.  Post-escape values square each step, so the
    extension stops before float64 overflow (~1e100).  Uncached: the
    route reaches it through :data:`ORBITS`."""
    # Host only, so its phase is marked in a profiler's trace.
    with phases.timed(obs_names.PHASE_DEEP_ORBIT, annotate=True):
        if _native_fixed(bits, za, zb, ca, cb):
            from distributedmandelbrot_tpu_torch.native import bindings

            return bindings.fixed_orbit(za, zb, ca, cb, max_iter, bits, extra)
        one = 1 << bits
        four = 4 * one * one  # |z|^2 comparisons happen at 2*bits scale
        huge = (10 ** 100) * one * one
        steps = max(1, max_iter)
        z_re = np.empty(steps + extra, np.float64)
        z_im = np.empty(steps + extra, np.float64)
        a, b = za, zb
        n = 0
        valid = None
        while n < steps + extra:
            z_re[n] = _fixed_to_float(a, bits)
            z_im[n] = _fixed_to_float(b, bits)
            n += 1
            a2 = a * a
            b2 = b * b
            if valid is None and (n >= steps or a2 + b2 >= four):
                valid = n
            if valid is not None and (n >= valid + extra or a2 + b2 >= huge):
                break
            a, b = (a2 - b2 >> bits) + ca, ((a * b) >> (bits - 1)) + cb
        return z_re[:n], z_im[:n], valid if valid is not None else n


# The orbit store's bounds.  A view uses about 15 orbits (its reference
# search's hops and up to SECONDARY_REFERENCE_TRIES secondary candidates)
# and one BLA table, so 64 orbits cover several views: a zoom animation
# re-renders its center's orbit at every frame, and the orbit depends
# only on (center, budget, precision), with precision quantized by the
# caller.  At the 50,000-step budget an orbit and its device copy take
# 1.6 MB; the byte bound keeps giant budgets from pinning gigabytes of
# host or device memory.
ORBIT_STORE_MAX = 64
ORBIT_STORE_MAX_BYTES = 256 * 1024 * 1024


def _nbytes(value) -> int:
    """Bytes of an array, a tensor or a tuple of them (0 for others)."""
    if isinstance(value, tuple):
        return sum(_nbytes(v) for v in value)
    return getattr(value, "nbytes", 0)


@dataclass(frozen=True, eq=False)
class ReferenceOrbit:
    """One reference orbit: its fixed-point inputs, the float64 entries
    of :func:`_orbit_fixed_impl` (read-only) and their valid length.
    What is derived from it (its device copies, BLA tables and auto-BLA
    answers) is made once, kept on it and evicted with it from
    :data:`ORBITS`."""

    key: tuple  # (za, zb, ca, cb, max_iter, bits)
    z_re: np.ndarray
    z_im: np.ndarray
    valid: int
    _derived: dict = field(default_factory=dict, repr=False)

    @property
    def nbytes(self) -> int:
        """Host arrays and every derived array or tensor, in bytes."""
        return _nbytes((self.z_re, self.z_im, *self._derived.values()))

    def memo(self, key: tuple, make):
        """``make()``, made once per ``key`` and kept with the orbit."""
        if key not in self._derived:
            value = self._derived[key] = make()
            ORBITS.touch(self, _nbytes(value))
        return self._derived[key]

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The orbit as float64 tensors on ``device``, uploaded once.  The
        scans cast it to their delta dtype (f32 saturates the post-escape
        extension's ~1e100 entries to inf by design: the scans treat them
        as escaped)."""
        dev = torch.device(device)
        return self.memo(("on", str(dev)), lambda: (
            torch.tensor(self.z_re, device=dev),
            torch.tensor(self.z_im, device=dev)))


class _OrbitStore:
    """The reference orbits in use, keyed by their fixed-point inputs:
    at most :data:`ORBIT_STORE_MAX` orbits and
    :data:`ORBIT_STORE_MAX_BYTES` with what is derived from them.  The
    least recently used orbit goes first, never the one just made or
    added to."""

    def __init__(self):
        self._lru: OrderedDict[tuple, ReferenceOrbit] = OrderedDict()
        self._bytes = 0

    def get(self, za: int, zb: int, ca: int, cb: int, max_iter: int,
            bits: int) -> ReferenceOrbit:
        """The orbit of ``z -> z^2 + (ca, cb)`` from ``(za, zb)``, computed
        if the store does not hold it."""
        key = (za, zb, ca, cb, max_iter, bits)
        orbit = self._lru.get(key)
        if orbit is None:
            z_re, z_im, valid = _orbit_fixed_impl(*key)
            z_re.flags.writeable = z_im.flags.writeable = False
            orbit = self._lru[key] = ReferenceOrbit(key, z_re, z_im, valid)
            self._bytes += orbit.nbytes
        self.touch(orbit)
        return orbit

    def touch(self, orbit: ReferenceOrbit, grown: int = 0) -> None:
        """Make ``orbit``, which has just grown by ``grown`` bytes, the most
        recently used and evict to the bounds.  An orbit already evicted
        stays with whoever holds it."""
        if self._lru.get(orbit.key) is not orbit:
            return
        self._bytes += grown
        self._lru.move_to_end(orbit.key)
        while len(self._lru) > 1 and (len(self._lru) > ORBIT_STORE_MAX or
                                      self._bytes > ORBIT_STORE_MAX_BYTES):
            self._bytes -= self._lru.popitem(last=False)[1].nbytes

    def clear(self) -> None:
        """Forget every orbit, all that is derived from one, and every
        reference search's result."""
        self._lru.clear()
        self._bytes = 0
        _search_reference.cache_clear()


ORBITS = _OrbitStore()


def _escape_counts_exact_batch(points: list[tuple[int, int]],
                               max_iter: int, bits: int,
                               julia_c: tuple[int, int] | None
                               ) -> np.ndarray:
    """Exact escape counts for a batch of fixed-point points — the
    glitch-repair remainder.  Native path: one C++ call, threaded over
    cores.  Fallback: the per-point loop."""
    flat = [v for p in points for v in p]
    if julia_c is not None:
        flat += list(julia_c)
    if _native_fixed(bits, *flat):
        from distributedmandelbrot_tpu_torch.native import bindings

        return bindings.fixed_escape_batch(points, max_iter, bits,
                                           julia_c=julia_c)
    ca, cb = julia_c if julia_c is not None else (None, None)
    return np.array([_escape_count_fixed(pa, pb, max_iter, bits,
                                         ca=ca, cb=cb)
                     for pa, pb in points], np.int32)


def escape_counts_exact(c_re: str | float, c_im: str | float, max_iter: int,
                        *, prec_bits: int = 256) -> int:
    """Reference-convention escape count of one point in fixed point
    (the glitch-pixel fallback): 0 = never escaped within budget."""
    return _escape_count_fixed(_to_fixed(c_re, prec_bits),
                               _to_fixed(c_im, prec_bits),
                               max_iter, prec_bits)


def _escape_count_fixed(za: int, zb: int, max_iter: int, bits: int,
                        ca: int | None = None,
                        cb: int | None = None) -> int:
    """Reference convention exactly (DistributedMandelbrotWorkerCUDA.py:
    44-68): z starts at ``(za, zb)``, each iteration updates THEN tests,
    counts 1..max_iter-1, 0 = never escaped.  ``(ca, cb)`` is the
    additive constant — defaults to the start point (Mandelbrot); pass
    it separately for the Julia family."""
    if ca is None:
        ca, cb = za, zb
    if _native_fixed(bits, za, zb, ca, cb):
        from distributedmandelbrot_tpu_torch.native import bindings

        return bindings.fixed_escape(za, zb, ca, cb, max_iter, bits)
    one = 1 << bits
    four = 4 * one * one
    a, b = za, zb
    a2, b2 = a * a, b * b
    for it in range(1, max_iter):
        a, b = (a2 - b2 >> bits) + ca, ((a * b) >> (bits - 1)) + cb
        a2, b2 = a * a, b * b
        if a2 + b2 >= four:
            return it
    return 0


# -- geometry -------------------------------------------------------------


@dataclass(frozen=True)
class DeepTileSpec:
    """A deep-zoom view: center as decimal strings (arbitrary precision),
    span in plane units (a float — spans are small, centers are not).

    Pixel (row, col) sits at center + ((col - (w-1)/2) * step,
    (row - (h-1)/2) * step) with step = span / (width - 1): deltas from
    the center are what the device kernel consumes, and they are
    comfortably representable at any zoom.
    """

    center_re: str
    center_im: str
    span: float
    width: int = 1024
    height: int = 1024

    @property
    def step(self) -> float:
        return self.span / (self.width - 1)

    def offset(self, row, col) -> tuple:
        """Pixel ``(row, col)``'s offset from the center, ``(re, im)``, in
        float64; rows and columns may be index arrays."""
        return ((col - (self.width - 1) / 2) * self.step,
                (row - (self.height - 1) / 2) * self.step)

    def delta_grids(self, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
        col, row = self.offset(np.arange(self.height), np.arange(self.width))
        dre = np.broadcast_to(col, (self.height, self.width))
        dim = np.broadcast_to(row[:, None], (self.height, self.width))
        return dre.astype(dtype).copy(), dim.astype(dtype).copy()


def _device(device) -> torch.device:
    """``device`` with an explicit CUDA index (the current device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# -- device scans -------------------------------------------------------


PERTURB_SEGMENT = 256


# Stagnation stop for the delta scans (round-4, config-4 profile): the
# device scan's whole-chunk early exit only fires when EVERY lane
# retires, so a handful of bounded lanes — which end up glitch-flagged
# and exactly recomputed anyway — dragged the full 512^2 chunk through
# the entire 50000-step orbit (measured: 678 such lanes = 74% of warm
# render time).  Once the live count has not changed for this many
# steps AND the live set is small, the scan stops and flags the
# stragglers as suspect; they join the exact-repair path that already
# guaranteed their values.  Output-exact by construction (the repair is
# exact); the trade is bounded: at most ``STAGNATION_MAX_LIVE`` lanes
# can be diverted, each costing one exact fixed-point orbit — a FLAT
# cap, because a relative one would let a minibrot sliver of thousands
# of clean in-set pixels (which the device scan retires for free) be
# diverted to the serial bigint loop (round-4 review finding).
STAGNATION_QUIET_STEPS = 2048
STAGNATION_MAX_LIVE = 64


def _safe_segments(seg: int, last_change: int, prev: int, full: int, *,
                   cap: int = STAGNATION_MAX_LIVE,
                   quiet: int = STAGNATION_QUIET_STEPS // PERTURB_SEGMENT
                   ) -> int:
    """Whole segments that may run from segment ``seg`` before the
    stagnation stop is judged again: none of their ends but the last can
    be where the loop stops for stagnation.  With more than ``cap`` live,
    the count must first fall to the cap and then stay for the quiet
    window of ``quiet`` segments; at or below it, the window must run
    out."""
    k = quiet + 1 if prev > cap else max(1, quiet - (seg - last_change))
    return min(k, full - seg)


def _stagnation_loop(segments, live0: int, full: int, *, cap: int,
                     segment: int = PERTURB_SEGMENT) -> int:
    """The segment loop's rule with the stagnation stop armed:
    ``segments(seg, k)`` runs whole segments ``seg .. seg + k - 1`` and
    yields the live count after each (the plain scans step one segment
    at a time; K9 runs the k in one launch, ``cuda_perturb``).  The loop
    ends when no lane is live, or once the count is <= ``cap`` and has
    not changed for :data:`STAGNATION_QUIET_STEPS` steps.  Returns the
    segments run: fewer than ``full`` means it stopped early, and the
    lanes live then are suspect."""
    quiet = max(1, STAGNATION_QUIET_STEPS // segment)
    seg, last_change, prev = 0, 0, live0

    def going() -> bool:
        return (seg < full and prev > 0
                and (seg - last_change < quiet or prev > cap))

    while going():
        k = _safe_segments(seg, last_change, prev, full, cap=cap,
                           quiet=quiet)
        for cnt in segments(seg, k):
            if cnt != prev:
                last_change = seg + 1
            prev = cnt
            seg += 1
            if not going():
                break
    return seg


def _segmented_orbit_scan(step, init, z_re, z_im, live_of, *,
                          segment: int = PERTURB_SEGMENT,
                          stagnation=None):
    """The JAX package's segment loop of the plain scans: ``step(carry,
    (Z_re[k], Z_im[k]))`` for every orbit entry, in whole
    ``segment``-step slices while ``live_of(carry)`` (a Python bool)
    reports a live lane, then the ragged tail (inert if the loop stopped
    early).

    ``stagnation=(live_count_of, live_mask_of, cap)`` arms the stagnation
    stop (:func:`_stagnation_loop`); the return is then ``(carry,
    suspect)``, ``suspect`` marking the lanes still live at such a stop
    (their values are untrustworthy: the caller routes them to the exact
    repair).  Every carry component frozen by the live masks equals the
    full scan's; the raw dz need not."""
    orbit_len = z_re.shape[0]
    full = orbit_len // segment
    zs = list(zip(z_re.unbind(0), z_im.unbind(0)))

    def run(carry, k0, k1):
        for k in range(k0, k1):
            carry = step(carry, zs[k])
        return carry

    if stagnation is None:
        carry, seg = init, 0
        while seg < full and live_of(carry):
            carry = run(carry, seg * segment, (seg + 1) * segment)
            seg += 1
        return run(carry, full * segment, orbit_len)

    live_count_of, live_mask_of, cap = stagnation
    carry = init

    def segments(seg, k):
        nonlocal carry
        for s in range(seg, seg + k):
            carry = run(carry, s * segment, (s + 1) * segment)
            yield live_count_of(carry)

    seg = _stagnation_loop(segments, live_count_of(init), full, cap=cap,
                           segment=segment)
    mask = live_mask_of(carry)
    suspect = mask.clone() if seg < full else torch.zeros_like(mask)
    return run(carry, full * segment, orbit_len), suspect


def _perturb_epilogue(n, active, glitched, suspect, orbit_len: int,
                      max_iter: int):
    """The scan's state -> ``(counts, glitched, active)``: lanes still
    bounded when a short (escaped) reference orbit ran out, and
    stagnation-stopped stragglers, are glitched; counts follow the
    reference convention (0 = in-set, at least 1 otherwise)."""
    if orbit_len < max_iter:
        glitched = glitched | active
    glitched = glitched | suspect
    counts = torch.where(n >= max_iter, torch.zeros_like(n),
                         torch.clamp(n, min=1))
    return counts, glitched, active


def _perturb_scan(z_re, z_im, dc_re, dc_im, *, max_iter: int,
                  add_dc: bool = True, stagnation: bool = True):
    """Delta-orbit scan -> ``(counts, glitched, active)``, the JAX
    package's ``_perturb_scan``: step ``k`` tests ``z_{k+1} = Z[k] + dz``
    and advances the delta; ``n`` counts passed tests (0 clamps up to
    the reference's 1; ``n >= max_iter`` is in-set -> 0).  ``glitched``
    marks Pauldelbrot cancellation, lanes that outlived a short
    reference orbit, and (``stagnation``) the stagnation stop's
    stragglers.  ``z_re/z_im`` are the device orbit (any float dtype,
    cast to the deltas'); ``dc_re/dc_im`` the deltas, any broadcast
    view.  ``stagnation=False`` for callers that need the true
    alive-at-orbit-end mask (the reference hop probe, the auto-BLA
    probe).  On a CUDA device this is K9; on the CPU its plain
    version."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb
    n, active, glitched, suspect = cuda_perturb.perturb_state(
        z_re, z_im, dc_re, dc_im, add_dc=add_dc, stagnation=stagnation)
    return _perturb_epilogue(n, active, glitched, suspect, z_re.shape[0],
                             max_iter)


def _smooth_nu(n, n2, fzr, fzi, act2, glitched, *, orbit_len: int,
               max_iter: int, bailout: float):
    """The smooth scans' epilogue (shared by the K10 route, its plain
    version and the BLA smooth scan): the renormalized count from the
    frozen full value, 0 for in-set (radius-2 budget exhausted)."""
    dtype = fzr.dtype
    if orbit_len < max_iter:
        glitched = glitched | act2
    b2 = torch.tensor(bailout * bailout, dtype=dtype, device=fzr.device)
    mag2 = torch.maximum(fzr * fzr + fzi * fzi, b2)
    log_ratio = torch.log(mag2) / torch.tensor(
        2.0 * np.log(bailout), dtype=dtype, device=fzr.device)
    nu = (n + 1).to(dtype) - torch.log2(log_ratio)
    nu = torch.where(n2 >= max_iter, torch.zeros_like(nu), nu)
    return nu, glitched


def _perturb_scan_smooth(z_re, z_im, dc_re, dc_im, *, max_iter: int,
                         bailout: float, add_dc: bool = True,
                         lane_steps: list | None = None,
                         tiles: list | None = None):
    """Smooth twin of :func:`_perturb_scan` -> ``(nu, glitched)``: also
    freezes the full value at the first radius-``bailout`` crossing; a
    radius-2 count alongside classifies in-set pixels as the integer
    path does.  No stagnation stop (a stagnant lane diverted to the
    exact repair would come back as an integer count).  K10 on a CUDA
    device, its plain version on the CPU.  ``lane_steps``, a list, gets
    the steps the lanes needed (each to its bailout crossing, or the
    whole orbit) as one int64 tensor on the device, summed there;
    ``tiles``, a list, the orbit tiles K10 staged, likewise (nothing on
    the CPU)."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb
    staged = None
    if tiles is not None and dc_re.device.type == "cuda":
        staged = torch.zeros(1, dtype=torch.int64, device=dc_re.device)
        tiles.append(staged[0])
    n, n2, fzr, fzi, act_b, act2, glitched = \
        cuda_perturb.perturb_smooth_state(z_re, z_im, dc_re, dc_im,
                                          bailout=bailout, add_dc=add_dc,
                                          tiles=staged)
    if lane_steps is not None:
        lane_steps.append((n + 1).masked_fill(act_b, z_re.shape[0]).sum(
            dtype=torch.int64))
    return _smooth_nu(n, n2, fzr, fzi, act2, glitched,
                      orbit_len=z_re.shape[0], max_iter=max_iter,
                      bailout=bailout)


# Auto-BLA gate (round-4, verdict item 3): ``bla=None`` probes whether
# the tile-granular skip path would pay before committing to either
# scan.  The probe is the EXACT delta scan on a ~4096-lane subsample of
# the tile, capped at BLA_AUTO_PROBE_STEPS: BLA wins exactly on views
# whose lanes stay bounded (and cancellation-clean) deep into a
# full-budget orbit — slow dynamics near parabolic points / minibrot
# margins, measured 9.5x on the bond-point bench — and loses on
# escape-rich views whose scans exit early anyway (measured -12% on the
# config-4 Misiurewicz window).  Survivor fraction at the probe horizon
# separates the two cleanly: ~1.0 on the bond view vs ~0.003 on
# config 4.  Decisions are kept with the orbit per delta scale, so
# animations and bench repeats pay the probe dispatch once.
BLA_AUTO_MIN_BUDGET = 20000
BLA_AUTO_PROBE_STEPS = 4096
BLA_AUTO_PROBE_LANES = 4096
BLA_AUTO_SURVIVOR_FRAC = 0.5


def _auto_bla(orbit: ReferenceOrbit, dre: np.ndarray, dim: np.ndarray,
              max_iter: int, add_dc: bool, dtype=np.float32,
              device="cpu") -> bool:
    """Decide the BLA question for one (orbit, view, budget): the exact
    delta scan on a lattice of about 4096 lanes of the view, capped at
    :data:`BLA_AUTO_PROBE_STEPS`, at the render dtype, on ``device``;
    BLA wins where most lanes are still bounded and clean there.  The
    answer is kept with the orbit per budget, delta-scale exponent,
    dtype, ``add_dc`` and device."""
    z_re = orbit.z_re
    if max_iter < BLA_AUTO_MIN_BUDGET or len(z_re) < max_iter:
        return False
    scale = float(max(np.max(np.abs(dre)), np.max(np.abs(dim)), 1e-300))
    dev = torch.device(device)

    def probe() -> bool:
        # A 2-D lattice over the separable delta grid, at the render dtype.
        h, w = dre.shape
        side = int(np.sqrt(BLA_AUTO_PROBE_LANES))
        ci = np.linspace(0, w - 1, min(side, w)).astype(int)
        ri = np.linspace(0, h - 1, min(side, h)).astype(int)
        pre = np.broadcast_to(dre[0, ci][None, :], (len(ri), len(ci)))
        pim = np.broadcast_to(dim[ri, 0][:, None], (len(ri), len(ci)))
        plen = min(BLA_AUTO_PROBE_STEPS, len(z_re))
        zr, zi = orbit.on(dev)
        _, glitched, active = _perturb_scan(
            zr[:plen], zi[:plen],
            torch.as_tensor(pre.astype(dtype), device=dev),
            torch.as_tensor(pim.astype(dtype), device=dev),
            max_iter=plen, add_dc=add_dc, stagnation=False)
        frac = float((active & ~glitched).cpu().numpy().mean())
        decision = frac >= BLA_AUTO_SURVIVOR_FRAC
        logger.info("BLA auto-%s: probe survivor fraction %.3f at step %d "
                    "(budget %d)", "enabled" if decision else "disabled",
                    frac, plen, max_iter)
        return decision

    return orbit.memo(("auto_bla", max_iter, int(np.round(np.log2(scale))),
                       np.dtype(dtype).str, add_dc, str(dev)), probe)


def _find_reference(za: int, zb: int, ca: int, cb: int, span: float,
                    max_iter: int, bits: int, *, add_dc: bool = True,
                    probes: int = 5, hops: int = 8, device: str = "cpu"
                    ) -> tuple[ReferenceOrbit, float, float]:
    """Pick a reference point whose orbit survives as long as possible
    (the JAX package's search, its probe scans on ``device``): compute
    the candidate's orbit, scan a probe lattice of the view against it
    in f64, and hop to a probe that outlives it (on an all-exterior
    Mandelbrot lattice: to the deepest-escaping probe, escalating once
    to a 64^2 lattice) until the orbit covers the budget or no hop
    helps.  Returns the orbit and the reference's offset from the
    center.  The search's result is memoised; its orbit lives in
    :data:`ORBITS` (computed again if evicted since)."""
    key, off_re, off_im = _search_reference(za, zb, ca, cb, span, max_iter,
                                            bits, add_dc, probes, hops,
                                            device)
    return ORBITS.get(*key), off_re, off_im


@lru_cache(maxsize=16)
def _search_reference(za: int, zb: int, ca: int, cb: int, span: float,
                      max_iter: int, bits: int, add_dc: bool, probes: int,
                      hops: int, device: str) -> tuple[tuple, float, float]:
    """:func:`_find_reference`'s search -> the winning orbit's key in
    :data:`ORBITS` and its offset from the center."""
    dev = torch.device(device)
    off_re = 0.0
    off_im = 0.0
    lattices = [probes, 64] if add_dc else [probes]
    li = 0
    orbit = ORBITS.get(za, zb, ca, cb, max_iter, bits)
    for _ in range(hops + len(lattices)):
        n = orbit.valid
        if n >= max_iter:
            break
        side = lattices[li]
        lat = np.linspace(-span / 2, span / 2, side)
        pre = np.broadcast_to(lat, (side, side)).ravel() - off_re
        pim = np.repeat(lat, side) - off_im
        # Against the orbit's VALID prefix: the post-escape extension
        # diverges and would corrupt the alive mask.
        with phases.timed(obs_names.PHASE_DEEP_PROBE):
            zr, zi = orbit.on(dev)
            counts, _, alive = _perturb_scan(
                zr[:n], zi[:n],
                torch.as_tensor(pre.astype(np.float64), device=dev),
                torch.as_tensor(pim.astype(np.float64), device=dev),
                max_iter=max_iter, add_dc=add_dc, stagnation=False)
            alive = alive.cpu().numpy()
        if alive.any():
            # Hop to the outliving probe nearest the view center.
            idx = np.argwhere(alive).ravel()
            best = idx[np.argmin(np.abs(pre[idx] + off_re)
                                 + np.abs(pim[idx] + off_im))]
        else:
            if not add_dc:
                break  # Julia: no deepening on an all-exterior lattice
            best = int(np.argmax(counts.cpu().numpy()))
        d_re, d_im = float(pre[best]), float(pim[best])
        za2 = za + _to_fixed(d_re, bits)
        zb2 = zb + _to_fixed(d_im, bits)
        ca2, cb2 = (za2, zb2) if add_dc else (ca, cb)
        hop = ORBITS.get(za2, zb2, ca2, cb2, max_iter, bits)
        if not alive.any() and hop.valid <= n:
            if li + 1 < len(lattices):
                li += 1  # densify and retry from the current best
                continue
            break  # depth gradient exhausted at the densest lattice
        za, zb, orbit = za2, zb2, hop
        off_re += d_re
        off_im += d_im
    return orbit.key, off_re, off_im


def _secondary_candidates(bad: np.ndarray, scanned: np.ndarray,
                          height: int, width: int) -> np.ndarray:
    """Order glitched pixels by how likely their exact orbit is to cover
    the full budget: scanned value 0 first (the pixel stayed bounded
    through the whole scan, however unreliably — 0 means in-set on both
    the integer and smooth planes), then deeper escape values, ties
    broken toward the view center (glitches cluster around the bounded
    structure causing them, so central pixels are likelier in-set)."""
    mid = np.array([(height - 1) / 2, (width - 1) / 2])
    center_dist = np.abs(bad - mid).sum(axis=1)
    return np.lexsort((center_dist, -scanned, scanned != 0))


def _fetch(values, glitched) -> tuple[np.ndarray, np.ndarray]:
    return values.cpu().numpy(), glitched.cpu().numpy()


@dataclass(frozen=True)
class _Route:
    """What the integer and the smooth route give
    :func:`_compute_perturb`: ``scan(zr, zi, dre, dim) -> (values,
    glitched)`` against a device orbit; ``repair_scan``, the same for
    the secondary pass; ``bla_scan(orbit, dc_max)``, a scan on the
    orbit's BLA table; and ``bla_offers(orbit, dc_max)``, which must
    also hold for the probe to take BLA (None: nothing more to ask)."""

    scan: Callable
    repair_scan: Callable
    bla_scan: Callable
    bla_offers: Callable | None = None


def _compute_perturb(spec: DeepTileSpec, max_iter: int, route: _Route, *,
                     dtype, prec_bits: int, max_glitch_fix: int | None,
                     julia_c: tuple[str, str] | None = None,
                     bla: bool | None = False,
                     device="cuda") -> tuple[np.ndarray, int]:
    """The shared perturbation route (the JAX package's): validates the span
    for the dtype, widens the orbit precision with depth, picks the
    reference, runs ``route.scan`` over row chunks on ``device``, and
    repairs glitched pixels: first against a secondary reference that
    covers the budget, then exactly in fixed point.

    ``julia_c`` switches to the Julia family (the deltas lose their dc
    term).  ``route.bla_scan`` takes the place of both scans where
    ``bla`` is True or the auto-probe (``bla=None``) enables it; the
    probe also asks ``route.bla_offers`` where the route has it (the
    smooth route's ``bla.smooth_table_skips``: a table that offers no
    skip at the view's deltas would run the exact steps in the BLA loop,
    one launch an operation, in place of one kernel).  Each view adds 1
    to the count ``deep.bla_views`` if it takes BLA, else 0.  The row
    chunks are the JAX package's (2^20 pixels in f32, 2^19 in f64): BLA
    decides its skips per chunk, so its output depends on them."""
    span_floor = 1e-30 if np.dtype(dtype) == np.float32 else 1e-290
    if spec.span < span_floor:
        raise ValueError(
            f"span {spec.span:g} below the {np.dtype(dtype).name} delta "
            f"floor ({span_floor:g}); use a wider dtype")
    dev = _device(device)
    # Orbit precision tracks depth (>= 64 bits below the pixel pitch),
    # quantized to 128-bit steps so nearby views share cached orbits.
    need = int(-np.log2(max(spec.step, 1e-300))) + 64
    bits = max(prec_bits, -(-need // 128) * 128)
    za = _to_fixed(spec.center_re, bits)
    zb = _to_fixed(spec.center_im, bits)
    if julia_c is None:
        ca, cb = za, zb
        add_dc = True
    else:
        ca = _to_fixed(julia_c[0], bits)
        cb = _to_fixed(julia_c[1], bits)
        add_dc = False
    with phases.timed(obs_names.PHASE_DEEP_REFERENCE):
        orbit, off_re, off_im = _find_reference(
            za, zb, ca, cb, spec.span, max_iter, bits, add_dc=add_dc,
            device=str(dev))
        # Deltas relative to the chosen reference, not the center: the
        # separable grid of DeepTileSpec.delta_grids as its column and
        # row vectors (the same values), broadcast without a copy.
        col, row = spec.offset(np.arange(spec.height), np.arange(spec.width))
        dre = np.broadcast_to(col - off_re, (spec.height, spec.width))
        dim = np.broadcast_to((row - off_im)[:, None],
                              (spec.height, spec.width))
        zr, zi = orbit.on(dev)
    # max(a_i^2 + b_j^2) = max a^2 + max b^2 (rounding is monotone).
    dc_max = float(np.sqrt(np.max(dre[0] * dre[0])
                           + np.max(dim[:, 0] * dim[:, 0])))
    use_bla = bla
    if use_bla is None:
        with phases.timed(obs_names.PHASE_DEEP_BLA_PROBE):
            use_bla = _auto_bla(orbit, dre, dim, max_iter, add_dc,
                                dtype=dtype, device=dev)
            if use_bla and route.bla_offers is not None and \
                    not route.bla_offers(orbit, dc_max):
                use_bla = False
                logger.info("BLA auto-disabled: the table offers no skip "
                            "at the view's deltas")
    phases.tally(obs_names.COUNT_DEEP_BLA_VIEWS, bool(use_bla))
    scan_fn = route.bla_scan(orbit, dc_max) if use_bla else route.scan
    limit = (1 << 20) if np.dtype(dtype) == np.float32 else (1 << 19)
    chunk = max(1, min(spec.height, limit // max(1, spec.width)))
    # The row and column vectors are uploaded and broadcast on the device.
    vals, glitches = [], []
    with phases.timed(obs_names.PHASE_DEEP_SCAN):
        dre_row = torch.as_tensor(dre[0].astype(dtype), device=dev)
        for r0 in range(0, spec.height, chunk):
            rows = min(chunk, spec.height - r0)
            dim_col = torch.as_tensor(dim[r0:r0 + chunk, 0].astype(dtype),
                                      device=dev)
            v_part, g_part = _fetch(*scan_fn(
                zr, zi, dre_row[None, :].expand(rows, spec.width),
                dim_col[:, None].expand(rows, spec.width)))
            vals.append(v_part)
            glitches.append(g_part)
    out = np.concatenate(vals).copy()
    glitched = np.concatenate(glitches)
    bad = np.argwhere(glitched)
    n_flagged = len(bad)
    phases.tally(obs_names.COUNT_DEEP_GLITCHED, n_flagged)
    if len(bad) > 1:
        # Secondary-reference pass: a glitched pixel whose exact orbit
        # covers the FULL budget becomes a second reference, and the
        # glitched pixels' deltas are re-scanned against it; candidates
        # in in-set-likelihood order, at most SECONDARY_REFERENCE_TRIES.
        with phases.timed(obs_names.PHASE_DEEP_REPAIR_SECONDARY):
            orbit2 = None
            for ci in _secondary_candidates(bad, out[bad[:, 0], bad[:, 1]],
                                            spec.height, spec.width)[
                                                :SECONDARY_REFERENCE_TRIES]:
                r2, c2 = bad[ci]
                d2_re, d2_im = spec.offset(r2, c2)
                pa = za + _to_fixed(float(d2_re), bits)
                pb = zb + _to_fixed(float(d2_im), bits)
                pc = (pa, pb) if julia_c is None else (ca, cb)
                candidate = ORBITS.get(pa, pb, *pc, max_iter, bits)
                if candidate.valid >= max_iter:
                    orbit2 = candidate
                    break
            if orbit2 is not None:
                # Deltas relative to the secondary reference (exact in
                # f64: index differences at pixel scale), padded to a
                # power-of-two length with far-exterior deltas as the
                # JAX package pads them.
                k = len(bad)
                k_pad = max(16, 1 << (k - 1).bit_length())
                dre2 = np.full(k_pad, 3.0)
                dim2 = np.zeros(k_pad)
                dre2[:k] = (bad[:, 1] - c2).astype(np.float64) * spec.step
                dim2[:k] = (bad[:, 0] - r2).astype(np.float64) * spec.step
                if use_bla:
                    dc2_max = float(np.sqrt(np.max(
                        dre2[:k] * dre2[:k] + dim2[:k] * dim2[:k])))
                    scan2 = route.bla_scan(orbit2, dc2_max)
                else:
                    scan2 = route.repair_scan
                v2, g2 = _fetch(*scan2(
                    *orbit2.on(dev),
                    torch.as_tensor(dre2.astype(dtype), device=dev),
                    torch.as_tensor(dim2.astype(dtype), device=dev)))
                v2 = v2[:k]
                g2 = g2[:k]
                fixed = bad[~g2]
                out[fixed[:, 0], fixed[:, 1]] = v2[~g2]
                bad = bad[g2]
    # The exact-repair remainder is capped at a quarter of the tile
    # (beyond it perturbation is not working for the view).
    cap = (max_glitch_fix if max_glitch_fix is not None
           else max(4096, (spec.width * spec.height) // 4))
    if len(bad) > cap:
        raise ValueError(
            f"{len(bad)} doubly-glitched pixels (> {cap}); "
            f"no reference orbit suits this view")
    # Exact per-pixel recompute in fixed point (the native kernel,
    # threaded, where available), center + delta formed in fixed point.
    # On the smooth plane this patches an integer count.
    if len(bad):
        with phases.timed(obs_names.PHASE_DEEP_REPAIR_EXACT,
                          annotate=True):
            d_re, d_im = spec.offset(bad[:, 0], bad[:, 1])
            pts = [(za + _to_fixed(a, bits), zb + _to_fixed(b, bits))
                   for a, b in zip(d_re.tolist(), d_im.tolist())]
            jc = None if julia_c is None else (ca, cb)
            out[bad[:, 0], bad[:, 1]] = _escape_counts_exact_batch(
                pts, max_iter, bits, jc)
        phases.tally(obs_names.COUNT_DEEP_EXACT_REPAIRED, len(bad))
    return out, n_flagged


def compute_counts_perturb(spec: DeepTileSpec, max_iter: int, *,
                           dtype=np.float32,
                           prec_bits: int = DEFAULT_PREC_BITS,
                           max_glitch_fix: int | None = None,
                           julia_c: tuple[str, str] | None = None,
                           bla: bool | None = None, device="cuda"
                           ) -> tuple[np.ndarray, int]:
    """Escape counts for a deep-zoom tile via perturbation -> ``(counts,
    n_glitched)``: int32 (height, width) counts in the reference
    convention, and how many pixels the primary reference flagged
    glitched (repaired by the secondary reference, else exactly).
    Raises if more than ``max_glitch_fix`` (default a quarter of the
    tile) stay glitched against both references.

    ``julia_c=(re, im)`` (decimal strings) renders the Julia set of that
    constant (the center then names a z-plane location).  ``bla``: True
    or False forces the bilinear-approximation scan (ops/bla.py), None
    probes the view (``_auto_bla``).  The deltas default to f32: the
    view's precision comes from the bigint reference orbit.  Runs on
    ``device`` (K9 on a CUDA device, its plain version on the CPU)."""
    if max_iter <= 1:
        return np.zeros((spec.height, spec.width), np.int32), 0
    add_dc = julia_c is None

    def scan(zr, zi, dre, dim, stagnation=True):
        return _perturb_scan(zr, zi, dre, dim, max_iter=max_iter,
                             add_dc=add_dc, stagnation=stagnation)[:2]

    # The secondary pass scans exactly the bounded lanes the stagnation
    # stop would re-flag: it runs without the stop.
    repair_scan = partial(scan, stagnation=False)

    def bla_scan(orbit, dc_max):
        from distributedmandelbrot_tpu_torch.ops import bla
        return bla.bla_scan_factory(orbit, dc_max, max_iter=max_iter,
                                    dtype=dtype, add_dc=add_dc)

    return _compute_perturb(spec, max_iter,
                            _Route(scan, repair_scan, bla_scan),
                            dtype=dtype, prec_bits=prec_bits,
                            max_glitch_fix=max_glitch_fix, julia_c=julia_c,
                            bla=bla, device=device)


def compute_tile_perturb(spec: DeepTileSpec, max_iter: int, *,
                         dtype=np.float32,
                         prec_bits: int = DEFAULT_PREC_BITS,
                         clamp: bool = False,
                         julia_c: tuple[str, str] | None = None,
                         device="cuda") -> np.ndarray:
    """Deep-zoom tile -> flat uint8 pixels (canonical scaling/order)."""
    from distributedmandelbrot_tpu_torch.ops.escape_time import (
        scale_counts_to_uint8)

    counts, _ = compute_counts_perturb(spec, max_iter, dtype=dtype,
                                       prec_bits=prec_bits,
                                       julia_c=julia_c, device=device)
    return scale_counts_to_uint8(torch.from_numpy(counts),
                                 max_iter=max_iter,
                                 clamp=clamp).numpy().ravel()


def compute_smooth_perturb(spec: DeepTileSpec, max_iter: int, *,
                           dtype=np.float32,
                           prec_bits: int = DEFAULT_PREC_BITS,
                           bailout: float = 256.0,
                           max_glitch_fix: int | None = None,
                           julia_c: tuple[str, str] | None = None,
                           bla: bool | None = None, device="cuda"
                           ) -> tuple[np.ndarray, int]:
    """Smooth (band-free) deep-zoom values via perturbation -> ``(nu,
    n_glitched)``: float (height, width) renormalized counts (0 =
    in-set).  Pixels glitched against both references are patched with
    their exact *integer* count.  ``bla`` as for
    :func:`compute_counts_perturb`, but BLA here skips only where the
    term it drops is below the delta dtype's rounding (``ops/bla.py``:
    the table's ``eps`` is the dtype's unit roundoff, its ``z_cap`` keeps
    every frozen value inside exact steps), and the probe also declines
    where that table offers no skip.  K10 on a CUDA device; the steps its lanes needed
    are added to the count ``deep.lane_steps`` and the orbit tiles it
    staged to ``deep.k10_tiles``, once a view."""
    if max_iter <= 1:
        return np.zeros((spec.height, spec.width), dtype), 0
    add_dc = julia_c is None
    lane_steps: list = []
    tiles: list = []

    def scan(zr, zi, dre, dim):
        return _perturb_scan_smooth(zr, zi, dre, dim, max_iter=max_iter,
                                    bailout=float(bailout), add_dc=add_dc,
                                    lane_steps=lane_steps, tiles=tiles)

    def bla_scan(orbit, dc_max):
        from distributedmandelbrot_tpu_torch.ops import bla
        return bla.bla_smooth_scan_factory(orbit, dc_max, max_iter=max_iter,
                                           bailout=float(bailout),
                                           dtype=dtype, add_dc=add_dc)

    def offers(orbit, dc_max):
        from distributedmandelbrot_tpu_torch.ops import bla
        return bla.smooth_table_skips(orbit, dc_max, bailout=float(bailout),
                                      dtype=dtype)

    out = _compute_perturb(spec, max_iter,
                           _Route(scan, scan, bla_scan, offers),
                           dtype=dtype, prec_bits=prec_bits,
                           max_glitch_fix=max_glitch_fix, julia_c=julia_c,
                           bla=bla, device=device)
    if lane_steps:
        # The view's one read of the sums, its planes long fetched.
        sums = [torch.stack(lane_steps).sum()]
        if tiles:
            sums.append(torch.stack(tiles).sum())
        read = torch.stack(sums).tolist()
        phases.tally(obs_names.COUNT_DEEP_LANE_STEPS, read[0])
        if tiles:
            phases.tally(obs_names.COUNT_DEEP_K10_TILES, read[1])
    return out
