"""PyTorch escape-time loops: the port of the JAX package's
``ops/escape_time.py`` — the integer loop for every recurrence family
(Mandelbrot, Julia, Multibrot, Burning Ship) and the smooth loop.

They are the fallback the CUDA kernels' callers take for tiles the
kernels decline (an unresolvable f32 pitch, an int32-overflowing
budget), the f64 quality path of ``render --smooth``, and the plain
PyTorch versions the hand-written kernels in ``ops/csrc`` are held
against, bit for bit, on the card.  They run on the caller's device (a
CUDA tensor stays on the card).

Pixel contract (``ops/reference.py``): z starts at c, iterations run
1..max_iter-1, the bailout ``|z|^2 >= 4`` is tested after the update,
0 means never escaped, and the byte is ``ceil(count*256/max_iter)`` with
the uint8 wrap (clamped at 255 only when asked).

The recurrence keeps the reference's cached-squares operation order,
with every operation a separate, correctly rounded PyTorch op, so
nothing is contracted into an FMA: in f64 the result is bit-identical to
the numpy golden, in f32 to the CUDA kernels (which use the ``_rn``
intrinsics for the same reason).

Where the JAX loop exits at tile granularity in unrolled segments, this
loop exits per pixel: it drops retired pixels from the working set every
:data:`COMPACT_EVERY` steps, which changes the work and never the
result (every per-pixel operation is elementwise and identical).
"""

from __future__ import annotations

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops.mxu_iteration import mxu_step

# Highest escape count whose exact uint8 scaling stays within int32:
# the scaled value is counts*256 + (mrd-1) with mrd <= counts+1, so the
# worst case is counts*257.  The kernels refuse budgets at or past it
# (their epilogue is int32); this loop scales in int64 and has no limit.
INT32_SCALE_LIMIT = (2**31 - 1) // 257 + 1  # 8,355,968

# Budgets at or above this arm the Brent cycle probe by default (the
# reference's policy, resolved from the tile's REQUESTED budget).
CYCLE_CHECK_MIN_ITER = 1024

# Steps between snapshot-equality checks of the cycle probe.
CYCLE_STRIDE = 8

# Strict-by-margin slack of the closed-form interior test, per dtype: a
# pixel that passes is mathematically interior (see the reference's
# INTERIOR_MARGIN note for the error analysis).
INTERIOR_MARGIN = {torch.float32: 1e-5, torch.float64: 1e-12}

# Steps between compactions of the working set.  Each compaction is one
# nonzero() (a host sync on the card), so it is kept coarse.
COMPACT_EVERY = 16


def resolve_cycle_check(cycle_check: bool | None, max_iter: int) -> bool:
    return (max_iter >= CYCLE_CHECK_MIN_ITER if cycle_check is None
            else cycle_check)


def probe_step(step: int) -> bool:
    """Does the cycle probe compare z with its snapshot after ``step``
    (1-based)?  Every :data:`CYCLE_STRIDE` steps.  The snapshot itself
    refreshes after the check at steps 2, 4, 8, ... (doubling gaps), so
    any exact-float cycle is caught once the gap passes its period.
    The CUDA kernels run this same per-pixel schedule."""
    return step % CYCLE_STRIDE == 0


def snapshot_step(step: int) -> bool:
    """Does the probe's snapshot refresh after ``step``?  At powers of
    two from 2 on."""
    return step >= 2 and step & (step - 1) == 0


def torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch or numpy spelling."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _margin(dtype: torch.dtype) -> float:
    try:
        return INTERIOR_MARGIN[dtype]
    except KeyError:
        raise ValueError(
            f"no validated interior margin for dtype {dtype}; "
            "f32/f64 are supported") from None


def mandelbrot_interior(c_real: torch.Tensor, c_imag: torch.Tensor,
                        margin: float | None = None) -> torch.Tensor:
    """Pixels provably inside the main cardioid or the period-2 bulb, by
    closed form, strict by ``margin``.  The expressions and their order
    are the reference's: ``q = (x-1/4)^2 + y^2``, cardioid iff
    ``q(q + x - 1/4) < y^2/4 - margin``; bulb iff
    ``(x+1)^2 + y^2 < 1/16 - margin``.  Constants are 0-d tensors of the
    input dtype, so every operation rounds in that dtype."""
    dtype = c_real.dtype
    dev = c_real.device
    m = torch.tensor(_margin(dtype) if margin is None else margin,
                     dtype=dtype, device=dev)
    quarter = torch.tensor(0.25, dtype=dtype, device=dev)
    one = torch.tensor(1.0, dtype=dtype, device=dev)
    sixteenth = torch.tensor(0.0625, dtype=dtype, device=dev)
    y2 = c_imag * c_imag
    xm = c_real - quarter
    q = xm * xm + y2
    cardioid = q * (q + xm) < quarter * y2 - m
    xp = c_real + one
    bulb = xp * xp + y2 < sixteenth - m
    return cardioid | bulb


def multibrot_interior_radius(power: int) -> float:
    """Radius of the disk centred at 0 inscribed in the degree-``power``
    Multibrot's period-1 component, ``(d-1) d^(-d/(d-1))``: every c in
    it has an attracting fixed point and never escapes."""
    d = float(power)
    return (d - 1.0) * d ** (-d / (d - 1.0))


def multibrot_interior(c_real: torch.Tensor, c_imag: torch.Tensor,
                       power: int, margin: float | None = None
                       ) -> torch.Tensor:
    """The inscribed disk of :func:`multibrot_interior_radius`, strict by
    the per-dtype margin: ``cr*cr + ci*ci < r^2 - margin``, the limit
    computed in f64 and rounded once to the input dtype."""
    dtype = c_real.dtype
    if margin is None:
        margin = _margin(dtype)
    r = multibrot_interior_radius(power)
    lim = torch.tensor(r * r - margin, dtype=dtype, device=c_real.device)
    return c_real * c_real + c_imag * c_imag < lim


def family_interior(c_real: torch.Tensor, c_imag: torch.Tensor,
                    power: int = 2, burning: bool = False
                    ) -> torch.Tensor | None:
    """The proven-interior mask of a recurrence family, or None where no
    closed form is known (the Burning Ship): cardioid and period-2 bulb
    at degree 2, the inscribed period-1 disk above."""
    if burning:
        return None
    if power == 2:
        return mandelbrot_interior(c_real, c_imag)
    return multibrot_interior(c_real, c_imag, power)


def family_step(zr: torch.Tensor, zi: torch.Tensor, c_real: torch.Tensor,
                c_imag: torch.Tensor, *, power: int, burning: bool):
    """One update ``z <- z^power + c``, through the Burning Ship's fold
    ``|Re z| + i|Im z|`` first when ``burning``.  The operation order is
    the reference's: ``zr*zr - zi*zi + cr, (zr+zr)*zi + ci`` at degree 2,
    else ``d - 1`` products ``wr*zr - wi*zi, wr*zi + wi*zr`` then ``+ c``."""
    if burning:
        zr = zr.abs()
        zi = zi.abs()
    if power == 2:
        return zr * zr - zi * zi + c_real, (zr + zr) * zi + c_imag
    wr, wi = zr, zi
    for _ in range(power - 1):
        wr, wi = wr * zr - wi * zi, wr * zi + wi * zr
    return wr + c_real, wi + c_imag


def escape_loop(zr0: torch.Tensor, zi0: torch.Tensor, c_real: torch.Tensor,
                c_imag: torch.Tensor, *, total_steps: int,
                interior: torch.Tensor | None = None,
                cycle_check: bool = False, power: int = 2,
                burning: bool = False, use_mxu: bool = False,
                return_steps: bool = False):
    """Survived-update count ``n`` per pixel (int32, the input's shape):
    a pixel escaping at step ``e`` has ``n = e - 1``; a pixel that never
    escapes within ``total_steps`` (interior-proven, cycle-detected, or
    budget-exhausted) has ``n = total_steps``.  The port of both
    ``escape_loop`` and ``escape_loop_generic`` of the reference: z
    starts at ``zr0, zi0`` (the grid), c is ``c_real, c_imag`` (the grid,
    or a Julia constant broadcast to it).

    Per step, in this order: the update — at degree 2 the cached-squares
    form ``cross = (zr+zr)*zi; zi = cross + ci; zr = (zr2 - zi2) + cr``
    (the Burning Ship takes ``|cross|``, the same bits as folding z
    first: squares and the doubling are sign-blind), above it
    :func:`family_step`, and with ``use_mxu`` (degree 2, no fold) the
    matrix form :func:`~.mxu_iteration.mxu_step` (K8's plain version) —
    then ``zr2 = zr*zr; zi2 = zi*zi``; retire when
    ``!(zr2 + zi2 < 4)``; the cycle probe (:func:`probe_step`,
    :func:`snapshot_step`); count the survivors.  ``return_steps`` also
    returns the steps each pixel ran (0 for interior pixels) — the work
    the inputs need, for roofline bounds."""
    if use_mxu and (power != 2 or burning):
        raise ValueError("the matrix form is the degree-2 recurrence "
                         "without the Burning Ship's fold")
    shape = zr0.shape
    dev = zr0.device
    n_out = torch.zeros(shape, dtype=torch.int32, device=dev).reshape(-1)
    steps_out = torch.zeros_like(n_out) if return_steps else None
    if interior is not None:
        n_out.masked_fill_(interior.reshape(-1), total_steps)
        idx = torch.nonzero(~interior.reshape(-1)).squeeze(1)
    else:
        idx = torch.arange(n_out.numel(), device=dev)
    zr = zr0.reshape(-1)[idx]
    zi = zi0.reshape(-1)[idx]
    cr = c_real.reshape(-1)[idx]
    ci = c_imag.reshape(-1)[idx]
    zr2 = zr * zr
    zi2 = zi * zi
    four = torch.tensor(4.0, dtype=zr.dtype, device=dev)
    act = torch.ones(idx.shape, dtype=torch.bool, device=dev)
    n = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
    done_at = torch.zeros_like(n) if return_steps else None
    szr, szi = (zr.clone(), zi.clone()) if cycle_check else (None, None)
    # Scratch for the in-place step (the working set is updated in place
    # to keep a 4096^2 tile from allocating a dozen planes per step).
    tmp = torch.empty_like(zr)
    hit = torch.empty_like(act)

    def flush():
        n_out[idx] = n
        if return_steps:
            steps_out[idx] = torch.where(act, step, done_at)

    step = 0
    for step in range(1, total_steps + 1):
        if idx.numel() == 0:
            break
        if use_mxu:
            zr, zi = mxu_step(zr, zi, cr, ci)
        elif power == 2:
            # cross = (zr + zr) * zi; zi = cross + ci; zr = (zr2 - zi2) + cr
            torch.add(zr, zr, out=tmp).mul_(zi)
            if burning:
                tmp.abs_()
            tmp.add_(ci)
            torch.sub(zr2, zi2, out=zr).add_(cr)
            zi, tmp = tmp, zi
        else:
            zr, zi = family_step(zr, zi, cr, ci, power=power, burning=False)
        torch.mul(zr, zr, out=zr2)
        torch.mul(zi, zi, out=zi2)
        was = act.clone() if return_steps else None
        act &= torch.lt(torch.add(zr2, zi2, out=tmp), four, out=hit)
        if cycle_check and probe_step(step):
            cyc = act & (zr == szr) & (zi == szi)
            act &= ~cyc
            n.masked_fill_(cyc, total_steps)
        n += act
        if return_steps:
            done_at.masked_fill_(was & ~act, step)
        if cycle_check and snapshot_step(step):
            szr.copy_(zr)
            szi.copy_(zi)
        if step % COMPACT_EVERY == 0 or step == total_steps:
            flush()
            keep = torch.nonzero(act).squeeze(1)
            idx, act, n = idx[keep], act[keep], n[keep]
            zr, zi, zr2, zi2 = zr[keep], zi[keep], zr2[keep], zi2[keep]
            cr, ci = cr[keep], ci[keep]
            tmp, hit = torch.empty_like(zr), torch.empty_like(act)
            if return_steps:
                done_at = done_at[keep]
            if cycle_check:
                szr, szi = szr[keep], szi[keep]
    flush()
    n_out = n_out.reshape(shape)
    if return_steps:
        return n_out, steps_out.reshape(shape)
    return n_out


def counts_from_survival(n: torch.Tensor, total_steps: int) -> torch.Tensor:
    """Escape counts from the survived count: ``n >= total_steps`` means
    never escaped within budget -> 0, otherwise ``n + 1``."""
    return torch.where(n >= total_steps, 0, n + 1).to(torch.int32)


def escape_counts(c_real: torch.Tensor, c_imag: torch.Tensor, *,
                  max_iter: int, interior_check: bool = True,
                  cycle_check: bool | None = None) -> torch.Tensor:
    """Escape iteration (int32) per element; 0 if never escaped.  The
    interior shortcut and the cycle probe (None = on for deep budgets)
    change the work, never the output."""
    total_steps = max_iter - 1
    if total_steps <= 0:
        return torch.zeros(c_real.shape, dtype=torch.int32,
                           device=c_real.device)
    interior = (mandelbrot_interior(c_real, c_imag) if interior_check
                else None)
    n = escape_loop(c_real, c_imag, c_real, c_imag, total_steps=total_steps,
                    interior=interior,
                    cycle_check=resolve_cycle_check(cycle_check, max_iter))
    return counts_from_survival(n, total_steps)


def scale_counts_to_uint8(counts: torch.Tensor, *, max_iter: int,
                          clamp: bool = False) -> torch.Tensor:
    """uint8 encoding ``ceil(v*256/max_iter)`` as the exact integer
    ceil-division ``(v*256 + max_iter - 1) // max_iter`` in int64, then
    the uint8 wrap (``& 255``) or the clamp at 255."""
    vals = (counts.to(torch.int64) * 256 + (max_iter - 1)) // max_iter
    if clamp:
        vals = torch.clamp(vals, max=255)
    return (vals & 255).to(torch.uint8)


def spec_grid(spec: TileSpec, dtype, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The (height, width) host-convention grid of ``spec`` on
    ``device``: the reference's f64 ``np.linspace`` axes, each cast once
    to ``dtype`` and broadcast (the same values as casting
    ``spec.grid_2d()``, without shipping a full f64 plane)."""
    dtype = torch_dtype(dtype)
    re, im = spec.axes()
    re_t = torch.as_tensor(re, dtype=torch.float64).to(dtype).to(device)
    im_t = torch.as_tensor(im, dtype=torch.float64).to(dtype).to(device)
    return (re_t[None, :].expand(spec.height, spec.width),
            im_t[:, None].expand(spec.height, spec.width))


def compute_tile_device(spec: TileSpec, max_iter: int, *,
                        dtype=torch.float32, clamp: bool = False,
                        device="cuda", interior_check: bool = True,
                        cycle_check: bool | None = None) -> torch.Tensor:
    """One tile -> (height, width) uint8 tensor on ``device``."""
    c_real, c_imag = spec_grid(spec, dtype, device)
    counts = escape_counts(c_real, c_imag, max_iter=max_iter,
                           interior_check=interior_check,
                           cycle_check=cycle_check)
    return scale_counts_to_uint8(counts, max_iter=max_iter, clamp=clamp)


def compute_tile(spec: TileSpec, max_iter: int, *, dtype=torch.float32,
                 clamp: bool = False, device="cuda",
                 interior_check: bool = True,
                 cycle_check: bool | None = None) -> np.ndarray:
    """One tile end to end -> flat uint8 numpy array, real-fastest.
    The float64 path is bit-identical to the numpy golden; runs on the
    card unless ``device`` says otherwise."""
    out = compute_tile_device(spec, max_iter, dtype=dtype, clamp=clamp,
                              device=device, interior_check=interior_check,
                              cycle_check=cycle_check)
    return out.cpu().numpy().reshape(-1)


def _julia_constant(c: complex, like: torch.Tensor) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """A Julia constant as two planes shaped like ``like``, each part
    rounded once to its dtype."""
    c = complex(c)
    return (torch.full(like.shape, c.real, dtype=like.dtype,
                       device=like.device),
            torch.full(like.shape, c.imag, dtype=like.dtype,
                       device=like.device))


def escape_counts_julia(z_real: torch.Tensor, z_imag: torch.Tensor,
                        c: complex, *, max_iter: int,
                        cycle_check: bool | None = None) -> torch.Tensor:
    """Julia-set escape counts (int32): z starts at the pixel, ``c`` is
    the constant.  No closed-form interior exists; the cycle probe (None
    = on for deep budgets) still retires attracting orbits."""
    total_steps = max_iter - 1
    if total_steps <= 0:
        return torch.zeros(z_real.shape, dtype=torch.int32,
                           device=z_real.device)
    cr, ci = _julia_constant(c, z_real)
    n = escape_loop(z_real, z_imag, cr, ci, total_steps=total_steps,
                    cycle_check=resolve_cycle_check(cycle_check, max_iter))
    return counts_from_survival(n, total_steps)


def compute_tile_julia(spec: TileSpec, c: complex, max_iter: int, *,
                       dtype=torch.float32, clamp: bool = False,
                       device="cuda") -> np.ndarray:
    """One Julia tile end to end -> flat uint8 numpy array."""
    z_real, z_imag = spec_grid(spec, dtype, device)
    counts = escape_counts_julia(z_real, z_imag, c, max_iter=max_iter)
    return scale_counts_to_uint8(counts, max_iter=max_iter,
                                 clamp=clamp).cpu().numpy().reshape(-1)


# --- smooth (band-free) values ------------------------------------------

# The reference XLA loop's segment.  The smooth loop's step limit is
# defined by whole segments of it (see segment_steps).
DEFAULT_SEGMENT = 32


def smooth_extra_steps(bailout: float) -> int:
    """Steps the smooth loop may run past the budget, so that orbits
    crossing radius 2 in the last iterations still reach the smoothing
    radius."""
    return 8 + int(np.ceil(np.log2(np.log2(max(bailout, 4.0)))))


def segment_steps(bound: int, segment: int) -> int:
    """Steps taken by a loop that runs whole ``segment``-step segments
    while its step count is within ``bound``: ``segment * ceil(bound /
    segment)``.  The reference's smooth loops run so, and a pixel still
    live at their end (hovering between radius 2 and the bailout) gets
    ``nu = n + 2`` with ``n`` that count, so the port stops exactly
    there too, although it exits per pixel."""
    return segment * -(-bound // segment)


def escape_smooth_loop(zr0: torch.Tensor, zi0: torch.Tensor,
                       c_real: torch.Tensor, c_imag: torch.Tensor, *,
                       total_steps: int, step_limit: int, bailout: float,
                       interior: torch.Tensor | None = None,
                       cycle_check: bool = False, power: int = 2,
                       burning: bool = False, return_steps: bool = False):
    """The smooth loop's per-pixel state after at most ``step_limit``
    steps: ``(n, n2, zr, zi)``, the input's shape.

    Per step, in this order: :func:`family_step` on the live pixels
    (the others keep their z: an orbit freezes at its first crossing of
    radius ``bailout``, and that z is the smoothing payload); ``m2 =
    zr*zr + zi*zi``; the bailout mask clears when ``!(m2 < bailout^2)``
    and ``n`` counts its survivors; the sticky radius-2 mask clears when
    ``!(m2 < 4)`` and, after the cycle probe (which saturates ``n2`` at
    ``total_steps`` and retires the orbit), ``n2`` counts its survivors.
    ``n2`` owns the in-set decision, exactly as the integer loop's count.
    Proven-interior pixels never iterate and start with ``n2 =
    total_steps``.  ``return_steps`` adds the steps each pixel ran."""
    if bailout < 2.0:
        raise ValueError(f"bailout must be >= 2 (the escape radius), got "
                         f"{bailout}")
    shape = zr0.shape
    dev = zr0.device
    zr_out = zr0.reshape(-1).clone()
    zi_out = zi0.reshape(-1).clone()
    n_out = torch.zeros(zr_out.shape, dtype=torch.int32, device=dev)
    n2_out = torch.zeros_like(n_out)
    steps_out = torch.zeros_like(n_out) if return_steps else None
    if interior is not None:
        n2_out.masked_fill_(interior.reshape(-1), total_steps)
        idx = torch.nonzero(~interior.reshape(-1)).squeeze(1)
    else:
        idx = torch.arange(n_out.numel(), device=dev)
    zr, zi = zr_out[idx], zi_out[idx]
    cr, ci = c_real.reshape(-1)[idx], c_imag.reshape(-1)[idx]
    b2 = torch.tensor(bailout * bailout, dtype=zr.dtype, device=dev)
    four = torch.tensor(4.0, dtype=zr.dtype, device=dev)
    act = torch.ones(idx.shape, dtype=torch.bool, device=dev)
    act2 = torch.ones_like(act)
    n = torch.zeros(idx.shape, dtype=torch.int32, device=dev)
    n2 = torch.zeros_like(n)
    done_at = torch.zeros_like(n) if return_steps else None
    szr, szi = (zr.clone(), zi.clone()) if cycle_check else (None, None)

    def flush():
        zr_out[idx], zi_out[idx] = zr, zi
        n_out[idx], n2_out[idx] = n, n2
        if return_steps:
            steps_out[idx] = torch.where(act, step, done_at)

    step = 0
    for step in range(1, step_limit + 1):
        if idx.numel() == 0:
            break
        nzr, nzi = family_step(zr, zi, cr, ci, power=power, burning=burning)
        zr = torch.where(act, nzr, zr)
        zi = torch.where(act, nzi, zi)
        m2 = zr * zr + zi * zi
        was = act.clone() if return_steps else None
        act &= m2 < b2
        n += act
        act2 &= m2 < four
        if cycle_check and probe_step(step):
            cyc = act2 & (zr == szr) & (zi == szi)
            act2 &= ~cyc
            act &= ~cyc
            n2 += cyc.to(torch.int32) * total_steps
        n2 += act2
        if return_steps:
            done_at.masked_fill_(was & ~act, step)
        if cycle_check and snapshot_step(step):
            szr, szi = zr.clone(), zi.clone()
        if step % COMPACT_EVERY == 0 or step == step_limit:
            flush()
            keep = torch.nonzero(act).squeeze(1)
            idx, act, act2 = idx[keep], act[keep], act2[keep]
            n, n2, zr, zi = n[keep], n2[keep], zr[keep], zi[keep]
            cr, ci = cr[keep], ci[keep]
            if return_steps:
                done_at = done_at[keep]
            if cycle_check:
                szr, szi = szr[keep], szi[keep]
    flush()
    out = tuple(t.reshape(shape) for t in (n_out, n2_out, zr_out, zi_out))
    return out + (steps_out.reshape(shape),) if return_steps else out


def smooth_nu(n: torch.Tensor, n2: torch.Tensor, zr: torch.Tensor,
              zi: torch.Tensor, *, total_steps: int, bailout: float,
              power: int = 2) -> torch.Tensor:
    """The smooth value from the loop's state: ``nu = (n + 2) -
    log2(log|z|^2 / (2 ln bailout))``, divided by ``log2(power)`` above
    degree 2; 0 where ``n2 >= total_steps`` (in the set).  |z|^2 is
    sanitised as the reference does, in this order: NaN and +inf to the
    dtype's max, then clipped to ``[bailout^2, max]`` (orbits that never
    reached the bailout get ``nu = n + 2``; high degrees overflow).  The
    divisors are 0-d tensors on the device: a division by a Python
    scalar would multiply by its reciprocal on the card."""
    dtype, dev = zr.dtype, zr.device
    big = torch.finfo(dtype).max
    b2 = torch.tensor(bailout * bailout, dtype=dtype, device=dev)
    mag2 = torch.nan_to_num(zr * zr + zi * zi, nan=big, posinf=big)
    mag2 = torch.minimum(torch.maximum(mag2, b2),
                         torch.tensor(big, dtype=dtype, device=dev))
    two_ln_b = torch.tensor(2.0 * np.log(bailout), dtype=dtype, device=dev)
    corr = torch.log2(torch.log(mag2) / two_ln_b)
    if power != 2:
        corr = corr / torch.tensor(np.log2(power), dtype=dtype, device=dev)
    nu = (n + 2).to(dtype) - corr
    return torch.where(n2 >= total_steps, torch.zeros((), dtype=dtype,
                                                      device=dev), nu)


def _escape_smooth(zr0, zi0, c_real, c_imag, *, max_iter: int,
                   segment: int, bailout: float, interior_check: bool,
                   cycle_check: bool, power: int, burning: bool):
    """The port of the reference's ``_escape_smooth_jit``: the smooth
    loop, stopped after whole segments of ``segment`` steps as the
    reference's segmented while-loop stops."""
    total_steps = max_iter - 1
    if total_steps <= 0:
        return torch.zeros(zr0.shape, dtype=zr0.dtype, device=zr0.device)
    bound = total_steps + smooth_extra_steps(bailout)
    interior = (family_interior(c_real, c_imag, power, burning)
                if interior_check else None)
    n, n2, zr, zi = escape_smooth_loop(
        zr0, zi0, c_real, c_imag, total_steps=total_steps,
        step_limit=segment_steps(bound, max(1, min(segment, bound))),
        bailout=bailout, interior=interior, cycle_check=cycle_check,
        power=power, burning=burning)
    return smooth_nu(n, n2, zr, zi, total_steps=total_steps, bailout=bailout,
                     power=power)


def escape_smooth(c_real: torch.Tensor, c_imag: torch.Tensor, *,
                  max_iter: int, segment: int = DEFAULT_SEGMENT,
                  bailout: float = 256.0, interior_check: bool = True,
                  cycle_check: bool | None = None) -> torch.Tensor:
    """Smooth value per element in the input dtype; 0 if never escaped
    (in-set classification equals :func:`escape_counts`)."""
    return _escape_smooth(c_real, c_imag, c_real, c_imag, max_iter=max_iter,
                          segment=segment, bailout=float(bailout),
                          interior_check=interior_check,
                          cycle_check=resolve_cycle_check(cycle_check,
                                                          max_iter),
                          power=2, burning=False)


def escape_smooth_julia(z_real: torch.Tensor, z_imag: torch.Tensor,
                        c: complex, *, max_iter: int,
                        segment: int = DEFAULT_SEGMENT,
                        bailout: float = 256.0,
                        cycle_check: bool | None = None) -> torch.Tensor:
    """Smooth values for the Julia set of ``c`` (no interior shortcut)."""
    cr, ci = _julia_constant(c, z_real)
    return _escape_smooth(z_real, z_imag, cr, ci, max_iter=max_iter,
                          segment=segment, bailout=float(bailout),
                          interior_check=False,
                          cycle_check=resolve_cycle_check(cycle_check,
                                                          max_iter),
                          power=2, burning=False)


def compute_tile_smooth(spec: TileSpec, max_iter: int, *,
                        dtype=torch.float64, segment: int = DEFAULT_SEGMENT,
                        bailout: float = 256.0,
                        julia_c: complex | None = None,
                        cycle_check: bool | None = None,
                        device="cuda") -> np.ndarray:
    """One tile through the smooth loop -> (height, width) float numpy
    array (f64 by default: the quality path); the Julia set of
    ``julia_c`` when it is given."""
    g_real, g_imag = spec_grid(spec, dtype, device)
    if julia_c is None:
        nu = escape_smooth(g_real, g_imag, max_iter=max_iter,
                           segment=segment, bailout=bailout,
                           cycle_check=cycle_check)
    else:
        nu = escape_smooth_julia(g_real, g_imag, julia_c, max_iter=max_iter,
                                 segment=segment, bailout=bailout,
                                 cycle_check=cycle_check)
    return nu.cpu().numpy()
