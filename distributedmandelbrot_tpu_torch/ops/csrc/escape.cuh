// Per-pixel escape-time arithmetic shared by every kernel of
// escape_kernels.cu: one copy of the grid, the interior tests, the
// recurrence of each family, the cycle probe, the epilogue and the bf16
// scout, so the single-tile, fused, packed and smooth kernels are
// bit-identical where they compute the same thing, by construction.
//
// Every f32 operation is a correctly rounded _rn intrinsic: nothing is
// contracted into an FMA, which keeps the reference's operation order
// (ops/reference.py) and makes each kernel bitwise equal to its plain
// PyTorch version (PyTorch's elementwise ops never contract across
// ops).  The library is also built with --fmad=false.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#define DM_D __device__ __forceinline__

namespace dm {

// Steps between the cycle probe's snapshot-equality checks
// (escape_time.CYCLE_STRIDE).
constexpr int kCycleStride = 8;
// Interior-test margin for f32 (escape_time.INTERIOR_MARGIN).
constexpr float kInteriorMargin = 1e-5f;

// The recurrence families (escape_time.family_step): z^2 + c
// (Mandelbrot and Julia), the Burning Ship, and z^d + c for d > 2.
enum Family : int { kQuadratic = 0, kShip = 1, kMultibrot = 2 };

// The proven-interior tests (escape_time.family_interior): none (Julia,
// the Burning Ship, or the shortcut off), the cardioid and period-2
// bulb at degree 2, the inscribed disk above.
enum Interior : int { kNoInterior = 0, kCardioidBulb = 1, kDisk = 2 };

DM_D float fmul(float a, float b) { return __fmul_rn(a, b); }
DM_D float fadd(float a, float b) { return __fadd_rn(a, b); }
DM_D float fsub(float a, float b) { return __fsub_rn(a, b); }

// The in-kernel grid: start + (float)index * step, in f32.
DM_D float grid(float start, float step, int index) {
  return fadd(start, fmul(static_cast<float>(index), step));
}

// Proven inside the main cardioid or the period-2 bulb, strict by the
// margin, with mandelbrot_interior's expressions in its own order.
DM_D bool interior(float cr, float ci) {
  const float y2 = fmul(ci, ci);
  const float xm = fsub(cr, 0.25f);
  const float q = fadd(fmul(xm, xm), y2);
  const bool cardioid =
      fmul(q, fadd(q, xm)) < fsub(fmul(0.25f, y2), kInteriorMargin);
  const float xp = fadd(cr, 1.0f);
  const bool bulb = fadd(fmul(xp, xp), y2) < fsub(0.0625f, kInteriorMargin);
  return cardioid || bulb;
}

// ``mode`` of the Interior enum; ``disk_lim`` is multibrot_interior's
// f32 limit r^2 - margin, rounded once on the host.
DM_D bool proven_interior(int mode, float cr, float ci, float disk_lim) {
  if (mode == kCardioidBulb) return interior(cr, ci);
  if (mode == kDisk) return fadd(fmul(cr, cr), fmul(ci, ci)) < disk_lim;
  return false;
}

// One update of z, with its cached squares zr2 = zr*zr, zi2 = zi*zi,
// in family_step's operation order.  Degree 2 takes the cached-squares
// form; the Burning Ship's fold is |cross| there (squares and the
// doubling are sign-blind, so it equals folding z first, bit for bit).
//
// MXU (K8, mxu_iteration.mxu_step; degree 2 without the fold only) is
// the 2x2 rotation-matrix form written out: sr = zr*zr + (-zi)*zi,
// si = zi*zr + zr*zi, then + c, every product and sum rounded on its
// own.  It differs from the cached-squares form only where zr + zr
// overflows or zr*zi is subnormal; the parity probe (dm_mxu_probe)
// decides whether a device runs it.
template <int F, bool MXU = false>
DM_D void update(float& zr, float& zi, float& zr2, float& zi2, float cr,
                 float ci, int power) {
  static_assert(!MXU || F == kQuadratic,
                "the matrix form is the degree-2 recurrence without a fold");
  if (MXU) {
    const float sr = fadd(fmul(zr, zr), fmul(-zi, zi));
    const float si = fadd(fmul(zi, zr), fmul(zr, zi));
    zr = fadd(sr, cr);
    zi = fadd(si, ci);
  } else if (F == kMultibrot) {
    float wr = zr, wi = zi;
    for (int k = 1; k < power; ++k) {
      const float nr = fsub(fmul(wr, zr), fmul(wi, zi));
      const float ni = fadd(fmul(wr, zi), fmul(wi, zr));
      wr = nr;
      wi = ni;
    }
    zr = fadd(wr, cr);
    zi = fadd(wi, ci);
  } else {
    float cross = fmul(fadd(zr, zr), zi);
    if (F == kShip) cross = fabsf(cross);
    zi = fadd(cross, ci);
    zr = fadd(fsub(zr2, zi2), cr);
  }
  zr2 = fmul(zr, zr);
  zi2 = fmul(zi, zi);
}

// Does the cycle probe's snapshot refresh after step s?  At powers of
// two from 2 on (escape_time.snapshot_step).
DM_D bool snapshot_step(int s) { return s >= 2 && (s & (s - 1)) == 0; }

// One orbit of the integer loop: z, its squares, c, the probe's
// snapshot, and n, the updates survived so far.
struct Orbit {
  float zr, zi, zr2, zi2, cr, ci, szr, szi;
  int n;
};

DM_D void start(Orbit& o, float zr0, float zi0, float cr, float ci) {
  o.zr = zr0;
  o.zi = zi0;
  o.zr2 = fmul(zr0, zr0);
  o.zi2 = fmul(zi0, zi0);
  o.cr = cr;
  o.ci = ci;
  o.szr = zr0;
  o.szi = zi0;
  o.n = 0;
}

// Step s (1-based) of a live orbit; returns whether it stays live.  An
// orbit leaving the radius-2 disk retires with n as it is; an exact
// repeat of the snapshot (the Brent probe, checked every kCycleStride
// steps) can never escape and retires with n = dyn, which is
// output-identical to running out the budget.
template <int F, bool MXU = false>
DM_D bool advance(Orbit& o, int s, int dyn, bool cycle_check, int power) {
  update<F, MXU>(o.zr, o.zi, o.zr2, o.zi2, o.cr, o.ci, power);
  if (!(fadd(o.zr2, o.zi2) < 4.0f)) return false;
  if (cycle_check) {
    if ((s % kCycleStride) == 0 && o.zr == o.szr && o.zi == o.szi) {
      o.n = dyn;
      return false;
    }
    if (snapshot_step(s)) {
      o.szr = o.zr;
      o.szi = o.zi;
    }
  }
  ++o.n;
  return true;
}

// One group of kCycleStride steps, s + 1 .. s + kCycleStride, of an
// orbit live after its own step s (a multiple of kCycleStride, so n ==
// s): the form K1 and K2 run, equal to kCycleStride calls of advance()
// on every output.  Inside the group each step is the update, the
// radius-2 compare and a predicated count: a lane that escapes keeps
// stepping (z may run on to inf or NaN) with n frozen at e - 1.  Once
// per group, at the pixel's own step s + kCycleStride (a multiple of
// kCycleStride, so the probe's step): the budget, the probe, and the
// snapshot refresh at a power of two.  The refreshes at steps 2 and 4
// fall inside the first group; only step 4's is ever compared (at 8),
// so the first group keeps z at its fourth step.  A budget that ends
// inside the group clamps n to dyn: a pixel live at step dyn has
// survived at least dyn steps by then, and one that escaped earlier has
// n < dyn; a cycle found at or past dyn would give n = dyn all the same.
// After steps 2 and 4 the group ends early when no lane stepping with
// this one is live (a sky of pixels escaping in a step or two then
// costs a quarter of a group): the skipped steps would only have moved
// retired orbits.  Returns whether the orbit is still live; on false,
// n is final.
template <int F, bool MXU = false>
DM_D bool step_group(Orbit& o, int s, int dyn, bool cycle_check, int power) {
  const bool first = s == 0;
  bool live = true;
#pragma unroll
  for (int k = 1; k <= kCycleStride; ++k) {
    update<F, MXU>(o.zr, o.zi, o.zr2, o.zi2, o.cr, o.ci, power);
    live = live && fadd(o.zr2, o.zi2) < 4.0f;
    o.n += live ? 1 : 0;
    if (k == kCycleStride / 2 && first) {
      o.szr = o.zr;
      o.szi = o.zi;
    }
    if ((k == 2 || k == 4) && !__any_sync(__activemask(), live)) break;
  }
  const int end = s + kCycleStride;
  if (end >= dyn) {
    if (o.n > dyn) o.n = dyn;
    return false;
  }
  if (!live) return false;
  if (cycle_check) {
    if (o.zr == o.szr && o.zi == o.szi) {
      o.n = dyn;
      return false;
    }
    if (snapshot_step(end)) {
      o.szr = o.zr;
      o.szi = o.zi;
    }
  }
  return true;
}

// One group of the resume loop (K7): steps s + 1 .. min(s +
// kCycleStride, last) of a lane live after its own step s (any s: the
// probe is off, so nothing needs s to be a multiple of kCycleStride), in
// a round that ends at step ``last`` <= dyn.  Each step is the update and
// the radius-2 compare; a lane that leaves the disk exits the group at
// once, so z and n stop at its escape step, as the plain loop's do (the
// warp's other lanes step on without it).  A group that would pass
// ``last`` runs single steps to it.  Returns 1 while the lane steps on, 0
// once its round is over with the orbit inside radius 2 (s == last), -1
// once it left the disk.
template <int F>
DM_D int resume_group(Orbit& o, int& s, int last, int power) {
  const int left = last - s;
  if (left >= kCycleStride) {
#pragma unroll
    for (int k = 1; k <= kCycleStride; ++k) {
      update<F>(o.zr, o.zi, o.zr2, o.zi2, o.cr, o.ci, power);
      if (!(fadd(o.zr2, o.zi2) < 4.0f)) {
        o.n += k - 1;
        return -1;
      }
    }
    o.n += kCycleStride;
    s += kCycleStride;
    return s < last ? 1 : 0;
  }
  for (int k = 1; k <= left; ++k) {
    update<F>(o.zr, o.zi, o.zr2, o.zi2, o.cr, o.ci, power);
    if (!(fadd(o.zr2, o.zi2) < 4.0f)) {
      o.n += k - 1;
      return -1;
    }
  }
  o.n += left;
  s = last;
  return 0;
}

// One orbit of the smooth loop (K4): z, its squares, c and the probe's
// snapshot in ``o``, where o.n counts the steps inside the bailout; the
// sticky radius-2 flag and its count n2 (plus dyn once the probe finds a
// cycle), which own the in-set decision; and mag2, |z|^2 at the pixel's
// last step (its bailout crossing, or the step limit), the smoothing
// payload.
struct SmoothOrbit {
  Orbit o;
  int n2;
  float mag2;
  bool in2;
};

DM_D void start(SmoothOrbit& p, float zr0, float zi0, float cr, float ci) {
  start(p.o, zr0, zi0, cr, ci);
  p.n2 = 0;
  p.mag2 = 0.0f;
  p.in2 = true;
}

// One group of kCycleStride steps, s + 1 .. s + kCycleStride, of a smooth
// orbit live after its own step s (a multiple of kCycleStride), equal to
// escape_time.escape_smooth_loop on every output it uses: n, the in-set
// decision (n2 >= dyn) and mag2.  Each step: the update, m2 = |z|^2, the
// bailout test (b2 = bailout^2), which freezes n at the first crossing,
// and the sticky radius-2 flag and count.  A lane that crosses keeps
// stepping to the group's end (z may run to inf or NaN), so its payload
// is kept by a select per step (faster on an H100 than replaying the
// retiring lane's steps from the group's first z; PERF.md).  Once
// per group, at the pixel's own step s + kCycleStride: the probe (only
// while inside radius 2, the plain version's act2) and the snapshot
// refresh at powers of two, as step_group does.  After steps 2 and 4 the group ends early when no lane
// stepping with this one is inside the bailout.  The orbit retires at the
// crossing, at ``step_limit`` (a multiple of kCycleStride, so never
// inside a group), on a cycle, or once n2 >= dyn: in the set, whatever
// follows (the plain version runs such a pixel on to step_limit for the
// same value).  Returns whether the orbit is still live; on false, n, n2
// and mag2 are final.
template <int F>
DM_D bool smooth_group(SmoothOrbit& p, int s, int dyn, int step_limit,
                       float b2, bool cycle_check, int power) {
  Orbit& o = p.o;
  const bool first = s == 0;
  bool live = true, in2 = p.in2;
  int n2 = p.n2;
  float mag2 = 0.0f;
#pragma unroll
  for (int k = 1; k <= kCycleStride; ++k) {
    update<F>(o.zr, o.zi, o.zr2, o.zi2, o.cr, o.ci, power);
    const float m2 = fadd(o.zr2, o.zi2);
    if (live) mag2 = m2;
    live = live && m2 < b2;
    o.n += live ? 1 : 0;
    in2 = in2 && m2 < 4.0f;
    n2 += in2 ? 1 : 0;
    if (k == kCycleStride / 2 && first) {
      o.szr = o.zr;
      o.szi = o.zi;
    }
    if ((k == 2 || k == 4) && !__any_sync(__activemask(), live)) break;
  }
  const int end = s + kCycleStride;
  p.in2 = in2;
  p.n2 = n2;
  if (live && end < step_limit && n2 < dyn) {
    if (!(cycle_check && in2 && o.zr == o.szr && o.zi == o.szi)) {
      if (cycle_check && snapshot_step(end)) {
        o.szr = o.zr;
        o.szi = o.zi;
      }
      return true;
    }
    p.n2 += dyn;  // a cycle: in the set, as the plain version's probe
    return false;
  }
  p.mag2 = mag2;
  return false;
}

// Updates survived (0..dyn) for an orbit from z0 with constant c,
// running at most dyn steps and exiting as soon as the pixel retires.
// A pixel escaping at step e returns e - 1; one that never escapes
// (budget spent, or a cycle found by the probe) returns dyn.
template <int F, bool MXU = false>
DM_D int survived(float zr0, float zi0, float cr, float ci, int dyn,
                  bool cycle_check, int power) {
  Orbit o;
  start(o, zr0, zi0, cr, ci);
  for (int s = 1; s <= dyn; ++s)
    if (!advance<F, MXU>(o, s, dyn, cycle_check, power)) break;
  return o.n;
}

// The uint8 epilogue: count = 0 when the budget was spent, else n + 1;
// byte = (count*256 + mrd - 1) / mrd in int32 (exact ceil-division; the
// budget guard keeps it in range), optionally clamped at 255, then
// wrapped explicitly.  Budgets of 1 or less give 0 (no iteration).
DM_D uint8_t epilogue(int n, int mrd, bool clamp) {
  if (mrd <= 1) return 0;
  const int dyn = mrd - 1;
  const int count = n >= dyn ? 0 : n + 1;
  int v = (count * 256 + mrd - 1) / mrd;
  if (clamp && v > 255) v = 255;
  return static_cast<uint8_t>(v & 255);
}

// One pixel of one tile whose interior test is made: ``inside`` (proven
// interior) skips the loop, then the epilogue.  z starts at the grid
// point (gr, gi); c is the grid point or the Julia constant.
template <int F, bool MXU = false>
DM_D uint8_t pixel_byte(float gr, float gi, float cr, float ci, int mrd,
                        bool clamp, bool inside, bool cycle_check,
                        int power) {
  if (mrd <= 1) return 0;
  const int dyn = mrd - 1;
  const int n = inside ? dyn
                       : survived<F, MXU>(gr, gi, cr, ci, dyn, cycle_check,
                                          power);
  return epilogue(n, mrd, clamp);
}

// One pixel of one tile: interior shortcut, loop, epilogue.
template <int F, bool MXU = false>
DM_D uint8_t escape_pixel(float gr, float gi, float cr, float ci, int mrd,
                          bool clamp, int interior_mode, float disk_lim,
                          bool cycle_check, int power) {
  return pixel_byte<F, MXU>(
      gr, gi, cr, ci, mrd, clamp,
      proven_interior(interior_mode, cr, ci, disk_lim), cycle_check, power);
}

// The bf16 scout: does a half-precision shadow of the orbit from z0 =
// the grid point (gr, gi), with constant c = (cr, ci) (the grid point
// again, or the Julia constant), leave the radius-2 disk within
// ``steps`` steps?  The update is family F's in update()'s order (the
// Burning Ship's |cross|, degree d's d - 1 complex products), never the
// matrix form (the reference's scout keeps the cached-squares form).
// Every operation is a correctly rounded bf16 intrinsic (__hmul, __hadd,
// __hsub, __habs, never __hfma), |z|^2 included, rounded before the
// compare.  PyTorch's bf16 ops compute in f32 and round once, which gives
// the same bits: f32 carries more than twice bf16's precision, so the
// double rounding is innocuous.  Advisory only: it feeds a census, never
// a pixel.
template <int F>
DM_D bool scout_escapes(float gr, float gi, float cr, float ci, int steps,
                        int power) {
  const __nv_bfloat16 bcr = __float2bfloat16_rn(cr);
  const __nv_bfloat16 bci = __float2bfloat16_rn(ci);
  __nv_bfloat16 zr = __float2bfloat16_rn(gr), zi = __float2bfloat16_rn(gi);
  __nv_bfloat16 zr2 = __hmul(zr, zr), zi2 = __hmul(zi, zi);
  for (int s = 0; s < steps; ++s) {
    if (F == kMultibrot) {
      __nv_bfloat16 wr = zr, wi = zi;
      for (int k = 1; k < power; ++k) {
        const __nv_bfloat16 nr = __hsub(__hmul(wr, zr), __hmul(wi, zi));
        const __nv_bfloat16 ni = __hadd(__hmul(wr, zi), __hmul(wi, zr));
        wr = nr;
        wi = ni;
      }
      zr = __hadd(wr, bcr);
      zi = __hadd(wi, bci);
    } else {
      __nv_bfloat16 cross = __hmul(__hadd(zr, zr), zi);
      if (F == kShip) cross = __habs(cross);
      zi = __hadd(cross, bci);
      zr = __hadd(__hsub(zr2, zi2), bcr);
    }
    zr2 = __hmul(zr, zr);
    zi2 = __hmul(zi, zi);
    if (!(__bfloat162float(__hadd(zr2, zi2)) < 4.0f)) return true;
  }
  return false;
}

}  // namespace dm
