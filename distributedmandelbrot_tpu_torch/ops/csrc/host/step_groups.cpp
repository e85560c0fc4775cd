// Host build of escape.cuh's per-lane loops, for the CPU tests
// (tests/test_torch_step_groups.py): the same header nvcc compiles,
// with __device__ dropped, each pixel a warp of one lane, and the _rn
// intrinsics as plain f32 operations (build with -ffp-contract=off, so nothing is contracted
// into an FMA, as --fmad=false keeps it on the card).  Each pixel runs
// alone through the 8-step groups its kernel runs, in the kernels'
// order: grid, interior test, groups until the orbit retires, what the
// retiring lane stores: dm::step_group and the byte epilogue (K1, K2,
// K3, K5) and dm::smooth_group (K4; its state, since the card's logf
// and log2f are not the host's).  K7's lanes run dm::resume_group
// groups from their own step it0 - 1, as escape_resume_kernel's do.
//
//   g++ -O2 -ffp-contract=off -shared -fPIC -I host -I . \
//       host/step_groups.cpp -o libdm_host.so
#include <cmath>
#include <cstdint>
#include <type_traits>

#define __device__
#define __forceinline__ inline

// One lane alone: its own vote.
inline unsigned __activemask() { return 1u; }
inline bool __any_sync(unsigned, bool p) { return p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }

#include "escape.cuh"

namespace {

// One pixel: n (updates survived), the steps it ran (the plain
// version's count: 0 when proven interior, the escape step, the probe's
// step, or dyn), its byte.
template <int F, bool MXU>
void pixel(const float* row, int julia, int mrd, int clamp,
           int interior_mode, float disk_lim, int cycle_check, int power,
           int r, int c, int* n_out, int* steps_out, uint8_t* byte_out) {
  const float gr = dm::grid(row[0], row[2], c);
  const float gi = dm::grid(row[1], row[3], r);
  const float cr = julia ? row[4] : gr;
  const float ci = julia ? row[5] : gi;
  const int dyn = mrd - 1;
  int n = 0, steps = 0;
  if (dyn > 0 && dm::proven_interior(interior_mode, cr, ci, disk_lim)) {
    n = dyn;
  } else if (dyn > 0) {
    dm::Orbit o;
    dm::start(o, gr, gi, cr, ci);
    int s = 0;
    while (dm::step_group<F, MXU>(o, s, dyn, cycle_check, power))
      s += dm::kCycleStride;
    n = o.n;
    if (n < dyn)
      steps = n + 1;  // escaped at step n + 1
    else if (s + dm::kCycleStride >= dyn)
      steps = dyn;  // the budget, or a cycle at step dyn
    else
      steps = s + dm::kCycleStride;  // the probe's step
  }
  *n_out = n;
  *steps_out = steps;
  *byte_out = dm::epilogue(n, mrd, clamp);
}

template <int F, bool MXU>
void tile(const float* row, int julia, int mrd, int clamp, int interior_mode,
          float disk_lim, int cycle_check, int power, int height, int width,
          int* n, int* steps, uint8_t* bytes) {
  for (int r = 0; r < height; ++r)
    for (int c = 0; c < width; ++c) {
      const long i = static_cast<long>(r) * width + c;
      pixel<F, MXU>(row, julia, mrd, clamp, interior_mode, disk_lim,
                    cycle_check, power, r, c, n + i, steps + i, bytes + i);
    }
}

// One pixel of K4's loop: n, n2 and mag2 as the retiring lane leaves
// them (what the epilogue reads), and how it retired: 0 never stepped
// (proven interior, or no budget), 1 the bailout, 2 the step limit, 3
// the probe, 4 in the set by n2.
template <int F>
void smooth_pixel(const float* row, int julia, int mrd, int step_limit,
                  float b2, int interior_mode, float disk_lim,
                  int cycle_check, int power, int r, int c, int* n_out,
                  int* n2_out, float* mag2_out, int* exit_out) {
  const float gr = dm::grid(row[0], row[2], c);
  const float gi = dm::grid(row[1], row[3], r);
  const float cr = julia ? row[4] : gr;
  const float ci = julia ? row[5] : gi;
  const int dyn = mrd - 1;
  *n_out = 0;
  *n2_out = dyn;
  *mag2_out = 0.0f;
  *exit_out = 0;
  if (mrd <= 1 || dm::proven_interior(interior_mode, cr, ci, disk_lim))
    return;
  dm::SmoothOrbit p;
  dm::start(p, gr, gi, cr, ci);
  int s = 0;
  while (dm::smooth_group<F>(p, s, dyn, step_limit, b2, cycle_check != 0,
                            power))
    s += dm::kCycleStride;
  const int end = s + dm::kCycleStride;
  *n_out = p.o.n;
  *n2_out = p.n2;
  *mag2_out = p.mag2;
  *exit_out = p.n2 > end ? 3 : p.n2 >= dyn ? 4 : p.o.n < end ? 1 : 2;
}

// Calls ``fn`` with family F as a compile-time constant.
template <typename Fn>
void by_family(int family, Fn&& fn) {
  if (family == dm::kShip)
    fn(std::integral_constant<int, dm::kShip>{});
  else if (family == dm::kMultibrot)
    fn(std::integral_constant<int, dm::kMultibrot>{});
  else
    fn(std::integral_constant<int, dm::kQuadratic>{});
}

}  // namespace

extern "C" {

// One (height, width) tile from a 6-float params row, as K1 computes it
// (family and interior codes of dm::Family, dm::Interior; ``mxu``
// selects K8's matrix form): n, steps and bytes, row-major.  Returns 0,
// or -1 for the matrix form outside degree 2 without a fold.
int dm_host_tile(const float* row, int julia, int mrd, int clamp,
                 int interior_mode, float disk_lim, int cycle_check,
                 int family, int power, int mxu, int height, int width,
                 int* n, int* steps, uint8_t* bytes) {
  if (mxu && family != dm::kQuadratic) return -1;
  if (family == dm::kShip)
    tile<dm::kShip, false>(row, julia, mrd, clamp, interior_mode, disk_lim,
                           cycle_check, power, height, width, n, steps,
                           bytes);
  else if (family == dm::kMultibrot)
    tile<dm::kMultibrot, false>(row, julia, mrd, clamp, interior_mode,
                                disk_lim, cycle_check, power, height, width,
                                n, steps, bytes);
  else if (mxu)
    tile<dm::kQuadratic, true>(row, julia, mrd, clamp, interior_mode,
                               disk_lim, cycle_check, power, height, width,
                               n, steps, bytes);
  else
    tile<dm::kQuadratic, false>(row, julia, mrd, clamp, interior_mode,
                                disk_lim, cycle_check, power, height, width,
                                n, steps, bytes);
  return 0;
}

// K2's census for one tile: the pixels not proven interior whose bf16
// shadow (dm::scout_escapes) leaves the radius-2 disk within ``steps``.
long dm_host_census(const float* row, int julia, int interior_mode,
                    float disk_lim, int family, int power, int steps,
                    int height, int width) {
  long hits = 0;
  for (int r = 0; r < height; ++r)
    for (int c = 0; c < width; ++c) {
      const float gr = dm::grid(row[0], row[2], c);
      const float gi = dm::grid(row[1], row[3], r);
      const float cr = julia ? row[4] : gr;
      const float ci = julia ? row[5] : gi;
      if (dm::proven_interior(interior_mode, cr, ci, disk_lim)) continue;
      const bool hit =
          family == dm::kShip
              ? dm::scout_escapes<dm::kShip>(gr, gi, cr, ci, steps, power)
          : family == dm::kMultibrot
              ? dm::scout_escapes<dm::kMultibrot>(gr, gi, cr, ci, steps,
                                                  power)
              : dm::scout_escapes<dm::kQuadratic>(gr, gi, cr, ci, steps,
                                                  power);
      hits += hit ? 1 : 0;
    }
  return hits;
}

// One (height, width) tile of K4's loop: n, n2, mag2 and the exit,
// row-major.
void dm_host_smooth(const float* row, int julia, int mrd, int step_limit,
                    float b2, int interior_mode, float disk_lim,
                    int cycle_check, int family, int power,
                    int height, int width, int* n, int* n2, float* mag2,
                    int* exits) {
  by_family(family, [&](auto f) {
    constexpr int F = decltype(f)::value;
    for (int r = 0; r < height; ++r)
      for (int c = 0; c < width; ++c) {
        const long i = static_cast<long>(r) * width + c;
        smooth_pixel<F>(
            row, julia, mrd, step_limit, b2, interior_mode, disk_lim,
            cycle_check, power, r, c, n + i, n2 + i, mag2 + i, exits + i);
      }
  });
}

// One K7 round over ``lanes`` flat lanes, in place, each lane alone as
// escape_resume_kernel runs it: a lane with act != 0 and a step left
// (budget at least it0) runs dm::resume_group groups from its step it0 -
// 1 to min(it0 + seg - 1, dyn), then stores z, n and act (1 only if
// still live with budget left); one with no step left gets act 0.
void dm_host_resume(float* zr, float* zi, int* n, int* act, const float* cr,
                    const float* ci, const int* dyn, long lanes, int it0,
                    long long seg, int family, int power) {
  const long long round_end = it0 + seg - 1;
  by_family(family, [&](auto f) {
    constexpr int F = decltype(f)::value;
    for (long i = 0; i < lanes; ++i) {
      if (!act[i]) continue;
      const int d = dyn[i];
      const int last = round_end < d ? static_cast<int>(round_end) : d;
      if (last < it0) {
        act[i] = 0;
        continue;
      }
      dm::Orbit o;
      dm::start(o, zr[i], zi[i], cr[i], ci[i]);
      o.n = n[i];
      int s = it0 - 1, r;
      while ((r = dm::resume_group<F>(o, s, last, power)) > 0) {
      }
      zr[i] = o.zr;
      zi[i] = o.zi;
      n[i] = o.n;
      act[i] = (r == 0 && last < d) ? 1 : 0;
    }
  });
}

}  // extern "C"
