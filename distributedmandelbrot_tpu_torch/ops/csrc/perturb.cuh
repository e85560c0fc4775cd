// Per-pixel delta-orbit loops of the perturbation scans (K9, K10), shared
// by perturb_kernels.cu and the host build in host/perturb_scan.cpp.
//
// A lane carries its delta dz against the reference orbit Z and steps
//
//     z_{k+1} = Z[k] + dz          (tested: escape at |z|^2 >= 4, the
//                                   Pauldelbrot glitch at |z|^2 < tol |Z|^2)
//     dz'     = 2 Z[k] dz + dz^2 [+ dc]
//
// in the JAX package's operation order (ops/perturbation.py,
// _perturb_scan and _perturb_scan_smooth): fr = Z + dz; |z|^2 = fr*fr +
// fi*fi; dz'r = ((Zr+Zr)*dzr - (Zi+Zi)*dzi) + (dzr*dzr - dzi*dzi); dz'i
// = ((Zr+Zr)*dzi + (Zi+Zi)*dzr) + (2*dzr)*dzi; then + dc (Mandelbrot
// only).  The terms of a step that depend on Z[k] alone, Zr+Zr, Zi+Zi
// and tol*(Zr*Zr + Zi*Zi), come from a table the host computes once per
// orbit entry with the same correctly rounded operations
// (cuda_perturb.orbit_table), so a lane-step is 20 operations (18 for
// Julia).  Every operation is a correctly rounded _rn intrinsic (the
// library is also built with --fmad=false), so a lane equals the plain
// PyTorch scan bit for bit, in f32 and f64.
//
// A lane stops where the plain scan's sticky masks freeze it: the
// integer lane once it fails the escape test, the smooth lane once it
// has crossed both the bailout radius and radius 2.  Its counts, masks
// and frozen values are then final; its dz is not written back (no
// consumer reads dz after the scan).  K10's lane steps the orbit a tile
// at a time (smooth_tile) and tests whether it is live once a group of
// kSmoothGroup steps: a lane that runs a few steps past its last
// crossing changes none of its outputs, since they are sticky.
#pragma once

#include <cstdint>

#define DM_PD __device__ __forceinline__
#ifdef __CUDACC__
#define DM_UNROLL _Pragma("unroll")
#else
#define DM_UNROLL
#endif

namespace dm {

DM_PD float padd(float a, float b) { return __fadd_rn(a, b); }
DM_PD float psub(float a, float b) { return __fsub_rn(a, b); }
DM_PD float pmul(float a, float b) { return __fmul_rn(a, b); }
DM_PD double padd(double a, double b) { return __dadd_rn(a, b); }
DM_PD double psub(double a, double b) { return __dsub_rn(a, b); }
DM_PD double pmul(double a, double b) { return __dmul_rn(a, b); }

// Flag bits of the integer lane's state byte.
constexpr uint8_t kActive = 1, kGlitched = 2;
// Flag bits of the smooth lane's state byte.
constexpr uint8_t kActB = 1, kAct2 = 2, kSGlitched = 4;

// One orbit entry and its doublings, read by a lane in one vector load.
template <typename T>
struct alignas(4 * sizeof(T)) OrbitStep {
  T zr, zi, zr2, zi2;
};

template <typename T>
struct DeltaLane {
  T dzr, dzi;
  int n;
  bool active, glitched;
};

template <typename T>
struct SmoothLane {
  T dzr, dzi, fzr, fzi;
  int n, n2;
  bool act_b, act2, glitched;
};

// The delta after one step from z = Z + dz (zr2, zi2: 2Z).
template <typename T, bool ADD_DC>
DM_PD void delta_step(T& dzr, T& dzi, T zr2, T zi2, T dcr, T dci) {
  T ndzr = padd(psub(pmul(zr2, dzr), pmul(zi2, dzi)),
                psub(pmul(dzr, dzr), pmul(dzi, dzi)));
  T ndzi = padd(padd(pmul(zr2, dzi), pmul(zi2, dzr)),
                pmul(pmul(static_cast<T>(2), dzr), dzi));
  if (ADD_DC) {
    ndzr = padd(ndzr, dcr);
    ndzi = padd(ndzi, dci);
  }
  dzr = ndzr;
  dzi = ndzi;
}

// K9's lane over orbit steps k0 .. k1 - 1.  Returns how many of the
// launch's segment ends (every seg_len steps from k0) found it live.
template <typename T, bool ADD_DC>
DM_PD int perturb_run(DeltaLane<T>& s,
                      const OrbitStep<T>* __restrict__ orbit,
                      const T* __restrict__ ztol, T dcr, T dci, long long k0,
                      long long k1, int seg_len) {
  if (!s.active) return 0;
  const T four = static_cast<T>(4);
  int live = 0, to_end = seg_len;
  for (long long k = k0; k < k1; ++k) {
    const OrbitStep<T> z = orbit[k];
    const T fr = padd(z.zr, s.dzr), fi = padd(z.zi, s.dzi);
    const T mag2 = padd(pmul(fr, fr), pmul(fi, fi));
    if (mag2 < ztol[k]) s.glitched = true;
    if (!(mag2 < four)) {
      s.active = false;
      return live;
    }
    s.n += 1;
    delta_step<T, ADD_DC>(s.dzr, s.dzi, z.zr2, z.zi2, dcr, dci);
    if (--to_end == 0) {
      ++live;
      to_end = seg_len;
    }
  }
  return live;
}

// K10's orbit tiles: kSmoothTile entries of the table each (the table
// holds whole tiles; cuda_perturb.orbit_table pads it), stepped in groups
// of kSmoothGroup between two tests of whether the lane is live.
constexpr int kSmoothTile = 256;
constexpr int kSmoothGroup = 8;

// One step of K10's lane at orbit entry z (zt: tol |Z|^2): the bailout
// count n and the frozen full value at the first crossing of |z|^2 >=
// b2, the sticky radius-2 count n2, the glitch flag while inside radius
// 2.
template <typename T, bool ADD_DC>
DM_PD void smooth_step(SmoothLane<T>& s, const OrbitStep<T>& z, T zt,
                       T dcr, T dci, T b2) {
  const T four = static_cast<T>(4);
  const T fr = padd(z.zr, s.dzr), fi = padd(z.zi, s.dzi);
  const T mag2 = padd(pmul(fr, fr), pmul(fi, fi));
  if (s.act2 && mag2 < zt) s.glitched = true;
  if (s.act_b && mag2 >= b2) {
    s.fzr = fr;
    s.fzi = fi;
  }
  s.act_b = s.act_b && mag2 < b2;
  s.n += s.act_b;
  s.act2 = s.act2 && mag2 < four;
  s.n2 += s.act2;
  delta_step<T, ADD_DC>(s.dzr, s.dzi, z.zr2, z.zi2, dcr, dci);
}

// kSmoothGroup steps of K10's lane from entry 0 of ``steps`` and ``tol``,
// unrolled: no test of whether the lane is live between them.
template <typename T, bool ADD_DC>
DM_PD void smooth_group(SmoothLane<T>& s, const OrbitStep<T>* steps,
                        const T* tol, T dcr, T dci, T b2) {
  DM_UNROLL
  for (int u = 0; u < kSmoothGroup; ++u)
    smooth_step<T, ADD_DC>(s, steps[u], tol[u], dcr, dci, b2);
}

// Entries j0 .. j1 - 1 of one orbit tile: whole groups, then single
// steps to the tile's end, each after a test of whether the lane is live
// (``any_live``: the lane's own flag on the host, its warp's vote on the
// card).  Returns that test after the last step.
template <typename T, bool ADD_DC, typename AnyLive>
DM_PD bool smooth_tile(SmoothLane<T>& s, const OrbitStep<T>* steps,
                       const T* tol, T dcr, T dci, T b2, int j0, int j1,
                       AnyLive any_live) {
  int j = j0;
  for (; j + kSmoothGroup <= j1; j += kSmoothGroup) {
    if (!any_live(s.act_b || s.act2)) return false;
    smooth_group<T, ADD_DC>(s, steps + j, tol + j, dcr, dci, b2);
  }
  for (; j < j1; ++j) {
    if (!any_live(s.act_b || s.act2)) return false;
    smooth_step<T, ADD_DC>(s, steps[j], tol[j], dcr, dci, b2);
  }
  return any_live(s.act_b || s.act2);
}

// The state planes of one scan (flat, height * width), and the pixel's
// dc from the (possibly broadcast) dc operands: element (r, c) at
// r * sr + c * sc.
template <typename T>
struct DcView {
  const T* re;
  const T* im;
  long long re_sr, re_sc, im_sr, im_sc;
  DM_PD T at_re(long long r, long long c) const {
    return re[r * re_sr + c * re_sc];
  }
  DM_PD T at_im(long long r, long long c) const {
    return im[r * im_sr + c * im_sc];
  }
};

// K9's pixel i: load (or, on the first launch, start) its lane, run it,
// store what changed.  Returns its live segment ends.
template <typename T, bool ADD_DC>
DM_PD int perturb_pixel(long long i, int width, const DcView<T>& dc,
                        const OrbitStep<T>* orbit, const T* ztol, T* dzr,
                        T* dzi, int* n, uint8_t* flags, long long k0,
                        long long k1, bool init, int seg_len) {
  const long long r = i / width, c = i % width;
  const T dcr = dc.at_re(r, c), dci = dc.at_im(r, c);
  DeltaLane<T> s;
  if (init) {
    s = DeltaLane<T>{dcr, dci, 0, true, false};
  } else {
    const uint8_t f = flags[i];
    if (!(f & kActive)) return 0;
    s = DeltaLane<T>{dzr[i], dzi[i], n[i], true, (f & kGlitched) != 0};
  }
  const int live =
      perturb_run<T, ADD_DC>(s, orbit, ztol, dcr, dci, k0, k1, seg_len);
  if (s.active) {
    dzr[i] = s.dzr;
    dzi[i] = s.dzi;
  }
  n[i] = s.n;
  flags[i] = (s.active ? kActive : 0) | (s.glitched ? kGlitched : 0);
  return live;
}

// K10's pixel i: its lane loaded (or, on the first launch, started from
// dc) with its dc; false for a lane the scan no longer steps.
template <typename T>
DM_PD bool smooth_lane_load(SmoothLane<T>& s, T& dcr, T& dci, long long i,
                            int width, const DcView<T>& dc, T bailout,
                            const T* dzr, const T* dzi, const int* n,
                            const int* n2, const T* fzr, const T* fzi,
                            const uint8_t* flags, bool init) {
  const long long r = i / width, c = i % width;
  dcr = dc.at_re(r, c);
  dci = dc.at_im(r, c);
  if (init) {
    s = SmoothLane<T>{dcr, dci, bailout, static_cast<T>(0), 0, 0,
                      true, true, false};
    return true;
  }
  const uint8_t f = flags[i];
  if (!(f & (kActB | kAct2))) return false;
  s = SmoothLane<T>{dzr[i], dzi[i], fzr[i], fzi[i], n[i], n2[i],
                    (f & kActB) != 0, (f & kAct2) != 0,
                    (f & kSGlitched) != 0};
  return true;
}

// K10's pixel i: its lane's state stored.
template <typename T>
DM_PD void smooth_lane_store(const SmoothLane<T>& s, long long i, T* dzr,
                             T* dzi, int* n, int* n2, T* fzr, T* fzi,
                             uint8_t* flags) {
  dzr[i] = s.dzr;
  dzi[i] = s.dzi;
  fzr[i] = s.fzr;
  fzi[i] = s.fzi;
  n[i] = s.n;
  n2[i] = s.n2;
  flags[i] = (s.act_b ? kActB : 0) | (s.act2 ? kAct2 : 0) |
             (s.glitched ? kSGlitched : 0);
}

}  // namespace dm
