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
// consumer reads dz after the scan).
#pragma once

#include <cstdint>

#define DM_PD __device__ __forceinline__

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

// K10's lane over orbit steps k0 .. k1 - 1: the bailout count n and the
// frozen full value at the first crossing of |z|^2 >= b2, the sticky
// radius-2 count n2, the glitch flag while inside radius 2.
template <typename T, bool ADD_DC>
DM_PD void perturb_smooth_run(SmoothLane<T>& s,
                              const OrbitStep<T>* __restrict__ orbit,
                              const T* __restrict__ ztol, T dcr, T dci, T b2,
                              long long k0, long long k1) {
  const T four = static_cast<T>(4);
  for (long long k = k0; k < k1 && (s.act_b || s.act2); ++k) {
    const OrbitStep<T> z = orbit[k];
    const T fr = padd(z.zr, s.dzr), fi = padd(z.zi, s.dzi);
    const T mag2 = padd(pmul(fr, fr), pmul(fi, fi));
    if (s.act2 && mag2 < ztol[k]) s.glitched = true;
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

// K10's pixel i, likewise (no segment ends: the smooth scan has no
// stagnation stop).
template <typename T, bool ADD_DC>
DM_PD void perturb_smooth_pixel(long long i, int width, const DcView<T>& dc,
                                const OrbitStep<T>* orbit, const T* ztol,
                                T b2, T bailout, T* dzr, T* dzi, int* n,
                                int* n2, T* fzr, T* fzi, uint8_t* flags,
                                long long k0, long long k1, bool init) {
  const long long r = i / width, c = i % width;
  const T dcr = dc.at_re(r, c), dci = dc.at_im(r, c);
  SmoothLane<T> s;
  if (init) {
    s = SmoothLane<T>{dcr, dci, bailout, static_cast<T>(0), 0, 0,
                      true, true, false};
  } else {
    const uint8_t f = flags[i];
    if (!(f & (kActB | kAct2))) return;
    s = SmoothLane<T>{dzr[i], dzi[i], fzr[i], fzi[i], n[i], n2[i],
                      (f & kActB) != 0, (f & kAct2) != 0,
                      (f & kSGlitched) != 0};
  }
  perturb_smooth_run<T, ADD_DC>(s, orbit, ztol, dcr, dci, b2, k0, k1);
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
