// Host build of perturb.cuh's per-pixel delta-orbit loops (K9, K10), for
// the CPU tests (tests/test_torch_perturbation.py): the same header nvcc
// compiles, with __device__ dropped and the _rn intrinsics as plain f32
// and f64 operations (build with -ffp-contract=off, so nothing is
// contracted into an FMA, as --fmad=false keeps it on the card).  The
// entry points take the arguments of perturb_kernels.cu's, pointers to
// host memory, and run the kernels' pixels one after another (K10's each
// over the kernel's orbit tiles, read from the table itself); a segment
// end's count is the sum the kernel's warps add atomically.  The stream
// argument is ignored, and so is K10's tile count: the host stages no
// tiles.
//
//   g++ -O2 -ffp-contract=off -shared -fPIC -I host -I . \
//       host/perturb_scan.cpp -o libdm_perturb_host.so
#include <algorithm>
#include <cstdint>

#define __device__
#define __forceinline__ inline
#define __restrict__

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }

#include "perturb.cuh"

namespace {

template <typename T>
dm::DcView<T> dc_view(const void* re, long long re_sr, long long re_sc,
                      const void* im, long long im_sr, long long im_sc) {
  return dm::DcView<T>{static_cast<const T*>(re), static_cast<const T*>(im),
                       re_sr, re_sc, im_sr, im_sc};
}

template <typename T, bool ADD_DC>
void scan(const dm::DcView<T>& dc, const void* orbit, const void* ztol,
          int height, int width, void* dzr, void* dzi, void* n, void* flags,
          long long k0, long long k1, int init, int seg_len, void* counts) {
  const long long pixels = static_cast<long long>(height) * width;
  const int segs = counts ? static_cast<int>((k1 - k0) / seg_len) : 0;
  for (long long i = 0; i < pixels; ++i) {
    const int live = dm::perturb_pixel<T, ADD_DC>(
        i, width, dc, static_cast<const dm::OrbitStep<T>*>(orbit),
        static_cast<const T*>(ztol), static_cast<T*>(dzr),
        static_cast<T*>(dzi), static_cast<int*>(n),
        static_cast<uint8_t*>(flags), k0, k1, init != 0, seg_len);
    for (int j = 0; j < segs && j < live; ++j)
      static_cast<int*>(counts)[j] += 1;
  }
}

template <typename T, bool ADD_DC>
void smooth(const dm::DcView<T>& dc, const void* orbit, const void* ztol,
            double b2, double bailout, int height, int width,
            void* dzr, void* dzi, void* n, void* n2, void* fzr, void* fzi,
            void* flags, long long k0, long long k1, int init) {
  const long long pixels = static_cast<long long>(height) * width;
  const auto* steps = static_cast<const dm::OrbitStep<T>*>(orbit);
  const auto* tol = static_cast<const T*>(ztol);
  const auto lane_live = [](bool live) { return live; };
  for (long long i = 0; i < pixels; ++i) {
    dm::SmoothLane<T> s;
    T dcr, dci;
    if (!dm::smooth_lane_load<T>(
            s, dcr, dci, i, width, dc, static_cast<T>(bailout),
            static_cast<T*>(dzr), static_cast<T*>(dzi), static_cast<int*>(n),
            static_cast<int*>(n2), static_cast<T*>(fzr),
            static_cast<T*>(fzi), static_cast<uint8_t*>(flags), init != 0))
      continue;
    // The kernel's tiles, each from the table itself.
    for (long long row = k0 - k0 % dm::kSmoothTile; row < k1;
         row += dm::kSmoothTile) {
      const int j0 = static_cast<int>(std::max(k0 - row, 0LL));
      const int j1 = static_cast<int>(
          std::min(k1 - row, static_cast<long long>(dm::kSmoothTile)));
      if (!dm::smooth_tile<T, ADD_DC>(s, steps + row, tol + row, dcr, dci,
                                      static_cast<T>(b2), j0, j1, lane_live))
        break;
    }
    dm::smooth_lane_store<T>(s, i, static_cast<T*>(dzr),
                             static_cast<T*>(dzi), static_cast<int*>(n),
                             static_cast<int*>(n2), static_cast<T*>(fzr),
                             static_cast<T*>(fzi),
                             static_cast<uint8_t*>(flags));
  }
}

}  // namespace

extern "C" {

int dm_perturb_scan(int dbl, int add_dc, const void* orbit,
                    const void* ztol, const void* dcr, long long dcr_sr,
                    long long dcr_sc, const void* dci, long long dci_sr,
                    long long dci_sc, int height, int width, void* dzr,
                    void* dzi, void* n, void* flags, long long k0,
                    long long k1, int init, int seg_len, void* counts,
                    void*) {
  if (height < 1 || width < 1 || k0 < 0 || k1 < k0 || seg_len < 1 ||
      (counts && (k1 - k0) % seg_len != 0))
    return 1;
  if (dbl) {
    const auto dc = dc_view<double>(dcr, dcr_sr, dcr_sc, dci, dci_sr, dci_sc);
    (add_dc ? scan<double, true> : scan<double, false>)(
        dc, orbit, ztol, height, width, dzr, dzi, n, flags, k0, k1, init,
        seg_len, counts);
  } else {
    const auto dc = dc_view<float>(dcr, dcr_sr, dcr_sc, dci, dci_sr, dci_sc);
    (add_dc ? scan<float, true> : scan<float, false>)(
        dc, orbit, ztol, height, width, dzr, dzi, n, flags, k0, k1, init,
        seg_len, counts);
  }
  return 0;
}

int dm_perturb_scan_smooth(int dbl, int add_dc, const void* orbit,
                           const void* ztol, const void* dcr,
                           long long dcr_sr, long long dcr_sc,
                           const void* dci, long long dci_sr,
                           long long dci_sc, int height, int width, double b2,
                           double bailout, void* dzr, void* dzi, void* n,
                           void* n2, void* fzr, void* fzi, void* flags,
                           long long k0, long long k1, int init,
                           long long orbit_rows, void*, void*) {
  if (height < 1 || width < 1 || k0 < 0 || k1 < k0 ||
      orbit_rows % dm::kSmoothTile != 0 || k1 > orbit_rows)
    return 1;
  if (dbl) {
    const auto dc = dc_view<double>(dcr, dcr_sr, dcr_sc, dci, dci_sr, dci_sc);
    (add_dc ? smooth<double, true> : smooth<double, false>)(
        dc, orbit, ztol, b2, bailout, height, width, dzr, dzi, n, n2, fzr,
        fzi, flags, k0, k1, init);
  } else {
    const auto dc = dc_view<float>(dcr, dcr_sr, dcr_sc, dci, dci_sr, dci_sc);
    (add_dc ? smooth<float, true> : smooth<float, false>)(
        dc, orbit, ztol, b2, bailout, height, width, dzr, dzi, n, n2, fzr,
        fzi, flags, k0, k1, init);
  }
  return 0;
}

const char* dm_error_string(int) { return "invalid argument"; }

}  // extern "C"
