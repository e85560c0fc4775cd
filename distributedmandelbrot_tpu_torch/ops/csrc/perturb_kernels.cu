// Delta-orbit scan kernels of the perturbation deep-zoom route for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (ops/_build.py, ops/cuda_perturb.py).  The JAX package has no Pallas
// kernel here: its scans are lax.scans that XLA fuses into one loop
// (ops/perturbation.py: _perturb_scan, _perturb_scan_smooth, driven by
// _segmented_orbit_scan).  Run eagerly, PyTorch would launch some 25
// elementwise kernels over the plane for every orbit step, so the scans
// get kernels of their own:
//
// - perturb_scan_kernel (K9, _perturb_scan): n, active and glitched
//   per pixel, f32 or f64, Mandelbrot (ADD_DC) or Julia.  One launch
//   runs orbit steps k0 .. k1 - 1 and, when ``counts`` is given, adds
//   each lane to counts[j] for every segment end (each seg_len steps
//   from k0) it was live at; the host reads those counts and applies
//   the stagnation stop's rule between launches (cuda_perturb.py).
// - perturb_smooth_kernel (K10, _perturb_scan_smooth): n, n2, the
//   frozen full value and the masks; one launch over the whole orbit
//   (the smooth scan has no stagnation stop).
//
// Design, a simple first form: one thread a pixel, 256 a block; dc read
// from the separable row and column vectors through their broadcast
// strides (no H x W plane is uploaded); the orbit entry of a step (Z and
// 2Z in one vector load, tol |Z|^2 in another) read from device memory
// by every lane of a warp at the same address (a broadcast, cached in
// L1); per-pixel exit once the lane is no longer
// live, which leaves every output the plain version's, since n, the
// masks and the frozen values are sticky.  State between launches (dz,
// n and the flags; for K10 also n2 and the frozen value) lives in
// device memory; the first launch of a scan starts it from dc.
//
// What bounds them on an H100: operations.  A lane-step is 20 f32 (or
// f64) operations, 18 for Julia (the test: 2 adds for z, 2 multiplies
// and an add for |z|^2; the delta: 8 multiplies, 5 adds and subtracts,
// and the 2 adds of dc), no FMA, and a pixel reads and writes a few
// bytes of state per launch.  The orbit entry's own terms (2Z, tol
// |Z|^2) come precomputed (perturb.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "perturb.cuh"

namespace {

constexpr int kPerturbThreads = 256;

template <typename T, bool ADD_DC>
__global__ void __launch_bounds__(kPerturbThreads)
    perturb_scan_kernel(dm::DcView<T> dc,
                        const dm::OrbitStep<T>* __restrict__ orbit,
                        const T* __restrict__ ztol, int height, int width,
                        T* dzr, T* dzi, int* n, uint8_t* flags, long long k0,
                        long long k1, int init, int seg_len, int* counts) {
  const long long pixels = static_cast<long long>(height) * width;
  const long long i =
      static_cast<long long>(blockIdx.x) * kPerturbThreads + threadIdx.x;
  int live = 0;
  if (i < pixels)
    live = dm::perturb_pixel<T, ADD_DC>(i, width, dc, orbit, ztol, dzr, dzi,
                                        n, flags, k0, k1, init != 0,
                                        seg_len);
  if (counts == nullptr) return;
  // Every lane of the warp reaches here: one atomic per warp and segment
  // end for the lanes live there.
  const int segs = static_cast<int>((k1 - k0) / seg_len);
  for (int j = 0; j < segs; ++j) {
    const unsigned live_j = __ballot_sync(0xffffffffu, live > j);
    if ((threadIdx.x & 31) == 0 && live_j)
      atomicAdd(counts + j, __popc(live_j));
  }
}

template <typename T, bool ADD_DC>
__global__ void __launch_bounds__(kPerturbThreads)
    perturb_smooth_kernel(dm::DcView<T> dc,
                          const dm::OrbitStep<T>* __restrict__ orbit,
                          const T* __restrict__ ztol, T b2, T bailout,
                          int height, int width, T* dzr, T* dzi, int* n,
                          int* n2, T* fzr, T* fzi, uint8_t* flags,
                          long long k0, long long k1, int init) {
  const long long pixels = static_cast<long long>(height) * width;
  const long long i =
      static_cast<long long>(blockIdx.x) * kPerturbThreads + threadIdx.x;
  if (i < pixels)
    dm::perturb_smooth_pixel<T, ADD_DC>(i, width, dc, orbit, ztol, b2,
                                        bailout, dzr, dzi, n, n2, fzr, fzi,
                                        flags, k0, k1, init != 0);
}

// The grid for a (height, width) plane, and whether the orbit table is
// aligned for its vector loads.
int grid_blocks(int height, int width, const void* orbit, int dbl,
                unsigned* blocks) {
  const long long pixels = static_cast<long long>(height) * width;
  const long long b = (pixels + kPerturbThreads - 1) / kPerturbThreads;
  const uintptr_t align = dbl ? sizeof(dm::OrbitStep<double>)
                              : sizeof(dm::OrbitStep<float>);
  if (height < 1 || width < 1 || b > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(orbit) % align != 0)
    return 0;
  *blocks = static_cast<unsigned>(b);
  return 1;
}

template <typename T>
dm::DcView<T> dc_view(const void* re, long long re_sr, long long re_sc,
                      const void* im, long long im_sr, long long im_sc) {
  return dm::DcView<T>{static_cast<const T*>(re), static_cast<const T*>(im),
                       re_sr, re_sc, im_sr, im_sc};
}

template <typename T>
void launch_scan(int add_dc, unsigned blocks, cudaStream_t s,
                 dm::DcView<T> dc, const void* orbit, const void* ztol,
                 int height, int width, void* dzr, void* dzi,
                 void* n, void* flags, long long k0, long long k1, int init,
                 int seg_len, void* counts) {
  auto* kernel = add_dc ? perturb_scan_kernel<T, true>
                        : perturb_scan_kernel<T, false>;
  kernel<<<blocks, kPerturbThreads, 0, s>>>(
      dc, static_cast<const dm::OrbitStep<T>*>(orbit),
      static_cast<const T*>(ztol), height, width, static_cast<T*>(dzr),
      static_cast<T*>(dzi), static_cast<int*>(n),
      static_cast<uint8_t*>(flags), k0, k1, init, seg_len,
      static_cast<int*>(counts));
}

template <typename T>
void launch_smooth(int add_dc, unsigned blocks, cudaStream_t s,
                   dm::DcView<T> dc, const void* orbit, const void* ztol,
                   double b2, double bailout, int height, int width,
                   void* dzr, void* dzi, void* n, void* n2, void* fzr,
                   void* fzi, void* flags, long long k0, long long k1,
                   int init) {
  auto* kernel = add_dc ? perturb_smooth_kernel<T, true>
                        : perturb_smooth_kernel<T, false>;
  kernel<<<blocks, kPerturbThreads, 0, s>>>(
      dc, static_cast<const dm::OrbitStep<T>*>(orbit),
      static_cast<const T*>(ztol), static_cast<T>(b2),
      static_cast<T>(bailout), height, width, static_cast<T*>(dzr),
      static_cast<T*>(dzi), static_cast<int*>(n), static_cast<int*>(n2),
      static_cast<T*>(fzr), static_cast<T*>(fzi),
      static_cast<uint8_t*>(flags), k0, k1, init);
}

}  // namespace

extern "C" {

// K9: orbit steps k0 .. k1 - 1 of the integer delta scan over a
// (height, width) plane, on ``stream``.  ``dbl``: f64 (else f32) for
// the orbit table (k1 entries at least: ``orbit`` the (Zr, Zi, Zr + Zr,
// Zi + Zi) rows, aligned to a row; ``ztol`` tol * (Zr*Zr + Zi*Zi)), dc
// and the state planes dzr, dzi; n is int32 and flags uint8 (bit 0
// active, bit 1 glitched), all DEVICE pointers to flat planes.  dc
// element (r, c) is dcr[r * dcr_sr + c * dcr_sc] (strides in elements;
// 0 broadcasts).  ``init`` starts every lane from dc (the scan's first
// launch).  ``counts`` (DEVICE, (k1 - k0) / seg_len int32 zeroed, or
// null) receives the live lanes at each segment end.  Returns
// cudaGetLastError() after the launch.
int dm_perturb_scan(int dbl, int add_dc, const void* orbit,
                    const void* ztol, const void* dcr, long long dcr_sr,
                    long long dcr_sc, const void* dci, long long dci_sr,
                    long long dci_sc, int height, int width, void* dzr,
                    void* dzi, void* n, void* flags, long long k0,
                    long long k1, int init, int seg_len, void* counts,
                    void* stream) {
  unsigned blocks;
  if (!grid_blocks(height, width, orbit, dbl, &blocks) || k0 < 0 ||
      k1 < k0 || seg_len < 1 || (counts && (k1 - k0) % seg_len != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl)
    launch_scan<double>(add_dc, blocks, s,
                        dc_view<double>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                        dci_sc),
                        orbit, ztol, height, width, dzr, dzi, n, flags, k0,
                        k1, init, seg_len, counts);
  else
    launch_scan<float>(add_dc, blocks, s,
                       dc_view<float>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                      dci_sc),
                       orbit, ztol, height, width, dzr, dzi, n, flags, k0,
                       k1, init, seg_len, counts);
  return static_cast<int>(cudaGetLastError());
}

// K10: orbit steps k0 .. k1 - 1 of the smooth delta scan.  As K9, with
// n2 (int32), the frozen value fzr/fzi (dtype) and flags bit 0 act_b,
// bit 1 act2, bit 2 glitched; b2 is the squared bailout radius and
// ``bailout`` the frozen value's start.
int dm_perturb_scan_smooth(int dbl, int add_dc, const void* orbit,
                           const void* ztol, const void* dcr,
                           long long dcr_sr, long long dcr_sc,
                           const void* dci, long long dci_sr,
                           long long dci_sc, int height, int width, double b2,
                           double bailout, void* dzr, void* dzi, void* n,
                           void* n2, void* fzr, void* fzi, void* flags,
                           long long k0, long long k1, int init,
                           void* stream) {
  unsigned blocks;
  if (!grid_blocks(height, width, orbit, dbl, &blocks) || k0 < 0 || k1 < k0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl)
    launch_smooth<double>(add_dc, blocks, s,
                          dc_view<double>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                          dci_sc),
                          orbit, ztol, b2, bailout, height, width, dzr, dzi,
                          n, n2, fzr, fzi, flags, k0, k1, init);
  else
    launch_smooth<float>(add_dc, blocks, s,
                         dc_view<float>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                        dci_sc),
                         orbit, ztol, b2, bailout, height, width, dzr, dzi,
                         n, n2, fzr, fzi, flags, k0, k1, init);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
