// The smooth colormap's kernel for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (ops/_build.py, ops/cuda_colormap.py).
//
// - colormap_rgba8_kernel: float64 smooth values nu -> RGBA8, the bytes
//   that serve/render.py's float route makes (smooth_to_rgba, then
//   imsave_bytes).  It replaces no Pallas kernel: the JAX package colours
//   on the host (its serve/render.py smooth_to_rgba and imsave_bytes),
//   through a float64 RGBA plane the size of the view.  Here a view's nu
//   is coloured once on its device, straight to bytes.
//
// The host gives two tables built from the float route's own arithmetic
// (serve/render.py smooth_boundaries, smooth_table8): n ascending
// float64 values where an escaped value's table row changes, and the
// RGBA8 rows, whose last two are NaN's (transparent black) and the set's
// (opaque black).  An escaped value's row is n less the boundaries at or
// below it, so the device never evaluates log1p, whose last bit may
// differ from the host's libm: the bytes equal the host's by
// construction.
//
// What bounds it on an H100: bytes, 8 in and 4 out a pixel (3.8 us at
// 1024^2 at 3.35 TB/s), and at 1024^2 its launch; what bounds a view's
// colouring is the copies of nu up and of the bytes down.  Design: each
// block stages the tables in shared memory (2 KiB of boundaries, padded
// with NaN past n, and the rows; not __constant__ memory, whose cache
// serialises the divergent addresses of a warp's searches); each thread
// colours four pixels an iteration of a grid-stride loop, with two
// 16-byte loads and one 16-byte store, and finds a row by a branchless
// search of 8 steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The most boundaries 8 halving steps count, and the most table rows.
constexpr int kMaxBoundaries = 255;
constexpr int kMaxRows = 512;
constexpr int kColormapThreads = 256;
constexpr int kColormapMaxBlocks = 1024;
// The boundaries' padding: a quiet NaN's bits.
constexpr long long kQuietNan = 0x7ff8000000000000LL;

// The table row of one smooth value: the boundaries at or below v
// counted by halving steps of 128 .. 1 (the NaN padding past the n
// sorted boundaries is never at or below v, and the steps read index
// 254 at most); NaN's row for NaN, the set's for v <= 0 (-0.0
// included).
__device__ __forceinline__ int smooth_row(double v, const double* b, int n,
                                          int rows) {
  int pos = 0;
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    const int step = 1 << k;
    pos += b[pos + step - 1] <= v ? step : 0;
  }
  const int row = v <= 0.0 ? rows - 1 : n - pos;
  return v != v ? rows - 2 : row;
}

__global__ void __launch_bounds__(kColormapThreads)
    colormap_rgba8_kernel(const double* __restrict__ nu, long long pixels,
                          const double* __restrict__ boundaries, int n,
                          const unsigned* __restrict__ table, int rows,
                          unsigned* __restrict__ out) {
  __shared__ double s_bounds[kMaxBoundaries];
  __shared__ unsigned s_table[kMaxRows];
  for (int i = threadIdx.x; i < kMaxBoundaries; i += kColormapThreads)
    s_bounds[i] = i < n ? boundaries[i] : __longlong_as_double(kQuietNan);
  for (int i = threadIdx.x; i < rows; i += kColormapThreads)
    s_table[i] = table[i];
  __syncthreads();
  const long long quads = pixels / 4;
  const double2* nu2 = reinterpret_cast<const double2*>(nu);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  for (long long q = static_cast<long long>(blockIdx.x) * kColormapThreads +
                     threadIdx.x;
       q < quads; q += static_cast<long long>(gridDim.x) * kColormapThreads) {
    const double2 a = nu2[2 * q];
    const double2 b = nu2[2 * q + 1];
    out4[q] = make_uint4(s_table[smooth_row(a.x, s_bounds, n, rows)],
                         s_table[smooth_row(a.y, s_bounds, n, rows)],
                         s_table[smooth_row(b.x, s_bounds, n, rows)],
                         s_table[smooth_row(b.y, s_bounds, n, rows)]);
  }
  // The last pixels % 4, one a thread of the first block.
  const long long i = 4 * quads + threadIdx.x;
  if (blockIdx.x == 0 && i < pixels)
    out[i] = s_table[smooth_row(nu[i], s_bounds, n, rows)];
}

}  // namespace

extern "C" {

// nu (``pixels`` float64, 16-byte aligned) -> out (``pixels`` RGBA8,
// 16-byte aligned) through ``boundaries`` (``n`` ascending float64, 1 to
// 255) and ``table`` (``rows`` RGBA8 rows, n + 3 to 512: the colours,
// then NaN's and the set's last), all DEVICE pointers, on ``stream``.
// Returns cudaGetLastError() after the launch.
int dm_colormap_rgba8(const void* nu, long long pixels,
                      const void* boundaries, int n, const void* table,
                      int rows, void* out, void* stream) {
  if (pixels < 0 || n < 1 || n > kMaxBoundaries || rows < n + 3 ||
      rows > kMaxRows || reinterpret_cast<uintptr_t>(nu) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(boundaries) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = pixels / 4;
  long long blocks = (quads + kColormapThreads - 1) / kColormapThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kColormapMaxBlocks) blocks = kColormapMaxBlocks;
  colormap_rgba8_kernel<<<static_cast<unsigned>(blocks), kColormapThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(nu), pixels,
      static_cast<const double*>(boundaries), n,
      static_cast<const unsigned*>(table), rows, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
