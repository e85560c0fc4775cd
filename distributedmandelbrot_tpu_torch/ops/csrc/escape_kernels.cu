// Escape-time kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (ops/_build.py, ops/cuda_escape.py).  Each
// replaces a Pallas kernel of the JAX package's ops/pallas_escape.py:
//
// - escape_tile_kernel (K1, _escape_block_kernel): one tile's uint8
//   escape-time plane, for every family — Mandelbrot, Julia (z0 = grid,
//   c = the constant), Multibrot z^d + c, Burning Ship.
// - escape_mega_kernel (K2, _escape_mega_kernel): k same-shaped tiles
//   of one family in one launch, each with its own params row and
//   budget, plus the per-tile bf16 scout census.
// - K8 (ops/mxu_iteration.py's mxu_step, which runs inside the Pallas
//   K1 and K2): the template flag MXU of K1 and K2 (degree 2 without a
//   fold), z^2 + c as the 2x2 rotation-matrix product on the CUDA cores;
//   dm_mxu_probe runs its parity probe with the same device functions.
// - escape_pack_kernel (K5, _escape_pack_kernel): n <= 4 same-shaped
//   tiles, one thread carrying the n orbits of its pixel (the
//   supersampled render's samples), out as (n, H, W) uint8.
// - escape_smooth_kernel (K4, _smooth_block_kernel): one tile's f32
//   smooth value nu, for every family.
// - escape_batch_kernel (K3, _escape_batch_kernel): k same-shaped tiles
//   in one launch, every family, with the params rows and budgets in
//   device memory (k is a mesh shard's size, unbounded).
// - escape_state_kernel (K6, compact_escape.py's _state_batch_kernel):
//   K3's loop capped at a phase budget, writing the raw per-pixel state
//   (c, z, n, act) instead of bytes.
// - escape_resume_kernel (K7, compact_escape.py's _resume_block_kernel):
//   one resume round over a flat buffer of lanes, each carrying its own
//   c and budget.
//
// All run the per-pixel functions of escape.cuh, so a fused, packed or
// batched launch equals single-tile launches bitwise, and K6 then K7
// rounds equal K3: a resumed lane recomputes its cached squares with
// the same correctly rounded multiply and continues the same step
// sequence (per-pixel exit makes every seam exact).
//
// What bounds them on an H100: operations.  A pixel reads nothing and
// writes one byte (four for nu); each step is 8 f32 operations at
// degree 2 (3 multiplies, 5 adds or subtracts, |z|^2 included; the
// Burning Ship adds an abs, degree d costs 6d - 1, K8's matrix form 11
// as written: 4 multiplies and 2 adds for the product, 2 adds of c,
// 2 squares and an add for |z|^2) plus a compare, so a
// tile costs that times the steps its pixels need, against its output
// bytes.  The design answer is one thread per pixel with per-thread
// early exit: a sky pixel leaves after a few steps, an interior-proven
// pixel never iterates, and only the orbits that need the budget spend
// it — the Hopper form of the TPU kernels' block-granular exit.  K5
// adds instruction-level parallelism: its n orbits are independent, so
// their steps interleave in one thread (the Hopper reading of what
// packing bought on the TPU), each orbit retiring on its own.  What is
// left on the table (warp divergence between neighbouring pixels that
// exit far apart, the uncontracted arithmetic that bit-parity asks for)
// is later work.  None of the TPU workarounds is carried: no scratch
// state, no 64x128 blocks (any H, W; the ragged edge is masked), no
// prologue pipelining, no byte-lane packing.  K6 and K7 move state
// through device memory (24 B written per pixel by K6; per lane and
// round, K7 reads 28 B and writes 16 B), which is what the compacted
// pipeline pays so that K7's warps hold only live lanes.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "escape.cuh"

namespace {

constexpr int kBlockX = 32;  // one warp spans 32 adjacent columns
constexpr int kBlockY = 8;
// Tiles per fused launch: their params ride the kernel's parameter
// space (no host-to-device copy, so a launch never syncs the host).
constexpr int kMaxMegaTiles = 128;
// States per packed launch (pallas_escape.PACK_MAX).
constexpr int kPackMax = 4;
// A params row: start_r, start_i, step_r, step_i, julia c_r, c_i.
constexpr int kRow = 6;

// About 3.6 KB: inside the 4 KB a __grid_constant__ parameter may take.
struct MegaParams {
  float row[kMaxMegaTiles][kRow];  // as TileParams::row, per tile
  int mrd[kMaxMegaTiles];          // each tile's own budget
  int julia;                       // c = (row[4], row[5]) per tile
  int interior_mode;               // dm::Interior
  float disk_lim;                  // the kDisk limit
};

struct TileParams {
  float row[kRow];
  int julia;             // c = (row[4], row[5]) instead of the grid point
  int interior_mode;     // dm::Interior
  float disk_lim;        // the kDisk limit
};

struct PackParams {
  float row[kPackMax][kRow];
  int mrd[kPackMax];
  int julia;
  int interior_mode;
  float disk_lim;
};

// The smooth epilogue's constants, each rounded once on the host.
struct SmoothParams {
  TileParams tile;
  int step_limit;    // steps a still-live pixel runs (segment_steps)
  float b2;          // bailout^2
  float two_ln_b;    // 2 ln(bailout)
  float log2_power;  // log2(power); 0 at degree 2 (no division)
};

// Tile t = blockIdx.z: each pixel is K1's (dm::pixel_byte, behind
// dm::escape_pixel), so the fused launch equals k single-tile launches
// by construction; the census counts the pixels not proven interior
// whose bf16 shadow escapes.  JULIA is a template flag, not a runtime
// select as in K1: outside Julia mode the compiler then knows z0 = c.
// With the runtime select the Mandelbrot K2 ran slower on an H100
// (PERF.md; tools/ab_trees.py times both forms).
template <int F, bool MXU, bool JULIA>
__global__ void escape_mega_kernel(uint8_t* __restrict__ out,
                                   int* __restrict__ census,
                                   const __grid_constant__ MegaParams p,
                                   int height, int width, int clamp,
                                   int cycle_check, int scout_steps,
                                   int power) {
  const int t = blockIdx.z;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  unsigned hit = 0;
  if (row < height && col < width) {
    const float gr = dm::grid(p.row[t][0], p.row[t][2], col);
    const float gi = dm::grid(p.row[t][1], p.row[t][3], row);
    const float cr = JULIA ? p.row[t][4] : gr;
    const float ci = JULIA ? p.row[t][5] : gi;
    const bool inside =
        dm::proven_interior(p.interior_mode, cr, ci, p.disk_lim);
    if (scout_steps > 0 && !inside)
      hit = dm::scout_escapes<F>(gr, gi, cr, ci, scout_steps, power) ? 1u
                                                                     : 0u;
    out[(static_cast<size_t>(t) * height + row) * width + col] =
        dm::pixel_byte<F, MXU>(gr, gi, cr, ci, p.mrd[t], clamp, inside,
                               cycle_check, power);
  }
  // Census: one warp-wide sum, one integer atomic per warp (exact and
  // order-free).  Every lane reaches this point: none returned early.
  const unsigned total = __reduce_add_sync(0xffffffffu, hit);
  if ((threadIdx.x & 31) == 0 && total) atomicAdd(&census[t], (int)total);
}

template <int F, bool MXU = false>
__global__ void escape_tile_kernel(uint8_t* __restrict__ out, int height,
                                   int width,
                                   const __grid_constant__ TileParams p,
                                   int mrd, int clamp, int cycle_check,
                                   int power) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;
  const float gr = dm::grid(p.row[0], p.row[2], col);
  const float gi = dm::grid(p.row[1], p.row[3], row);
  const float cr = p.julia ? p.row[4] : gr;
  const float ci = p.julia ? p.row[5] : gi;
  out[static_cast<size_t>(row) * width + col] = dm::escape_pixel<F, MXU>(
      gr, gi, cr, ci, mrd, clamp, p.interior_mode, p.disk_lim, cycle_check,
      power);
}

// K8's parity probe: from z0 = c = (xs[col], ys[row]), ``steps`` steps
// of update() in the cached-squares form and in the matrix form, with no
// escape test; out is (4, n, n) f32: the two forms' zr, zi.
__global__ void mxu_probe_kernel(float* __restrict__ out,
                                 const float* __restrict__ xs,
                                 const float* __restrict__ ys, int n,
                                 int steps) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= n || col >= n) return;
  const float cr = xs[col], ci = ys[row];
  float vr = cr, vi = ci, vr2 = dm::fmul(cr, cr), vi2 = dm::fmul(ci, ci);
  float mr = cr, mi = ci, mr2 = vr2, mi2 = vi2;
  for (int s = 0; s < steps; ++s) {
    dm::update<dm::kQuadratic, false>(vr, vi, vr2, vi2, cr, ci, 2);
    dm::update<dm::kQuadratic, true>(mr, mi, mr2, mi2, cr, ci, 2);
  }
  const size_t plane = static_cast<size_t>(n) * n;
  const size_t i = static_cast<size_t>(row) * n + col;
  out[i] = vr;
  out[plane + i] = vi;
  out[2 * plane + i] = mr;
  out[3 * plane + i] = mi;
}

// N orbits per thread, stepped in lockstep (state arrays fully unrolled
// into registers); each retires on its own and, stepping exactly as K1
// does, ends with K1's n for its tile.
template <int N, int F>
__global__ void escape_pack_kernel(uint8_t* __restrict__ out, int height,
                                   int width,
                                   const __grid_constant__ PackParams p,
                                   int clamp, int cycle_check, int power) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;
  dm::Orbit o[N];
  int dyn[N];
  bool live[N];
  bool any = false;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const float gr = dm::grid(p.row[t][0], p.row[t][2], col);
    const float gi = dm::grid(p.row[t][1], p.row[t][3], row);
    const float cr = p.julia ? p.row[t][4] : gr;
    const float ci = p.julia ? p.row[t][5] : gi;
    dyn[t] = p.mrd[t] - 1;
    dm::start(o[t], gr, gi, cr, ci);
    const bool inside =
        dyn[t] > 0 && dm::proven_interior(p.interior_mode, cr, ci,
                                          p.disk_lim);
    o[t].n = inside ? dyn[t] : 0;
    live[t] = dyn[t] > 0 && !inside;
    any = any || live[t];
  }
  for (int s = 1; any; ++s) {
    any = false;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      if (live[t])
        live[t] = s <= dyn[t] &&
                  dm::advance<F>(o[t], s, dyn[t], cycle_check, power);
      any = any || live[t];
    }
  }
#pragma unroll
  for (int t = 0; t < N; ++t)
    out[(static_cast<size_t>(t) * height + row) * width + col] =
        dm::epilogue(o[t].n, p.mrd[t], clamp);
}

// One pixel of the smooth loop (escape_time.escape_smooth_loop and
// smooth_nu): n counts the steps inside radius ``bailout`` (z freezes at
// the first crossing: that z is the payload), the sticky radius-2 count
// n2 owns the in-set decision, and a pixel still live after
// ``step_limit`` steps stops there, as the Pallas kernel's whole
// segments do.  logf/log2f and the correctly rounded division match
// PyTorch's log, log2 and tensor division on the card.
template <int F>
__global__ void escape_smooth_kernel(float* __restrict__ out, int height,
                                     int width,
                                     const __grid_constant__ SmoothParams p,
                                     int mrd, int cycle_check, int power) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= height || col >= width) return;
  float* px = out + static_cast<size_t>(row) * width + col;
  if (mrd <= 1) {
    *px = 0.0f;
    return;
  }
  const int dyn = mrd - 1;
  const TileParams& tp = p.tile;
  float zr = dm::grid(tp.row[0], tp.row[2], col);
  float zi = dm::grid(tp.row[1], tp.row[3], row);
  const float cr = tp.julia ? tp.row[4] : zr;
  const float ci = tp.julia ? tp.row[5] : zi;
  float zr2 = dm::fmul(zr, zr), zi2 = dm::fmul(zi, zi);
  float szr = zr, szi = zi;
  const bool inside =
      dm::proven_interior(tp.interior_mode, cr, ci, tp.disk_lim);
  int n = 0, n2 = inside ? dyn : 0;
  bool live = !inside, in2 = !inside;
  for (int s = 1; live && s <= p.step_limit; ++s) {
    dm::update<F>(zr, zi, zr2, zi2, cr, ci, power);
    const float m2 = dm::fadd(zr2, zi2);
    if (m2 < p.b2)
      ++n;
    else
      live = false;
    in2 = in2 && m2 < 4.0f;
    if (cycle_check && in2 && (s % dm::kCycleStride) == 0 && zr == szr &&
        zi == szi) {
      in2 = false;
      live = false;
      n2 += dyn;
    }
    if (in2) ++n2;
    if (cycle_check && dm::snapshot_step(s)) {
      szr = zr;
      szi = zi;
    }
  }
  if (n2 >= dyn) {
    *px = 0.0f;
    return;
  }
  // nan_to_num (NaN and +inf to the f32 max; a sum of squares is never
  // -inf), then clip to [b2, max].
  float mag2 = dm::fadd(zr2, zi2);
  if (isnan(mag2) || isinf(mag2)) mag2 = FLT_MAX;
  mag2 = fminf(fmaxf(mag2, p.b2), FLT_MAX);
  float corr = log2f(__fdiv_rn(logf(mag2), p.two_ln_b));
  if (power != 2) corr = __fdiv_rn(corr, p.log2_power);
  *px = dm::fsub(__int2float_rn(n + 2), corr);
}

// One pixel of tile t = t0 + blockIdx.z of a batch whose params rows
// (kRow floats each) and budgets lie in device memory.
struct BatchPixel {
  int t, row, col;
  float gr, gi, cr, ci;
  int mrd;
};

DM_D bool batch_pixel(BatchPixel& p, const float* __restrict__ rows,
                      const int* __restrict__ mrds, int t0, int height,
                      int width, int julia) {
  p.t = t0 + static_cast<int>(blockIdx.z);
  p.col = blockIdx.x * blockDim.x + threadIdx.x;
  p.row = blockIdx.y * blockDim.y + threadIdx.y;
  if (p.row >= height || p.col >= width) return false;
  const float* r = rows + static_cast<size_t>(p.t) * kRow;
  p.gr = dm::grid(r[0], r[2], p.col);
  p.gi = dm::grid(r[1], r[3], p.row);
  p.cr = julia ? r[4] : p.gr;
  p.ci = julia ? r[5] : p.gi;
  p.mrd = mrds[p.t];
  return true;
}

template <int F>
__global__ void escape_batch_kernel(uint8_t* __restrict__ out,
                                    const float* __restrict__ rows,
                                    const int* __restrict__ mrds, int t0,
                                    int height, int width, int julia,
                                    int clamp, int interior_mode,
                                    float disk_lim, int cycle_check,
                                    int power) {
  BatchPixel p;
  if (!batch_pixel(p, rows, mrds, t0, height, width, julia)) return;
  out[(static_cast<size_t>(p.t) * height + p.row) * width + p.col] =
      dm::escape_pixel<F>(p.gr, p.gi, p.cr, p.ci, p.mrd, clamp,
                          interior_mode, disk_lim, cycle_check, power);
}

// Phase 1 of the compacted pipeline: K3's pixel for at most
// min(dyn, phase_budget) steps, the probe off.  A proven-interior pixel
// starts with n = dyn and act = 0; act stays 1 only for a pixel still
// live whose budget runs past the phase (a tile whose budget fits in
// the phase is complete).
template <int F>
__global__ void escape_state_kernel(
    float* __restrict__ cr_out, float* __restrict__ ci_out,
    float* __restrict__ zr_out, float* __restrict__ zi_out,
    int* __restrict__ n_out, int* __restrict__ act_out,
    const float* __restrict__ rows, const int* __restrict__ mrds, int t0,
    int height, int width, int julia, int interior_mode, float disk_lim,
    int power, int phase_budget) {
  BatchPixel p;
  if (!batch_pixel(p, rows, mrds, t0, height, width, julia)) return;
  const int dyn = p.mrd - 1;
  dm::Orbit o;
  dm::start(o, p.gr, p.gi, p.cr, p.ci);
  bool live = dyn > 0;
  if (live && dm::proven_interior(interior_mode, p.cr, p.ci, disk_lim)) {
    o.n = dyn;
    live = false;
  }
  const int cap = dyn < phase_budget ? dyn : phase_budget;
  for (int s = 1; live && s <= cap; ++s)
    live = dm::advance<F>(o, s, dyn, false, power);
  const size_t i = (static_cast<size_t>(p.t) * height + p.row) * width + p.col;
  cr_out[i] = p.cr;
  ci_out[i] = p.ci;
  zr_out[i] = o.zr;
  zi_out[i] = o.zi;
  n_out[i] = o.n;
  act_out[i] = (live && dyn > phase_budget) ? 1 : 0;
}

// One resume round over ``lanes`` lanes, in place: a live lane runs
// steps it0 .. min(it0 + seg - 1, dyn) while it stays inside radius 2,
// its squares recomputed from z (the bits update() cached).  A lane
// leaves act = 1 only if it is still live with budget left.
template <int F>
__global__ void escape_resume_kernel(float* __restrict__ zr,
                                     float* __restrict__ zi,
                                     int* __restrict__ n,
                                     int* __restrict__ act,
                                     const float* __restrict__ cr,
                                     const float* __restrict__ ci,
                                     const int* __restrict__ dyn,
                                     long long lanes, int it0, int seg,
                                     int power) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= lanes || !act[i]) return;
  const int d = dyn[i];
  dm::Orbit o;
  o.zr = zr[i];
  o.zi = zi[i];
  o.zr2 = dm::fmul(o.zr, o.zr);
  o.zi2 = dm::fmul(o.zi, o.zi);
  o.cr = cr[i];
  o.ci = ci[i];
  o.szr = o.zr;
  o.szi = o.zi;
  o.n = n[i];
  const long long end = static_cast<long long>(it0) + seg - 1;
  const int last = end < d ? static_cast<int>(end) : d;
  bool live = true;
  for (int s = it0; live && s <= last; ++s)
    live = dm::advance<F>(o, s, d, false, power);
  zr[i] = o.zr;
  zi[i] = o.zi;
  n[i] = o.n;
  act[i] = (live && last < d) ? 1 : 0;
}

dim3 grid_for(int height, int width, int k) {
  return dim3((width + kBlockX - 1) / kBlockX,
              (height + kBlockY - 1) / kBlockY, k);
}

TileParams tile_params(const float* row, int julia, int interior_mode,
                       float disk_lim) {
  TileParams p = {};
  for (int c = 0; c < kRow; ++c) p.row[c] = row[c];
  p.julia = julia;
  p.interior_mode = interior_mode;
  p.disk_lim = disk_lim;
  return p;
}

// Tiles per launch of a batched kernel: the grid's z extent.
constexpr int kMaxGridZ = 65535;

// Launches ``launch(t0, tiles)`` over [0, k) in slices of kMaxGridZ
// tiles; returns the first launch error (0 = all launched).
template <typename L>
int over_tiles(int k, L launch) {
  for (int t0 = 0; t0 < k; t0 += kMaxGridZ) {
    launch(t0, k - t0 < kMaxGridZ ? k - t0 : kMaxGridZ);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Julia mode exists at degree 2 without a fold only, so only kQuadratic
// instantiates the JULIA kernels.
template <int F, bool MXU>
void launch_mega(uint8_t* out, int* census, const MegaParams& p, int k,
                 int height, int width, int clamp, int cycle_check,
                 int scout_steps, int power, cudaStream_t stream) {
  const dim3 g = grid_for(height, width, k), b(kBlockX, kBlockY);
  if constexpr (F == dm::kQuadratic) {
    if (p.julia) {
      escape_mega_kernel<F, MXU, true><<<g, b, 0, stream>>>(
          out, census, p, height, width, clamp, cycle_check, scout_steps,
          power);
      return;
    }
  }
  escape_mega_kernel<F, MXU, false><<<g, b, 0, stream>>>(
      out, census, p, height, width, clamp, cycle_check, scout_steps, power);
}

template <int N>
void launch_pack(int family, uint8_t* out, int height, int width,
                 const PackParams& p, int clamp, int cycle_check, int power,
                 cudaStream_t stream) {
  const dim3 g = grid_for(height, width, 1), b(kBlockX, kBlockY);
  if (family == dm::kShip)
    escape_pack_kernel<N, dm::kShip><<<g, b, 0, stream>>>(
        out, height, width, p, clamp, cycle_check, power);
  else if (family == dm::kMultibrot)
    escape_pack_kernel<N, dm::kMultibrot><<<g, b, 0, stream>>>(
        out, height, width, p, clamp, cycle_check, power);
  else
    escape_pack_kernel<N, dm::kQuadratic><<<g, b, 0, stream>>>(
        out, height, width, p, clamp, cycle_check, power);
}

}  // namespace

extern "C" {

int dm_mega_max_tiles() { return kMaxMegaTiles; }

const char* dm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1: one (height, width) uint8 tile into ``out`` on ``stream``.
// ``row`` is a HOST pointer to 6 floats (start_r, start_i, step_r,
// step_i, julia c_r, c_i).  ``mxu`` selects K8's matrix form (degree 2
// without a fold only).  Returns cudaGetLastError() after the launch
// (0 = launched).
int dm_escape_tile(void* out, int height, int width, const float* row,
                   int julia, int mrd, int clamp, int interior_mode,
                   float disk_lim, int cycle_check, int family, int power,
                   int mxu, void* stream) {
  if (mxu && family != dm::kQuadratic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (height <= 0 || width <= 0) return 0;
  const TileParams p = tile_params(row, julia, interior_mode, disk_lim);
  const dim3 g = grid_for(height, width, 1), b(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (family == dm::kShip)
    escape_tile_kernel<dm::kShip><<<g, b, 0, s>>>(o, height, width, p, mrd,
                                                  clamp, cycle_check, power);
  else if (family == dm::kMultibrot)
    escape_tile_kernel<dm::kMultibrot><<<g, b, 0, s>>>(
        o, height, width, p, mrd, clamp, cycle_check, power);
  else if (mxu)
    escape_tile_kernel<dm::kQuadratic, true><<<g, b, 0, s>>>(
        o, height, width, p, mrd, clamp, cycle_check, power);
  else
    escape_tile_kernel<dm::kQuadratic><<<g, b, 0, s>>>(
        o, height, width, p, mrd, clamp, cycle_check, power);
  return static_cast<int>(cudaGetLastError());
}

// K2: k tiles into ``out`` (k, height, width) uint8, census into
// ``census`` (k int32, zeroed by the caller).  ``params`` (k x 6 f32, as
// K1's row) and ``mrds`` (k int32) are HOST pointers, copied into the
// launch's parameter block.  ``mxu`` selects K8's matrix form (degree 2
// without a fold only).
int dm_escape_mega(void* out, void* census, const void* params,
                   const void* mrds, int k, int height, int width, int julia,
                   int clamp, int interior_mode, float disk_lim,
                   int cycle_check, int scout_steps, int family, int power,
                   int mxu, void* stream) {
  if (k < 1 || k > kMaxMegaTiles) return static_cast<int>(cudaErrorInvalidValue);
  if (mxu && family != dm::kQuadratic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (height <= 0 || width <= 0) return 0;
  MegaParams p = {};
  const float* rows = static_cast<const float*>(params);
  const int* budgets = static_cast<const int*>(mrds);
  for (int t = 0; t < k; ++t) {
    for (int c = 0; c < kRow; ++c) p.row[t][c] = rows[t * kRow + c];
    p.mrd[t] = budgets[t];
  }
  p.julia = julia;
  p.interior_mode = interior_mode;
  p.disk_lim = disk_lim;
  uint8_t* o = static_cast<uint8_t*>(out);
  int* c = static_cast<int*>(census);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (family == dm::kShip)
    launch_mega<dm::kShip, false>(o, c, p, k, height, width, clamp,
                                  cycle_check, scout_steps, power, s);
  else if (family == dm::kMultibrot)
    launch_mega<dm::kMultibrot, false>(o, c, p, k, height, width, clamp,
                                       cycle_check, scout_steps, power, s);
  else if (mxu)
    launch_mega<dm::kQuadratic, true>(o, c, p, k, height, width, clamp,
                                      cycle_check, scout_steps, power, s);
  else
    launch_mega<dm::kQuadratic, false>(o, c, p, k, height, width, clamp,
                                       cycle_check, scout_steps, power, s);
  return static_cast<int>(cudaGetLastError());
}

// K8's parity probe: ``out`` (4, n, n) f32 from the grid ``xs`` (n) x
// ``ys`` (n); all DEVICE pointers.
int dm_mxu_probe(void* out, const void* xs, const void* ys, int n,
                 int steps, void* stream) {
  if (n <= 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  mxu_probe_kernel<<<grid_for(n, n, 1), dim3(kBlockX, kBlockY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(xs),
      static_cast<const float*>(ys), n, steps);
  return static_cast<int>(cudaGetLastError());
}

// K5: n tiles into ``out`` (n, height, width) uint8.  ``rows`` (n x 6
// f32) and ``mrds`` (n int32) are HOST pointers.
int dm_escape_pack(void* out, int n, int height, int width,
                   const float* rows, const int* mrds, int julia, int clamp,
                   int interior_mode, float disk_lim, int cycle_check,
                   int family, int power, void* stream) {
  if (n < 1 || n > kPackMax) return static_cast<int>(cudaErrorInvalidValue);
  if (height <= 0 || width <= 0) return 0;
  PackParams p = {};
  for (int t = 0; t < n; ++t) {
    for (int c = 0; c < kRow; ++c) p.row[t][c] = rows[t * kRow + c];
    p.mrd[t] = mrds[t];
  }
  p.julia = julia;
  p.interior_mode = interior_mode;
  p.disk_lim = disk_lim;
  uint8_t* o = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch_pack<1>(family, o, height, width, p, clamp, cycle_check, power, s); break;
    case 2: launch_pack<2>(family, o, height, width, p, clamp, cycle_check, power, s); break;
    case 3: launch_pack<3>(family, o, height, width, p, clamp, cycle_check, power, s); break;
    default: launch_pack<4>(family, o, height, width, p, clamp, cycle_check, power, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: one (height, width) f32 plane of nu into ``out``.  ``row`` is a
// HOST pointer to 6 floats, as for K1.
int dm_escape_smooth(void* out, int height, int width, const float* row,
                     int julia, int mrd, int step_limit, float b2,
                     float two_ln_b, float log2_power, int interior_mode,
                     float disk_lim, int cycle_check, int family, int power,
                     void* stream) {
  if (height <= 0 || width <= 0) return 0;
  SmoothParams p = {};
  p.tile = tile_params(row, julia, interior_mode, disk_lim);
  p.step_limit = step_limit;
  p.b2 = b2;
  p.two_ln_b = two_ln_b;
  p.log2_power = log2_power;
  const dim3 g = grid_for(height, width, 1), b(kBlockX, kBlockY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (family == dm::kShip)
    escape_smooth_kernel<dm::kShip><<<g, b, 0, s>>>(o, height, width, p,
                                                    mrd, cycle_check, power);
  else if (family == dm::kMultibrot)
    escape_smooth_kernel<dm::kMultibrot><<<g, b, 0, s>>>(
        o, height, width, p, mrd, cycle_check, power);
  else
    escape_smooth_kernel<dm::kQuadratic><<<g, b, 0, s>>>(
        o, height, width, p, mrd, cycle_check, power);
  return static_cast<int>(cudaGetLastError());
}

// K3: k tiles into ``out`` (k, height, width) uint8.  ``rows`` (k x 6
// f32) and ``mrds`` (k int32) are DEVICE pointers, read by the kernel
// on ``stream``.
int dm_escape_batch(void* out, const void* rows, const void* mrds, int k,
                    int height, int width, int julia, int clamp,
                    int interior_mode, float disk_lim, int cycle_check,
                    int family, int power, void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || height <= 0 || width <= 0) return 0;
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* r = static_cast<const float*>(rows);
  const int* m = static_cast<const int*>(mrds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 b(kBlockX, kBlockY);
  return over_tiles(k, [&](int t0, int n) {
    const dim3 g = grid_for(height, width, n);
    if (family == dm::kShip)
      escape_batch_kernel<dm::kShip><<<g, b, 0, s>>>(
          o, r, m, t0, height, width, julia, clamp, interior_mode, disk_lim,
          cycle_check, power);
    else if (family == dm::kMultibrot)
      escape_batch_kernel<dm::kMultibrot><<<g, b, 0, s>>>(
          o, r, m, t0, height, width, julia, clamp, interior_mode, disk_lim,
          cycle_check, power);
    else
      escape_batch_kernel<dm::kQuadratic><<<g, b, 0, s>>>(
          o, r, m, t0, height, width, julia, clamp, interior_mode, disk_lim,
          cycle_check, power);
  });
}

// K6: the six (k, height, width) state planes c_re, c_im, z_re, z_im
// (f32) and n, act (int32).  ``rows``/``mrds`` are DEVICE pointers, as
// for K3.
int dm_escape_state(void* cr, void* ci, void* zr, void* zi, void* n,
                    void* act, const void* rows, const void* mrds, int k,
                    int height, int width, int julia, int interior_mode,
                    float disk_lim, int family, int power, int phase_budget,
                    void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || height <= 0 || width <= 0) return 0;
  float* const planes[4] = {static_cast<float*>(cr), static_cast<float*>(ci),
                            static_cast<float*>(zr), static_cast<float*>(zi)};
  int* const np = static_cast<int*>(n);
  int* const ap = static_cast<int*>(act);
  const float* r = static_cast<const float*>(rows);
  const int* m = static_cast<const int*>(mrds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 b(kBlockX, kBlockY);
  return over_tiles(k, [&](int t0, int cnt) {
    const dim3 g = grid_for(height, width, cnt);
#define DM_STATE(F)                                                         \
  escape_state_kernel<F><<<g, b, 0, s>>>(                                   \
      planes[0], planes[1], planes[2], planes[3], np, ap, r, m, t0, height, \
      width, julia, interior_mode, disk_lim, power, phase_budget)
    if (family == dm::kShip)
      DM_STATE(dm::kShip);
    else if (family == dm::kMultibrot)
      DM_STATE(dm::kMultibrot);
    else
      DM_STATE(dm::kQuadratic);
#undef DM_STATE
  });
}

// K7: one resume round over ``lanes`` lanes, updating zr, zi, n and act
// in place (all DEVICE pointers, flat).
int dm_escape_resume(void* zr, void* zi, void* n, void* act, const void* cr,
                     const void* ci, const void* dyn, long long lanes,
                     int it0, int seg, int family, int power, void* stream) {
  if (lanes < 0 || seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  constexpr int kThreads = 256;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 g(static_cast<unsigned>(blocks)), b(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DM_RESUME(F)                                                        \
  escape_resume_kernel<F><<<g, b, 0, s>>>(                                  \
      static_cast<float*>(zr), static_cast<float*>(zi),                     \
      static_cast<int*>(n), static_cast<int*>(act),                         \
      static_cast<const float*>(cr), static_cast<const float*>(ci),         \
      static_cast<const int*>(dyn), lanes, it0, seg, power)
  if (family == dm::kShip)
    DM_RESUME(dm::kShip);
  else if (family == dm::kMultibrot)
    DM_RESUME(dm::kMultibrot);
  else
    DM_RESUME(dm::kQuadratic);
#undef DM_RESUME
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
