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
// K9's design, a simple first form: one thread a pixel, 256 a block; dc
// read from the separable row and column vectors through their broadcast
// strides (no H x W plane is uploaded); the orbit entry of a step (Z and
// 2Z in one vector load, tol |Z|^2 in another) read from device memory
// by every lane of a warp at the same address (a broadcast, cached in
// L1); per-pixel exit once the lane is no longer live, which leaves every
// output the plain version's, since n, the masks and the frozen values
// are sticky.  State between launches (dz, n and the flags; for K10 also
// n2 and the frozen value) lives in device memory; the first launch of a
// scan starts it from dc.
//
// What bounds them on an H100: operations.  A lane-step is 20 f32 (or
// f64) operations, 18 for Julia (the test: 2 adds for z, 2 multiplies
// and an add for |z|^2; the delta: 8 multiplies, 5 adds and subtracts,
// and the 2 adds of dc), no FMA, and a pixel reads and writes a few
// bytes of state per launch.  The orbit entry's own terms (2Z, tol
// |Z|^2) come precomputed (perturb.cuh).  K10's step also makes four
// f64 compares (the glitch, the bailout radius twice: >= to freeze the
// value and < to clear act_b, which differ on NaN, and radius 2), so
// its FP64 pipe takes 24 instructions a step: 83% of the 20-operation
// bound at best.
//
// K10, redesigned from that first form, on the period-349 minibrot's
// 1024^2 f64 view (two launches of 512 rows, 4.38e10 lane-steps; CUDA
// events, an H100 80GB HBM3 at 700 W): the first form took 117.6 ms
// (43.8% of its bound).  Timing-only variants of it: the same loop ended
// by a given per-lane step count in place of its per-step test of the
// lane's flags, 93.6 ms; that loop fed from one fixed tile in shared
// memory, 93.9 ms; and unrolled by 4 (by 8) with a 32-bit index, 84.9
// (80.6) ms.  So the feed cost nothing (a warp's broadcast load from L1
// is as good as one from shared memory) and the loop cost the rest: a
// branch on each step's f64 compares, a 64-bit index, nothing unrolled.
// K10 now
//
// - feeds the orbit through a ring in shared memory: up to four slots of
//   one tile each (kSmoothTile = 256 table rows and their tol |Z|^2, 10
//   KB in f64), filled ahead by 1-D bulk copies (TMA) that complete on a
//   ``full`` mbarrier a slot; warps release a slot on an ``empty``
//   mbarrier, and a warp whose lanes are all done takes itself off the
//   ring's later arrivals (mbarrier.arrive_drop).  The producer is thread
//   0, which outlives its lanes: a dedicated warp would take its
//   registers from the four blocks an SM holds.  It stops at k1, or once
//   no warp of its block is live, and waits for its copies in flight
//   before it exits.  Two slots measured the same as four, which cost
//   no occupancy: registers hold an SM to four blocks, and four rings of
//   40 KB fit beside them;
// - steps a tile at a time: groups of kSmoothGroup = 8 steps unrolled,
//   the warp's vote on whether a lane is live once a group, a 32-bit
//   tile index; each step's arithmetic and its order are perturb.cuh's.
//
// That took 81.7 ms there (63%), and 92.0 ms (67%) on a view where every
// lane runs the whole orbit, against 127 ms for the first form: no
// spills at 64 registers, four blocks an SM.  Tried and no faster:
// groups of 4 (84.8 ms) or 16 (81.6, with spills); a step with its tests
// folded into two compares for lanes inside both radii, and the group
// taken again step by step where one leaves (90-100 ms: it spills, or
// runs slower without spills); two pixels a thread (89-97 ms, spills);
// 128-row tiles (83.4 ms).

#include <cstdint>
#include <cuda_runtime.h>

#include "perturb.cuh"

namespace {

using dm::kSmoothTile;
using dm::OrbitStep;
using dm::SmoothLane;

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

// --- K10's ring of orbit tiles --------------------------------------------

constexpr int kSmoothWarps = kPerturbThreads / 32;
constexpr int kSmoothMaxStages = 4;
// Registers for at least this many blocks of K10 on an SM.
constexpr int kSmoothMinBlocks = 4;

DM_PD uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

DM_PD void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Whether the phase of ``bar`` with this parity has completed: at once
// (test), or after the thread was suspended a while (try).
DM_PD bool mbar_test(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

DM_PD bool mbar_try(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

DM_PD void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try(bar, parity)) {
  }
}

DM_PD void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Arrives, and takes one arrival off every later phase.
DM_PD void mbar_arrive_drop(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive_drop.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_addr(bar))
      : "memory");
}

DM_PD void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy (TMA, 1-D) of ``bytes`` from device memory to shared
// memory, its completion counted on ``bar``.
DM_PD void bulk_load(void* dst, const void* src, unsigned bytes,
                     uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct WarpAnyLive {
  DM_PD bool operator()(bool live) const {
    return __any_sync(0xffffffffu, live) != 0;
  }
};

// The block's ring: ``stages`` slots of one orbit tile each (kSmoothTile
// rows of the table, then their tol |Z|^2), a ``full`` barrier a slot
// (the producer's arrival and the copies' bytes) and an ``empty`` one
// (one arrival a warp still in the ring).  Tile r of the launch (rows
// (t0 + r) * kSmoothTile on) goes to slot r % stages in that slot's phase
// r / stages.
template <typename T>
struct TileRing {
  static constexpr unsigned kStepBytes = kSmoothTile * sizeof(OrbitStep<T>);
  static constexpr unsigned kStageBytes = kStepBytes + kSmoothTile * sizeof(T);

  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  const OrbitStep<T>* orbit;
  const T* ztol;
  long long t0;
  int tiles, stages;

  DM_PD int slot(int r) const { return r % stages; }
  DM_PD unsigned parity(int r) const { return (r / stages) & 1; }
  DM_PD const OrbitStep<T>* steps(int r) const {
    return reinterpret_cast<const OrbitStep<T>*>(slots +
                                                 slot(r) * kStageBytes);
  }
  DM_PD const T* tol(int r) const {
    return reinterpret_cast<const T*>(slots + slot(r) * kStageBytes +
                                      kStepBytes);
  }

  // The producer: tile r may be staged once every warp still in the ring
  // has released tile r - stages (waiting for that, or only asking).
  DM_PD bool slot_free(int r, bool wait) {
    if (r < stages) return true;
    uint64_t* bar = empty + slot(r);
    const unsigned par = parity(r - stages);
    if (wait) {
      mbar_wait(bar, par);
      return true;
    }
    return mbar_test(bar, par);
  }

  DM_PD void stage(int& staged) {
    const int r = staged++;
    const int s = slot(r);
    const long long row = (t0 + r) * kSmoothTile;
    unsigned char* dst = slots + s * kStageBytes;
    mbar_arrive_expect_tx(full + s, kStageBytes);
    bulk_load(dst, orbit + row, kStepBytes, full + s);
    bulk_load(dst + kStepBytes, ztol + row, kSmoothTile * sizeof(T),
              full + s);
  }

  // Stages what the ring has room for, waiting for the slots of tiles
  // before ``need``.
  DM_PD void refill(int& staged, int need) {
    while (staged < tiles && slot_free(staged, staged < need)) stage(staged);
  }

  // A warp leaves the ring before tile r: it takes itself off the empty
  // barrier of tiles r .. r + stages - 1 (each once that slot's previous
  // phase, which it has released, is done), so of every later phase too.
  DM_PD void leave(int r) {
    for (int q = r; q < r + stages && q < tiles; ++q) {
      if (q >= stages) mbar_wait(empty + slot(q), parity(q - stages));
      mbar_arrive_drop(empty + slot(q));
    }
  }

  // The producer once its own warp is done: stages the rest while a warp
  // is live, then waits for its copies in flight, which must land before
  // the block's shared memory is released.
  DM_PD void drain(int& staged, const volatile int* live) {
    while (staged < tiles && *live > 0) {
      if (staged >= stages) {
        uint64_t* bar = empty + slot(staged);
        const unsigned par = parity(staged - stages);
        bool free = false;
        while (!(free = mbar_try(bar, par)) && *live > 0) {
        }
        if (!free) break;
      }
      stage(staged);
    }
    for (int r = staged > stages ? staged - stages : 0; r < staged; ++r)
      mbar_wait(full + slot(r), parity(r));
  }
};

// K10: one thread a pixel, its orbit from the block's ring, a tile at a
// time.  Thread 0 is also the producer; it outlives its lanes.  The one
// __syncthreads() comes before any warp can leave.
template <typename T, bool ADD_DC>
__global__ void __launch_bounds__(kPerturbThreads, kSmoothMinBlocks)
    perturb_smooth_kernel(dm::DcView<T> dc,
                          const dm::OrbitStep<T>* __restrict__ orbit,
                          const T* __restrict__ ztol, T b2, T bailout,
                          int height, int width, T* dzr, T* dzi, int* n,
                          int* n2, T* fzr, T* fzi, uint8_t* flags,
                          long long k0, long long k1, int init, int stages,
                          unsigned long long* tiles_staged) {
  extern __shared__ __align__(128) unsigned char ring_slots[];
  __shared__ uint64_t full[kSmoothMaxStages], empty[kSmoothMaxStages];
  __shared__ int live_warps;
  const long long t0 = k0 / kSmoothTile;
  TileRing<T> ring{ring_slots, full, empty, orbit, ztol, t0,
                   static_cast<int>((k1 + kSmoothTile - 1) / kSmoothTile - t0),
                   stages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kSmoothWarps);
    }
    live_warps = kSmoothWarps;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const long long pixels = static_cast<long long>(height) * width;
  const long long i =
      static_cast<long long>(blockIdx.x) * kPerturbThreads + threadIdx.x;
  SmoothLane<T> s{};
  T dcr = 0, dci = 0;
  const bool mine =
      i < pixels && dm::smooth_lane_load<T>(s, dcr, dci, i, width, dc,
                                            bailout, dzr, dzi, n, n2, fzr,
                                            fzi, flags, init != 0);
  const bool producer = threadIdx.x == 0, leader = (threadIdx.x & 31) == 0;
  int staged = 0, r = 0;
  for (; r < ring.tiles; ++r) {
    if (producer) ring.refill(staged, r + 1);
    mbar_wait(full + ring.slot(r), ring.parity(r));
    const long long row = (t0 + r) * kSmoothTile;
    const int j0 = r == 0 ? static_cast<int>(k0 - row) : 0;
    const int j1 = static_cast<int>(
        k1 - row < kSmoothTile ? k1 - row : kSmoothTile);
    const bool live = dm::smooth_tile<T, ADD_DC>(
        s, ring.steps(r), ring.tol(r), dcr, dci, b2, j0, j1, WarpAnyLive{});
    __syncwarp();
    if (!live) break;
    if (leader) mbar_arrive(empty + ring.slot(r));
  }
  if (mine)
    dm::smooth_lane_store<T>(s, i, dzr, dzi, n, n2, fzr, fzi, flags);
  if (leader) {
    atomicSub(&live_warps, 1);
    if (r < ring.tiles) ring.leave(r);
  }
  if (producer) {
    ring.drain(staged, &live_warps);
    if (tiles_staged != nullptr)
      atomicAdd(tiles_staged, static_cast<unsigned long long>(staged));
  }
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

// K10's ring for orbit steps k0 .. k1 - 1: its tiles and its depth (a
// short orbit gets fewer stages), and the shared memory they take.
struct SmoothRing {
  int tiles, stages;
  size_t bytes;
};

SmoothRing smooth_ring(int dbl, long long k0, long long k1) {
  const long long tiles = (k1 + kSmoothTile - 1) / kSmoothTile -
                          k0 / kSmoothTile;
  const int stages = static_cast<int>(
      tiles < kSmoothMaxStages ? tiles : kSmoothMaxStages);
  const size_t stage = dbl ? TileRing<double>::kStageBytes
                           : TileRing<float>::kStageBytes;
  return SmoothRing{static_cast<int>(tiles), stages, stages * stage};
}

template <typename T>
void launch_smooth(int add_dc, unsigned blocks, cudaStream_t s,
                   dm::DcView<T> dc, const void* orbit, const void* ztol,
                   double b2, double bailout, int height, int width,
                   void* dzr, void* dzi, void* n, void* n2, void* fzr,
                   void* fzi, void* flags, long long k0, long long k1,
                   int init, const SmoothRing& ring, void* tiles) {
  auto* kernel = add_dc ? perturb_smooth_kernel<T, true>
                        : perturb_smooth_kernel<T, false>;
  kernel<<<blocks, kPerturbThreads, ring.bytes, s>>>(
      dc, static_cast<const dm::OrbitStep<T>*>(orbit),
      static_cast<const T*>(ztol), static_cast<T>(b2),
      static_cast<T>(bailout), height, width, static_cast<T*>(dzr),
      static_cast<T*>(dzi), static_cast<int*>(n), static_cast<int*>(n2),
      static_cast<T*>(fzr), static_cast<T*>(fzi),
      static_cast<uint8_t*>(flags), k0, k1, init, ring.stages,
      static_cast<unsigned long long*>(tiles));
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
// ``bailout`` the frozen value's start.  The table holds ``orbit_rows``
// rows, a whole number of tiles (kSmoothTile), at least to k1, and
// ``ztol`` is aligned to 16 bytes: the kernel copies whole tiles.
// ``tiles`` (DEVICE, one int64, or null) gains the tiles the blocks
// staged.
int dm_perturb_scan_smooth(int dbl, int add_dc, const void* orbit,
                           const void* ztol, const void* dcr,
                           long long dcr_sr, long long dcr_sc,
                           const void* dci, long long dci_sr,
                           long long dci_sc, int height, int width, double b2,
                           double bailout, void* dzr, void* dzi, void* n,
                           void* n2, void* fzr, void* fzi, void* flags,
                           long long k0, long long k1, int init,
                           long long orbit_rows, void* tiles, void* stream) {
  unsigned blocks;
  if (!grid_blocks(height, width, orbit, dbl, &blocks) || k0 < 0 ||
      k1 < k0 || orbit_rows % kSmoothTile != 0 || k1 > orbit_rows ||
      reinterpret_cast<uintptr_t>(ztol) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SmoothRing ring = smooth_ring(dbl, k0, k1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dbl)
    launch_smooth<double>(add_dc, blocks, s,
                          dc_view<double>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                          dci_sc),
                          orbit, ztol, b2, bailout, height, width, dzr, dzi,
                          n, n2, fzr, fzi, flags, k0, k1, init, ring, tiles);
  else
    launch_smooth<float>(add_dc, blocks, s,
                         dc_view<float>(dcr, dcr_sr, dcr_sc, dci, dci_sr,
                                        dci_sc),
                         orbit, ztol, b2, bailout, height, width, dzr, dzi,
                         n, n2, fzr, fzi, flags, k0, k1, init, ring, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory K10's ring takes a block for orbit steps k0 .. k1 - 1.
long long dm_perturb_smooth_ring_bytes(int dbl, long long k0, long long k1) {
  return static_cast<long long>(smooth_ring(dbl, k0, k1).bytes);
}

}  // extern "C"
