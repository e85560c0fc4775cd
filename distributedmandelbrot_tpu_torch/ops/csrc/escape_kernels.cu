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
//   tiles (the supersampled render's samples), out as (n, H, W) uint8,
//   each plane equal to K1 on its tile.
// - escape_smooth_kernel (K4, _smooth_block_kernel): one tile's f32
//   smooth value nu, for every family, its row in parameter space.
// - escape_batch_kernel (K3, _escape_batch_kernel): k same-shaped tiles
//   in one launch, every family, with the params rows, budgets and
//   epilogue multipliers in device memory (k is a mesh shard's size,
//   unbounded).
// - escape_state_kernel (K6, compact_escape.py's _state_batch_kernel):
//   K3's pixel capped at a phase budget, writing the raw per-pixel state
//   (c, z, n, act) instead of bytes, from K3's rows in device memory.
// - escape_resume_kernel (K7, compact_escape.py's _resume_block_kernel):
//   one resume round over a list of lanes (indices into K6's planes, or
//   a flat buffer), each carrying its own c and budget; the compacted
//   pipeline runs it once, from phase 1 to the budgets.
//
// All run the per-pixel functions of escape.cuh, so a fused, packed or
// batched launch equals single-tile launches bitwise, and K6 then K7
// rounds equal K3: a resumed lane recomputes its cached squares with
// the same correctly rounded multiply and continues the same step
// sequence (per-pixel exit makes every seam exact).  K1, K2, K3 and K5
// step in groups of 8 (dm::step_group), which equals 8 calls of
// dm::advance on every output; K4 in groups of the smooth loop
// (dm::smooth_group); K7 in groups of the resume loop
// (dm::resume_group, from any step); tests/test_torch_step_groups.py
// builds these loops on the host and holds them to the plain versions.
//
// What bounds them on an H100: operations.  A pixel reads nothing and writes
// one byte (four for nu); each step is 8 f32 operations at degree 2 (3
// multiplies, 5 adds or subtracts, |z|^2 included; the Burning Ship adds an
// abs, degree d costs 6d - 1, K8's matrix form 11 as written: 4 multiplies and
// 2 adds for the product, 2 adds of c, 2 squares and an add for |z|^2) plus a
// compare, so a tile costs that times the steps its pixels need, against its
// output bytes.  Per-thread early exit alone (K6 runs so: one thread a
// pixel) lets a sky pixel leave after a few steps and an
// interior-proven pixel never iterate, but leaves warp divergence on the
// table: a warp of 32 neighbouring pixels steps until its slowest lane retires
// (2.35x the needed lane steps on the main path's chunks, PERF.md), and a
// block holds its SM slot until its last warp ends.  K1-K5 answer with
// persistent warps that refill retired lanes (below, "The persistent
// kernels"): a warp's lanes stay on live orbits, and the per-step overhead
// (probe, snapshot, budget, loop control, the refill vote) runs once per group
// of 8 steps.  They differ in where their tiles' rows come from (a source:
// K1's, K4's and K2's and K5's rows ride the launch's parameter space, K3's
// lie in device memory) and in what a pixel is (a policy: a byte, or K4's
// nu).  The loop pays for each run it takes, so where a run's pixels need few
// steps it can cost more than the divergence it removes: K6's phase of at
// most 256 steps stays on one thread a pixel, which ran faster there on an
// H100 than the loop did (PERF.md).  K7's lanes are the live orbits of a
// whole batch in pixel order, neighbours that run alike, so it runs one
// thread a lane in groups of 8 with per-thread exit, which ran faster than
// the persistent loop there (PERF.md).  None of the TPU workarounds is
// carried: no scratch state, no 64x128 blocks (any H, W; the ragged edge is
// masked), no prologue pipelining, no byte-lane packing (K5's tiles are
// simply the tiles of one persistent launch), no resume rounds re-compacted
// between them (one K7 launch runs every live lane to its budget where K6
// left it).  K6 and K7 move state through device memory (24 B written per
// pixel by K6, so K6 is bound by bytes; per lane, K7 reads 28 B and its
// index and writes 16 B), which is what the compacted pipeline pays so that
// K7's warps hold only live lanes.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

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

// The params of a launch over at most CAP tiles, in parameter space.
template <int CAP>
struct FusedParams {
  float row[CAP][kRow];  // as TileParams::row, per tile
  int mrd[CAP];          // each tile's own budget
  int julia;             // c = (row[4], row[5]) per tile
  int interior_mode;     // dm::Interior
  float disk_lim;        // the kDisk limit
};

// K2's, about 3.6 KB: inside the 4 KB a __grid_constant__ parameter may
// take, which is what caps one launch at kMaxMegaTiles tiles.
using MegaParams = FusedParams<kMaxMegaTiles>;
using PackParams = FusedParams<kPackMax>;

struct TileParams {
  float row[kRow];
  int julia;             // c = (row[4], row[5]) instead of the grid point
  int interior_mode;     // dm::Interior
  float disk_lim;        // the kDisk limit
};

// K4's one tile, and the smooth loop's constants, each rounded once on
// the host.
struct SmoothParams {
  FusedParams<1> tile;
  int step_limit;    // steps a still-live pixel runs (segment_steps)
  float b2;          // bailout^2
  float two_ln_b;    // 2 ln(bailout)
  float log2_power;  // log2(power); 0 at degree 2 (no division)
};

// --- The persistent kernels (K1-K5): warps over 8-step groups ---
//
// They launch only as many blocks as fit on the card at once.
// Each warp takes runs of 32 adjacent pixels of one row (see "Work
// distribution" below) and hands the pixels that need iterating to its
// lanes as lanes retire, eight or more at a time, so a warp keeps its
// lanes on live orbits until no run is left.  A run's proven-interior
// pixels (and all of a budget of 1 or less) are written straight away
// and never hold a lane; K2's census scouts the run's other pixels as it
// is taken.  Lanes step in groups of kCycleStride (the policy's), each
// pixel from its own step 1, so a pixel joins and retires only at a
// group boundary and the probe falls on its own steps.  When no run is
// left the block compacts its live orbits into its lowest lanes every
// kEndGroups groups, so the launch's tail runs on full warps and the
// emptied warps wait at the barrier without issuing.

constexpr int kThreads = 256;  // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Groups between the end game's compactions.
constexpr int kEndGroups = 4;
// Idle lanes a warp gathers before it refills them: one refill then
// serves several retired lanes (refilling each at once ran slower on an
// H100, most where few lanes retire at a time; PERF.md).
constexpr int kRefillLanes = 8;
// Work distribution: each warp keeps a range of runs in shared memory
// and takes them one at a time; when its range is empty it takes a new
// one from the launch's counter (one global atomic), guided: a share of
// what is left (1 / kTakeShare of it over the launch's warps) between
// kMinTake and kMaxTake runs; once the counter is spent it takes runs
// left in its block's other ranges.  Atomics on one address serialise
// (one a run made K1 far slower on an H100) and a warp left holding many
// runs trails the rest (PERF.md).
constexpr unsigned long long kMinTake = 8;
constexpr unsigned long long kMaxTake = 32;
constexpr unsigned long long kTakeShare = 1;
// Devices whose persistent grid is cached.
constexpr int kMaxDevices = 64;

// n / d for the run layout's divisors, by one 64-bit high multiply: m =
// floor((2^64 - 1) / d) + 1 lies in [2^64 / d, 2^64 / d + 1), so
// floor(n * m / 2^64) = floor(n / d + n * (m - 2^64 / d) / 2^64) is
// exact for n * d < 2^64.
struct FastDiv {
  unsigned long long m;
  unsigned long long d;
};

__host__ __device__ FastDiv fast_div(unsigned long long d) {
  return {d > 1 ? ~0ULL / d + 1 : 0ULL, d};
}

DM_D unsigned long long quot(const FastDiv& f, unsigned long long n) {
  return f.d > 1 ? __umul64hi(n, f.m) : n;
}

// The runs of a launch: k tiles of height x width, each row cut into
// per_row.d runs of 32 columns (the last one ragged).
struct Runs {
  FastDiv per_row;
  FastDiv rows;  // height
  unsigned long long total;
  int height, width;
};

Runs make_runs(int k, int height, int width) {
  const unsigned long long per_row = (width + 31) / 32;
  return {fast_div(per_row), fast_div(height),
          static_cast<unsigned long long>(k) * height * per_row, height,
          width};
}

// A source gives the persistent loop its tiles: row(t, c), mrd(t),
// julia(), interior_mode(), disk_lim().  kTableTiles > 0: the rows lie
// in parameter space (a constant operand, read where needed) and the
// block tables each tile's epilogue multiplier and census in shared
// memory; 0: the rows lie in device memory, and the loop reads a run's
// budget, multiplier (div(t)) and Julia constant once, as it takes the
// run, into registers.

// The tile of a K1 launch: one params row, the Julia select at run time.
struct TileSource {
  static constexpr int kTableTiles = 1;
  const TileParams& p;
  int budget;
  DM_D float row(int, int c) const { return p.row[c]; }
  DM_D int mrd(int) const { return budget; }
  DM_D bool julia() const { return p.julia != 0; }
  DM_D int interior_mode() const { return p.interior_mode; }
  DM_D float disk_lim() const { return p.disk_lim; }
};

// The tiles of a K2 (CAP = kMaxMegaTiles) or K5 (CAP = kPackMax) launch.
// JULIA is a template flag: outside Julia mode the compiler then knows
// z0 = c.  With a runtime select the Mandelbrot K2 ran slower on an H100
// (PERF.md).
template <bool JULIA, int CAP>
struct MegaSource {
  static constexpr int kTableTiles = CAP;
  const FusedParams<CAP>& p;
  DM_D float row(int t, int c) const { return p.row[t][c]; }
  DM_D int mrd(int t) const { return p.mrd[t]; }
  DM_D bool julia() const { return JULIA; }
  DM_D int interior_mode() const { return p.interior_mode; }
  DM_D float disk_lim() const { return p.disk_lim; }
};

// The tiles of a K3 launch: k rows of kRow floats, k budgets and k
// epilogue multipliers in device memory, k unbounded.  JULIA as for K2.
template <bool JULIA>
struct BatchSource {
  static constexpr int kTableTiles = 0;
  const float* rows;
  const int* mrds;
  const unsigned long long* divs;
  int interior;
  float disk;
  DM_D float row(int t, int c) const {
    return __ldg(rows + static_cast<size_t>(t) * kRow + c);
  }
  DM_D int mrd(int t) const { return __ldg(mrds + t); }
  DM_D unsigned long long div(int t) const { return __ldg(divs + t); }
  DM_D bool julia() const { return JULIA; }
  DM_D int interior_mode() const { return interior; }
  DM_D float disk_lim() const { return disk; }
};

// The warp's place in its runs: run r's tile, row and 32-column
// segment, stepped one run at a time (a division only per take).
struct RunCursor {
  unsigned long long grow;  // t * height + row
  int t, row, seg;
};

DM_D RunCursor cursor_at(const Runs& runs, unsigned long long r) {
  RunCursor c;
  c.grow = quot(runs.per_row, r);
  c.seg = static_cast<int>(r - c.grow * runs.per_row.d);
  c.t = static_cast<int>(quot(runs.rows, c.grow));
  c.row = static_cast<int>(c.grow - static_cast<unsigned long long>(c.t) *
                                        runs.height);
  return c;
}

DM_D void next_segment(RunCursor& c, const Runs& runs) {
  if (++c.seg < static_cast<int>(runs.per_row.d)) return;
  c.seg = 0;
  ++c.grow;
  if (++c.row == runs.height) {
    c.row = 0;
    ++c.t;
  }
}

// The uint8 epilogue (dm::epilogue) with the division by the budget as
// a high multiply by its FastDiv multiplier ``m`` (exact: the dividend
// is below 2^31).
DM_D uint8_t epilogue_by(int n, int mrd, unsigned long long m, int clamp) {
  if (mrd <= 1) return 0;
  const int count = n >= mrd - 1 ? 0 : n + 1;
  int v = static_cast<int>(__umul64hi(
      static_cast<unsigned long long>(count * 256 + mrd - 1), m));
  if (clamp && v > 255) v = 255;
  return static_cast<uint8_t>(v & 255);
}

// A warp's range of runs in shared memory: (first << 8) | count, taken
// from the front one run at a time by compare-and-swap.  A range is
// replaced only once empty, by a higher first run, so a stale swap
// always fails.
DM_D bool take_from(unsigned long long* range, unsigned long long& r) {
  unsigned long long old = *static_cast<volatile unsigned long long*>(range);
  while (old & 0xffu) {
    const unsigned long long got = atomicCAS(range, old, old + 255u);
    if (got == old) {
      r = old >> 8;
      return true;
    }
    old = got;
  }
  return false;
}

// The warp's next run (lane 0 takes it): from its own range, else a new
// range from ``counter``, else from a sibling's range.  False when no
// run is left to this block.
DM_D bool next_run(unsigned long long* counter, const Runs& runs,
                   unsigned long long* ranges, int warp, int lane,
                   bool& spent, unsigned long long& r) {
  int got = 0;
  if (lane == 0) {
    got = take_from(&ranges[warp], r);
    if (!got && !spent) {
      const unsigned long long seen =
          *static_cast<volatile unsigned long long*>(counter);
      const unsigned long long left =
          seen < runs.total ? runs.total - seen : 0;
      unsigned long long n =
          left / (static_cast<unsigned long long>(gridDim.x) * kWarps *
                  kTakeShare);
      n = n < kMinTake ? kMinTake : (n > kMaxTake ? kMaxTake : n);
      r = atomicAdd(counter, n);
      if (r < runs.total) {
        n = min(n, runs.total - r);
        if (n > 1) atomicExch(&ranges[warp], ((r + 1) << 8) | (n - 1));
        got = 1;
      } else {
        spent = true;
      }
    }
    for (int v = 1; !got && v < kWarps; ++v)
      got = take_from(&ranges[(warp + v) % kWarps], r);
  }
  spent = __shfl_sync(kFull, spent, 0);
  r = __shfl_sync(kFull, r, 0);
  return __shfl_sync(kFull, got, 0) != 0;
}

// A pixel policy tells the persistent loop what a pixel is: its Lane
// (the pixel's state, with the loop's ``off``, its output offset, and
// ``busy``); put_unstepped(), what the take writes for a pixel that never
// takes a lane (proven interior, or a budget of 1 or less); start(), a
// lane's first state; and group(), one group of a busy lane, which stores
// what a retiring pixel leaves and frees the lane.  kDiv: the loop hands
// start() the tile's epilogue multiplier.

// The uint8 plane (K1, K2, K3, K5): dm::step_group and the epilogue.
template <int F, bool MXU>
struct BytePixels {
  static constexpr bool kDiv = true;
  struct Lane {
    dm::Orbit o;
    int s, mrd;
    unsigned long long div;
    size_t off;
    bool busy;
  };
  uint8_t* __restrict__ out;
  int clamp, cycle_check, power;
  // n = dyn (or no budget): count 0, byte 0.
  DM_D void put_unstepped(size_t i) const { out[i] = 0; }
  DM_D void start(Lane& l, float gr, float gi, float cr, float ci, int mrd,
                  unsigned long long div) const {
    dm::start(l.o, gr, gi, cr, ci);
    l.s = 0;
    l.mrd = mrd;
    l.div = div;
  }
  DM_D void group(Lane& l) const {
    if (dm::step_group<F, MXU>(l.o, l.s, l.mrd - 1, cycle_check != 0,
                               power)) {
      l.s += dm::kCycleStride;
    } else {
      out[l.off] = epilogue_by(l.o.n, l.mrd, l.div, clamp);
      l.busy = false;
    }
  }
};

// K4's f32 smooth value nu (dm::smooth_group, then the epilogue: 0 in the
// set, else n + 2 - log2(log|z|^2 / 2 ln b) [/ log2 d]).
template <int F>
struct SmoothPixels {
  static constexpr bool kDiv = false;
  struct Lane {
    dm::SmoothOrbit p;
    int s, dyn;
    size_t off;
    bool busy;
  };
  float* __restrict__ out;
  int step_limit;
  float b2, two_ln_b, log2_power;
  int cycle_check, power;
  // In the set, or no budget: 0.
  DM_D void put_unstepped(size_t i) const { out[i] = 0.0f; }
  DM_D void start(Lane& l, float gr, float gi, float cr, float ci, int mrd,
                  unsigned long long) const {
    dm::start(l.p, gr, gi, cr, ci);
    l.s = 0;
    l.dyn = mrd - 1;
  }
  // smooth_nu's epilogue: nan_to_num (NaN and +inf to the f32 max; a sum
  // of squares is never -inf), the clip to [b2, max]; logf, log2f and
  // the correctly rounded division match PyTorch's log, log2 and tensor
  // division on the card.
  DM_D float nu(const dm::SmoothOrbit& p, int dyn) const {
    if (p.n2 >= dyn) return 0.0f;
    float mag2 = p.mag2;
    if (isnan(mag2) || isinf(mag2)) mag2 = FLT_MAX;
    mag2 = fminf(fmaxf(mag2, b2), FLT_MAX);
    float corr = log2f(__fdiv_rn(logf(mag2), two_ln_b));
    if (power != 2) corr = __fdiv_rn(corr, log2_power);
    return dm::fsub(__int2float_rn(p.o.n + 2), corr);
  }
  DM_D void group(Lane& l) const {
    if (dm::smooth_group<F>(
            l.p, l.s, l.dyn, step_limit, b2, cycle_check != 0, power)) {
      l.s += dm::kCycleStride;
    } else {
      out[l.off] = nu(l.p, l.dyn);
      l.busy = false;
    }
  }
};

// The persistent loop (see above), over the ``k`` tiles of ``src``, each
// pixel as the policy ``pix`` says.  COUNT adds the lane steps the warp
// issues (32 per step of each group it runs) to *lane_steps with one
// atomic at exit: the instrumented form that measures what the
// divergence and the tail cost.
template <int F, bool COUNT, typename Pix, typename Src>
DM_D void persistent_escape(const Pix& pix, int* __restrict__ census,
                            const Src& src, int k, const Runs& runs,
                            int scout_steps, int power,
                            unsigned long long* counter,
                            unsigned long long* lane_steps) {
  using Lane = typename Pix::Lane;
  constexpr bool kTable = Src::kTableTiles > 0;
  constexpr int kTab = kTable ? Src::kTableTiles : 1;
  __shared__ Lane s_park[kThreads];  // the end game's orbits in transit
  __shared__ int s_live[kWarps];
  __shared__ unsigned long long s_div[kTab];
  __shared__ unsigned long long s_ranges[kWarps];
  __shared__ int s_census[kTab];
  // The refill's hand-over: the candidate of rank i for the idle lane of
  // rank i (its grid real part and its lane in the run).
  __shared__ float s_gr[kWarps][32];
  __shared__ int s_from[kWarps][32];
  if constexpr (kTable)
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      s_div[i] = fast_div(static_cast<unsigned long long>(
                              src.mrd(i) > 1 ? src.mrd(i) : 2)).m;
      s_census[i] = 0;
    }
  if (threadIdx.x < kWarps) s_ranges[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  Lane l = {};
  // The warp's current run: its candidates not yet handed to a lane
  // (bit j: pixel base + j), each lane holding its own pixel's grid
  // real part; the run's tile, row grid and budget are the warp's.
  unsigned cand = 0;
  float run_gr = 0.0f, run_gi = 0.0f;
  int run_t = 0, run_mrd = 0;
  size_t run_base = 0;
  // Without a table: the run's multiplier and Julia constant, read at
  // the take (dead code for a source with one).
  unsigned long long run_div = 0;
  float run_jr = 0.0f, run_ji = 0.0f;
  auto julia_c = [&](int c) {
    if constexpr (kTable)
      return src.row(run_t, 4 + c);
    else
      return c == 0 ? run_jr : run_ji;
  };
  auto run_mult = [&]() {
    if constexpr (kTable)
      return s_div[run_t];
    else
      return run_div;
  };
  RunCursor cur = {};
  unsigned long long last = ~0ULL;  // the run ``cur`` is at
  bool spent = false, counter_spent = false;
  unsigned long long groups = 0;

  for (;;) {
    unsigned idle = __ballot_sync(kFull, !l.busy);
    if (__popc(idle) < kRefillLanes) idle = 0;
    while (idle) {
      if (!cand) {
        unsigned long long r = 0;
        if (!next_run(counter, runs, s_ranges, warp, lane, counter_spent,
                      r)) {
          spent = true;
          break;
        }
        if (r != 0 && r == last + 1)
          next_segment(cur, runs);
        else
          cur = cursor_at(runs, r);
        last = r;
        const int col = cur.seg * 32 + lane;
        run_t = cur.t;
        run_mrd = src.mrd(cur.t);
        if constexpr (!kTable) {
          if constexpr (Pix::kDiv) run_div = src.div(cur.t);
          if (src.julia()) {
            run_jr = src.row(cur.t, 4);
            run_ji = src.row(cur.t, 5);
          }
        }
        run_base = static_cast<size_t>(cur.grow) * runs.width + cur.seg * 32;
        run_gi = dm::grid(src.row(cur.t, 1), src.row(cur.t, 3), cur.row);
        run_gr = dm::grid(src.row(cur.t, 0), src.row(cur.t, 2), col);
        const bool valid = col < runs.width;
        const float cr = src.julia() ? julia_c(0) : run_gr;
        const float ci = src.julia() ? julia_c(1) : run_gi;
        const bool proven =
            valid &&
            dm::proven_interior(src.interior_mode(), cr, ci, src.disk_lim());
        if (kTable && scout_steps > 0) {
          // K2's census: the pixels not proven interior whose bf16
          // shadow escapes within scout_steps, summed over the run, per
          // tile in shared memory (integer counts: exact, order-free).
          const unsigned hit =
              valid && !proven &&
              dm::scout_escapes<F>(run_gr, run_gi, cr, ci, scout_steps,
                                   power);
          const unsigned hits = __reduce_add_sync(kFull, hit);
          if (lane == 0 && hits)
            atomicAdd(&s_census[cur.t], static_cast<int>(hits));
        }
        const bool inside = run_mrd <= 1 || proven;
        if (valid && inside) pix.put_unstepped(run_base + lane);
        cand = __ballot_sync(kFull, valid && !inside);
        continue;
      }
      const bool held = (cand >> lane) & 1u;
      if (idle == kFull) {
        // Every lane is free (a sky of short orbits): each takes the
        // pixel it tested.
        if (held) {
          const float cr = src.julia() ? julia_c(0) : run_gr;
          const float ci = src.julia() ? julia_c(1) : run_gi;
          pix.start(l, run_gr, run_gi, cr, ci, run_mrd, run_mult());
          l.off = run_base + lane;
          l.busy = true;
        }
        cand = 0;
        idle = __ballot_sync(kFull, !l.busy);
        continue;
      }
      // The first ``take`` candidates go to the first ``take`` idle
      // lanes, rank for rank, through shared memory.
      const int take = min(__popc(idle), __popc(cand));
      const int held_rank = __popc(cand & below);
      if (held && held_rank < take) {
        s_gr[warp][held_rank] = run_gr;
        s_from[warp][held_rank] = lane;
      }
      __syncwarp();
      const int rank = __popc(idle & below);
      if (!l.busy && rank < take) {
        const float gr = s_gr[warp][rank];
        const float cr = src.julia() ? julia_c(0) : gr;
        const float ci = src.julia() ? julia_c(1) : run_gi;
        pix.start(l, gr, run_gi, cr, ci, run_mrd, run_mult());
        l.off = run_base + s_from[warp][rank];
        l.busy = true;
      }
      __syncwarp();
      cand = __ballot_sync(kFull, held && held_rank >= take);
      idle = __ballot_sync(kFull, !l.busy);
    }
    if (spent) break;
    ++groups;
    if (l.busy) pix.group(l);
  }

  // The end game: no run is left to the block and no run holds a
  // candidate.  Each round parks the block's live orbits in shared
  // memory and hands them back to its first lanes; a warp with none
  // waits at the next barrier.  ``total`` is the block's, so every
  // thread leaves together.
  for (;;) {
    const unsigned live = __ballot_sync(kFull, l.busy);
    if (lane == 0) s_live[warp] = __popc(live);
    __syncthreads();
    int first = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      first += w < warp ? s_live[w] : 0;
      total += s_live[w];
    }
    if (total == 0) break;
    if (l.busy) s_park[first + __popc(live & below)] = l;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < total)
      l = s_park[threadIdx.x];
    else
      l.busy = false;
    for (int g = 0; g < kEndGroups && __any_sync(kFull, l.busy); ++g) {
      ++groups;
      if (l.busy) pix.group(l);
    }
  }
  // Every warp has left the last round's barrier: the census is whole.
  if (kTable && scout_steps > 0)
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      if (s_census[i]) atomicAdd(&census[i], s_census[i]);
  if (COUNT && lane == 0)
    atomicAdd(lane_steps, groups * dm::kCycleStride * 32ULL);
}

// K2: k tiles, each with its own params row and budget, and the census.
// Each pixel equals K1's on its tile (the same loop and epilogue).
template <int F, bool MXU, bool JULIA, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_mega_kernel(uint8_t* __restrict__ out, int* __restrict__ census,
                       const __grid_constant__ MegaParams p, Runs runs, int k,
                       int clamp, int cycle_check, int scout_steps, int power,
                       unsigned long long* work,
                       unsigned long long* lane_steps) {
  const MegaSource<JULIA, kMaxMegaTiles> src{p};
  const BytePixels<F, MXU> pix{out, clamp, cycle_check, power};
  persistent_escape<F, COUNT>(pix, census, src, k, runs, scout_steps, power,
                              work, lane_steps);
}

// K1: one tile.
template <int F, bool MXU, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_tile_kernel(uint8_t* __restrict__ out,
                       const __grid_constant__ TileParams p, Runs runs,
                       int mrd, int clamp, int cycle_check, int power,
                       unsigned long long* work,
                       unsigned long long* lane_steps) {
  const TileSource src{p, mrd};
  const BytePixels<F, MXU> pix{out, clamp, cycle_check, power};
  persistent_escape<F, COUNT>(pix, nullptr, src, 1, runs, 0, power, work,
                              lane_steps);
}

// K5: the n <= kPackMax states of a supersampled view as the n tiles of
// one launch; no census.  Each plane equals K1 on its tile.
template <int F, bool JULIA, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_pack_kernel(uint8_t* __restrict__ out,
                       const __grid_constant__ PackParams p, Runs runs, int n,
                       int clamp, int cycle_check, int power,
                       unsigned long long* work,
                       unsigned long long* lane_steps) {
  const MegaSource<JULIA, kPackMax> src{p};
  const BytePixels<F, false> pix{out, clamp, cycle_check, power};
  persistent_escape<F, COUNT>(pix, nullptr, src, n, runs, 0, power, work,
                              lane_steps);
}

// K3: k tiles whose rows, budgets and epilogue multipliers lie in device
// memory; no census.  Each plane equals K1 on its row.
template <int F, bool JULIA, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_batch_kernel(uint8_t* __restrict__ out,
                        const float* __restrict__ rows,
                        const int* __restrict__ mrds,
                        const unsigned long long* __restrict__ divs,
                        Runs runs, int k, int clamp, int interior_mode,
                        float disk_lim, int cycle_check, int power,
                        unsigned long long* work,
                        unsigned long long* lane_steps) {
  const BatchSource<JULIA> src{rows, mrds, divs, interior_mode, disk_lim};
  const BytePixels<F, false> pix{out, clamp, cycle_check, power};
  persistent_escape<F, COUNT>(pix, nullptr, src, k, runs, 0, power, work,
                              lane_steps);
}

// K4: one tile's f32 smooth values, its row in parameter space.
template <int F, bool JULIA, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_smooth_kernel(float* __restrict__ out,
                         const __grid_constant__ SmoothParams p, Runs runs,
                         int cycle_check, int power, unsigned long long* work,
                         unsigned long long* lane_steps) {
  const MegaSource<JULIA, 1> src{p.tile};
  const SmoothPixels<F> pix{out,        p.step_limit, p.b2,
                            p.two_ln_b, p.log2_power, cycle_check,
                            power};
  persistent_escape<F, COUNT>(pix, nullptr, src, 1, runs, 0, power, work,
                              lane_steps);
}

// One pixel of tile t = t0 + blockIdx.z of a batch whose params rows
// (kRow floats each) and budgets lie in device memory (K6's layout).
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

// K6, phase 1 of the compacted pipeline: K3's pixel for at most
// min(dyn, phase_budget) steps, the probe off, one thread a pixel (a
// warp is 32 adjacent pixels of one row).  A proven-interior pixel
// starts with n = dyn and act = 0; act stays 1 only for a pixel still
// live whose budget runs past the phase (a tile whose budget fits in
// the phase is complete).  It stays off the persistent loop: its pixels
// need few steps (at most the phase's 256), so the loop's cost per run
// outweighed the divergence it removes (PERF.md).  COUNT adds the
// lane steps the warp issues (32 per step of its slowest lane) to
// *lane_steps, as the persistent kernels' instrumented forms do.
template <int F, bool COUNT>
__global__ void escape_state_kernel(
    float* __restrict__ cr_out, float* __restrict__ ci_out,
    float* __restrict__ zr_out, float* __restrict__ zi_out,
    int* __restrict__ n_out, int* __restrict__ act_out,
    const float* __restrict__ rows, const int* __restrict__ mrds, int t0,
    int height, int width, int julia, int interior_mode, float disk_lim,
    int power, int phase_budget, unsigned long long* lane_steps) {
  BatchPixel p;
  const bool in = batch_pixel(p, rows, mrds, t0, height, width, julia);
  if (!COUNT && !in) return;
  int steps = 0;
  if (in) {
    const int dyn = p.mrd - 1;
    dm::Orbit o;
    dm::start(o, p.gr, p.gi, p.cr, p.ci);
    bool live = dyn > 0;
    if (live && dm::proven_interior(interior_mode, p.cr, p.ci, disk_lim)) {
      o.n = dyn;
      live = false;
    }
    const int cap = dyn < phase_budget ? dyn : phase_budget;
    int s = 1;
    for (; live && s <= cap; ++s)
      live = dm::advance<F>(o, s, dyn, false, power);
    steps = s - 1;
    const size_t i =
        (static_cast<size_t>(p.t) * height + p.row) * width + p.col;
    cr_out[i] = p.cr;
    ci_out[i] = p.ci;
    zr_out[i] = o.zr;
    zi_out[i] = o.zi;
    n_out[i] = o.n;
    act_out[i] = (live && dyn > phase_budget) ? 1 : 0;
  }
  if constexpr (COUNT) {
    // blockDim.x is 32: every thread of the warp reaches this point.
    const unsigned most =
        __reduce_max_sync(kFull, static_cast<unsigned>(steps));
    if (threadIdx.x == 0 && most)
      atomicAdd(lane_steps, 32ULL * most);
  }
}

// Blocks of ``Kernel`` resident on one SM at once (the occupancy API
// with the kernel's real registers and shared memory).
template <auto Kernel>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return n;
}

// The persistent grid of ``Kernel`` on the current device: blocks per SM
// times SMs, computed once per device, and no more blocks than the
// launch has runs for its warps.
template <auto Kernel>
unsigned persistent_grid(unsigned long long runs) {
  static int cache[kMaxDevices];
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  int g = dev >= 0 && dev < kMaxDevices ? cache[dev] : 0;
  if (g == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    g = blocks_per_sm<Kernel>() * sms;
    if (g < 1) g = 1;  // a launch that cannot fit then fails loudly
    if (dev >= 0 && dev < kMaxDevices) cache[dev] = g;
  }
  const unsigned long long need = (runs + kWarps - 1) / kWarps;
  return static_cast<unsigned>(need < static_cast<unsigned long long>(g)
                                   ? (need > 0 ? need : 1)
                                   : g);
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

// K7: one resume round over a list of lanes, one thread a lane: lane i
// lies at offset idx[i] of the flat state planes (int64 or int32; no
// list: offset i).  A lane with act != 0 runs dm::resume_group from its
// step it0 - 1 to min(it0 + seg - 1, dyn): 8-step groups, each step the
// update and the compare, the lane leaving the group at its escape step
// (per-thread early exit).  It then writes z, n and act (1 only if still
// live with budget left) back where it lies.  The list is the live
// lanes in pixel order, so a warp's 32 lanes are neighbours whose orbits
// run alike, and the pipeline runs them to their budgets in one launch
// (a persistent form whose warps refilled retired lanes from the list
// ran slower on an H100: the lanes need no refill, PERF.md).  COUNT adds
// the lane steps the warp issues (32 x 8 per group of its slowest lane)
// to *lane_steps.
template <int F, bool COUNT>
__global__ void __launch_bounds__(kThreads)
    escape_resume_kernel(float* __restrict__ zr, float* __restrict__ zi,
                         int* __restrict__ n, int* __restrict__ act,
                         const float* __restrict__ cr,
                         const float* __restrict__ ci,
                         const int* __restrict__ dyn,
                         const long long* __restrict__ idx64,
                         const int* __restrict__ idx32, long long lanes,
                         int it0, long long round_end, int power,
                         unsigned long long* lane_steps) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (!COUNT && i >= lanes) return;
  unsigned groups = 0;
  const long long at = i >= lanes ? 0
                       : idx64    ? __ldg(idx64 + i)
                       : idx32    ? __ldg(idx32 + i)
                                  : i;
  if (i < lanes && act[at]) {
    const int d = dyn[at];
    const int last = round_end < d ? static_cast<int>(round_end) : d;
    if (last < it0) {
      act[at] = 0;  // no step left in this round
    } else {
      dm::Orbit o;
      o.zr = zr[at];
      o.zi = zi[at];
      o.zr2 = dm::fmul(o.zr, o.zr);
      o.zi2 = dm::fmul(o.zi, o.zi);
      o.cr = cr[at];
      o.ci = ci[at];
      o.n = n[at];
      int s = it0 - 1, r;
      do {
        r = dm::resume_group<F>(o, s, last, power);
        ++groups;
      } while (r > 0);
      zr[at] = o.zr;
      zi[at] = o.zi;
      n[at] = o.n;
      act[at] = (r == 0 && last < d) ? 1 : 0;
    }
  }
  if constexpr (COUNT) {
    // Every thread of the block reaches this point.
    const unsigned most = __reduce_max_sync(kFull, groups);
    if ((threadIdx.x & 31) == 0 && most)
      atomicAdd(lane_steps, 32ULL * dm::kCycleStride * most);
  }
}

// The grid of the kernels that run one thread a pixel (K6, K8's parity
// probe): blocks of kBlockX x kBlockY over a height x width plane, k
// planes deep.
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

// Tiles per launch of K6: the grid's z extent.
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

// Calls ``fn(family, julia)`` with both as compile-time constants
// (std::integral_constant); Julia mode exists at degree 2 without a fold
// only, so only kQuadratic instantiates the JULIA forms.
template <typename Fn>
void by_family(int family, int julia, Fn&& fn) {
  using Ship = std::integral_constant<int, dm::kShip>;
  using Multibrot = std::integral_constant<int, dm::kMultibrot>;
  using Quadratic = std::integral_constant<int, dm::kQuadratic>;
  if (family == dm::kShip)
    fn(Ship{}, std::false_type{});
  else if (family == dm::kMultibrot)
    fn(Multibrot{}, std::false_type{});
  else if (julia)
    fn(Quadratic{}, std::true_type{});
  else
    fn(Quadratic{}, std::false_type{});
}

// A persistent kernel on its grid: the instrumented form ``Counted`` when
// ``lane_steps`` is set, else ``Kernel``.
template <auto Kernel, auto Counted, typename... Args>
void launch_persistent(const Runs& runs, unsigned long long* lane_steps,
                       cudaStream_t stream, Args... args) {
  if (lane_steps)
    Counted<<<persistent_grid<Counted>(runs.total), kThreads, 0, stream>>>(
        args...);
  else
    Kernel<<<persistent_grid<Kernel>(runs.total), kThreads, 0, stream>>>(
        args...);
}

// K1 with its template flags resolved: F, MXU, and COUNT (lane_steps
// not null: the instrumented form).
template <int F, bool MXU>
void launch_tile(uint8_t* out, const TileParams& p, const Runs& runs,
                 int mrd, int clamp, int cycle_check, int power,
                 unsigned long long* work, unsigned long long* lane_steps,
                 cudaStream_t stream) {
  launch_persistent<escape_tile_kernel<F, MXU, false>,
                    escape_tile_kernel<F, MXU, true>>(
      runs, lane_steps, stream, out, p, runs, mrd, clamp, cycle_check, power,
      work, lane_steps);
}

template <int F, bool MXU, bool JULIA>
void launch_mega_form(uint8_t* out, int* census, const MegaParams& p,
                      const Runs& runs, int k, int clamp, int cycle_check,
                      int scout_steps, int power, unsigned long long* work,
                      unsigned long long* lane_steps, cudaStream_t stream) {
  launch_persistent<escape_mega_kernel<F, MXU, JULIA, false>,
                    escape_mega_kernel<F, MXU, JULIA, true>>(
      runs, lane_steps, stream, out, census, p, runs, k, clamp, cycle_check,
      scout_steps, power, work, lane_steps);
}

// Julia mode exists at degree 2 without a fold only, so only kQuadratic
// instantiates the JULIA kernels.
template <int F, bool MXU>
void launch_mega(uint8_t* out, int* census, const MegaParams& p,
                 const Runs& runs, int k, int clamp, int cycle_check,
                 int scout_steps, int power, unsigned long long* work,
                 unsigned long long* lane_steps, cudaStream_t stream) {
  if constexpr (F == dm::kQuadratic) {
    if (p.julia) {
      launch_mega_form<F, MXU, true>(out, census, p, runs, k, clamp,
                                     cycle_check, scout_steps, power, work,
                                     lane_steps, stream);
      return;
    }
  }
  launch_mega_form<F, MXU, false>(out, census, p, runs, k, clamp,
                                  cycle_check, scout_steps, power, work,
                                  lane_steps, stream);
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
// without a fold only).  ``work`` is the launch's run counter, one
// uint64 zeroed on ``stream`` (a launch of its own: two launches in
// flight never share one).  ``lane_steps`` (one uint64, or null) selects
// the instrumented form, which adds the lane steps its warps issue.
// Returns cudaGetLastError() after the launch (0 = launched).
int dm_escape_tile(void* out, int height, int width, const float* row,
                   int julia, int mrd, int clamp, int interior_mode,
                   float disk_lim, int cycle_check, int family, int power,
                   int mxu, void* work, void* lane_steps, void* stream) {
  if (mxu && family != dm::kQuadratic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (height <= 0 || width <= 0) return 0;
  const TileParams p = tile_params(row, julia, interior_mode, disk_lim);
  const Runs runs = make_runs(1, height, width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  auto* w = static_cast<unsigned long long*>(work);
  auto* c = static_cast<unsigned long long*>(lane_steps);
  if (family == dm::kShip)
    launch_tile<dm::kShip, false>(o, p, runs, mrd, clamp, cycle_check, power,
                                  w, c, s);
  else if (family == dm::kMultibrot)
    launch_tile<dm::kMultibrot, false>(o, p, runs, mrd, clamp, cycle_check,
                                       power, w, c, s);
  else if (mxu)
    launch_tile<dm::kQuadratic, true>(o, p, runs, mrd, clamp, cycle_check,
                                      power, w, c, s);
  else
    launch_tile<dm::kQuadratic, false>(o, p, runs, mrd, clamp, cycle_check,
                                       power, w, c, s);
  return static_cast<int>(cudaGetLastError());
}

// K2: k tiles into ``out`` (k, height, width) uint8, census into
// ``census`` (k int32, zeroed by the caller).  ``params`` (k x 6 f32, as
// K1's row) and ``mrds`` (k int32) are HOST pointers, copied into the
// launch's parameter block.  ``mxu`` selects K8's matrix form (degree 2
// without a fold only).  ``work`` and ``lane_steps`` as for K1.
int dm_escape_mega(void* out, void* census, const void* params,
                   const void* mrds, int k, int height, int width, int julia,
                   int clamp, int interior_mode, float disk_lim,
                   int cycle_check, int scout_steps, int family, int power,
                   int mxu, void* work, void* lane_steps, void* stream) {
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
  const Runs runs = make_runs(k, height, width);
  uint8_t* o = static_cast<uint8_t*>(out);
  int* c = static_cast<int*>(census);
  auto* w = static_cast<unsigned long long*>(work);
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (family == dm::kShip)
    launch_mega<dm::kShip, false>(o, c, p, runs, k, clamp, cycle_check,
                                  scout_steps, power, w, ls, s);
  else if (family == dm::kMultibrot)
    launch_mega<dm::kMultibrot, false>(o, c, p, runs, k, clamp, cycle_check,
                                       scout_steps, power, w, ls, s);
  else if (mxu)
    launch_mega<dm::kQuadratic, true>(o, c, p, runs, k, clamp, cycle_check,
                                      scout_steps, power, w, ls, s);
  else
    launch_mega<dm::kQuadratic, false>(o, c, p, runs, k, clamp, cycle_check,
                                       scout_steps, power, w, ls, s);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per SM of a persistent kernel, as the launches size their
// grids (the occupancy API on the current device; 0 if it fails):
// ``kernel`` 0 K1, 1 K2 (with ``julia``), 2 K3, 3 K5, 4 K4 (each
// with ``julia``), in the form of ``family``/``mxu`` (K1 and K2 only).
int dm_persistent_blocks_per_sm(int kernel, int family, int mxu, int julia) {
  if (kernel >= 2) {
    int n = 0;
    by_family(family, julia, [&](auto f, auto j) {
      constexpr int F = decltype(f)::value;
      constexpr bool J = decltype(j)::value;
      n = kernel == 2   ? blocks_per_sm<escape_batch_kernel<F, J, false>>()
          : kernel == 3 ? blocks_per_sm<escape_pack_kernel<F, J, false>>()
                        : blocks_per_sm<escape_smooth_kernel<F, J, false>>();
    });
    return n;
  }
  if (kernel == 1) {
    if (family == dm::kShip)
      return blocks_per_sm<escape_mega_kernel<dm::kShip, false, false, false>>();
    if (family == dm::kMultibrot)
      return blocks_per_sm<
          escape_mega_kernel<dm::kMultibrot, false, false, false>>();
    if (mxu)
      return julia ? blocks_per_sm<
                         escape_mega_kernel<dm::kQuadratic, true, true, false>>()
                   : blocks_per_sm<escape_mega_kernel<dm::kQuadratic, true,
                                                      false, false>>();
    return julia ? blocks_per_sm<
                       escape_mega_kernel<dm::kQuadratic, false, true, false>>()
                 : blocks_per_sm<
                       escape_mega_kernel<dm::kQuadratic, false, false, false>>();
  }
  if (family == dm::kShip)
    return blocks_per_sm<escape_tile_kernel<dm::kShip, false, false>>();
  if (family == dm::kMultibrot)
    return blocks_per_sm<escape_tile_kernel<dm::kMultibrot, false, false>>();
  return mxu ? blocks_per_sm<escape_tile_kernel<dm::kQuadratic, true, false>>()
             : blocks_per_sm<escape_tile_kernel<dm::kQuadratic, false, false>>();
}

// The threads of a persistent kernel's block (the occupancy API's block
// size).
int dm_persistent_block_threads() { return kThreads; }

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
// f32) and ``mrds`` (n int32) are HOST pointers, copied into the
// launch's parameter block.  ``work`` and ``lane_steps`` as for K1.
int dm_escape_pack(void* out, int n, int height, int width,
                   const float* rows, const int* mrds, int julia, int clamp,
                   int interior_mode, float disk_lim, int cycle_check,
                   int family, int power, void* work, void* lane_steps,
                   void* stream) {
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
  const Runs runs = make_runs(n, height, width);
  uint8_t* o = static_cast<uint8_t*>(out);
  auto* w = static_cast<unsigned long long*>(work);
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_family(family, julia, [&](auto f, auto j) {
    constexpr int F = decltype(f)::value;
    constexpr bool J = decltype(j)::value;
    launch_persistent<escape_pack_kernel<F, J, false>,
                      escape_pack_kernel<F, J, true>>(
        runs, ls, s, o, p, runs, n, clamp, cycle_check, power, w, ls);
  });
  return static_cast<int>(cudaGetLastError());
}

// K4: one (height, width) f32 plane of nu into ``out``.  ``row`` is a
// HOST pointer to 6 floats, as for K1; ``step_limit`` a multiple of the
// group length where pixels step (mrd > 1: smooth_step_limit's multiple
// of 64, so a group never straddles it).  ``work`` and ``lane_steps`` as
// for K1.
int dm_escape_smooth(void* out, int height, int width, const float* row,
                     int julia, int mrd, int step_limit, float b2,
                     float two_ln_b, float log2_power, int interior_mode,
                     float disk_lim, int cycle_check, int family, int power,
                     void* work, void* lane_steps, void* stream) {
  if (mrd > 1 && step_limit % dm::kCycleStride != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (height <= 0 || width <= 0) return 0;
  SmoothParams p = {};
  for (int c = 0; c < kRow; ++c) p.tile.row[0][c] = row[c];
  p.tile.mrd[0] = mrd;
  p.tile.julia = julia;
  p.tile.interior_mode = interior_mode;
  p.tile.disk_lim = disk_lim;
  p.step_limit = step_limit;
  p.b2 = b2;
  p.two_ln_b = two_ln_b;
  p.log2_power = log2_power;
  const Runs runs = make_runs(1, height, width);
  float* o = static_cast<float*>(out);
  auto* w = static_cast<unsigned long long*>(work);
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_family(family, julia, [&](auto f, auto j) {
    constexpr int F = decltype(f)::value;
    constexpr bool J = decltype(j)::value;
    launch_persistent<escape_smooth_kernel<F, J, false>,
                      escape_smooth_kernel<F, J, true>>(
        runs, ls, s, o, p, runs, cycle_check, power, w, ls);
  });
  return static_cast<int>(cudaGetLastError());
}

// K3: k tiles into ``out`` (k, height, width) uint8.  ``rows`` (k x 6
// f32), ``mrds`` (k int32) and ``divs`` (k uint64, each budget's
// epilogue multiplier: floor((2^64 - 1) / max(mrd, 2)) + 1) are DEVICE
// pointers, read by the kernel on ``stream``.  ``work`` and
// ``lane_steps`` as for K1.
int dm_escape_batch(void* out, const void* rows, const void* mrds,
                    const void* divs, int k, int height, int width, int julia,
                    int clamp, int interior_mode, float disk_lim,
                    int cycle_check, int family, int power, void* work,
                    void* lane_steps, void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || height <= 0 || width <= 0) return 0;
  const Runs runs = make_runs(k, height, width);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* r = static_cast<const float*>(rows);
  const int* m = static_cast<const int*>(mrds);
  const auto* d = static_cast<const unsigned long long*>(divs);
  auto* w = static_cast<unsigned long long*>(work);
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_family(family, julia, [&](auto f, auto j) {
    constexpr int F = decltype(f)::value;
    constexpr bool J = decltype(j)::value;
    launch_persistent<escape_batch_kernel<F, J, false>,
                      escape_batch_kernel<F, J, true>>(
        runs, ls, s, o, r, m, d, runs, k, clamp, interior_mode, disk_lim,
        cycle_check, power, w, ls);
  });
  return static_cast<int>(cudaGetLastError());
}

// K6: the six (k, height, width) state planes c_re, c_im, z_re, z_im
// (f32) and n, act (int32).  ``rows``/``mrds`` are DEVICE pointers, as
// for K3.  ``lane_steps`` as for K1.
int dm_escape_state(void* cr, void* ci, void* zr, void* zi, void* n,
                    void* act, const void* rows, const void* mrds, int k,
                    int height, int width, int julia, int interior_mode,
                    float disk_lim, int family, int power, int phase_budget,
                    void* lane_steps, void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || height <= 0 || width <= 0) return 0;
  float* const planes[4] = {static_cast<float*>(cr), static_cast<float*>(ci),
                            static_cast<float*>(zr), static_cast<float*>(zi)};
  int* const np = static_cast<int*>(n);
  int* const ap = static_cast<int*>(act);
  const float* r = static_cast<const float*>(rows);
  const int* m = static_cast<const int*>(mrds);
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 b(kBlockX, kBlockY);
  return over_tiles(k, [&](int t0, int cnt) {
    const dim3 g = grid_for(height, width, cnt);
    auto go = [&](auto f, auto count) {
      constexpr int F = decltype(f)::value;
      constexpr bool C = decltype(count)::value;
      escape_state_kernel<F, C><<<g, b, 0, s>>>(
          planes[0], planes[1], planes[2], planes[3], np, ap, r, m, t0,
          height, width, julia, interior_mode, disk_lim, power, phase_budget,
          ls);
    };
    auto by_count = [&](auto f) {
      if (ls)
        go(f, std::true_type{});
      else
        go(f, std::false_type{});
    };
    if (family == dm::kShip)
      by_count(std::integral_constant<int, dm::kShip>{});
    else if (family == dm::kMultibrot)
      by_count(std::integral_constant<int, dm::kMultibrot>{});
    else
      by_count(std::integral_constant<int, dm::kQuadratic>{});
  });
}

// K7: one resume round, steps it0 .. min(it0 + seg - 1, dyn), over
// ``lanes`` lanes, updating zr, zi, n and act in place (all DEVICE
// pointers to flat planes).  ``idx`` (DEVICE, ``idx_bytes`` 8 or 4: int64
// or int32 plane offsets, unique) lists where lane i lies; null: lane i
// is at offset i.  ``lane_steps`` as for K1.
int dm_escape_resume(void* zr, void* zi, void* n, void* act, const void* cr,
                     const void* ci, const void* dyn, const void* idx,
                     int idx_bytes, long long lanes, int it0, long long seg,
                     int family, int power, void* lane_steps, void* stream) {
  if (lanes < 0 || seg < 1 || it0 < 1 ||
      (idx && idx_bytes != 8 && idx_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* i64 =
      idx_bytes == 8 ? static_cast<const long long*>(idx) : nullptr;
  const auto* i32 = idx_bytes == 4 ? static_cast<const int*>(idx) : nullptr;
  const long long round_end = it0 + seg - 1;
  auto* ls = static_cast<unsigned long long*>(lane_steps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_family(family, 0, [&](auto f, auto) {
    constexpr int F = decltype(f)::value;
    auto* kernel = ls ? escape_resume_kernel<F, true>
                      : escape_resume_kernel<F, false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<float*>(zr), static_cast<float*>(zi),
        static_cast<int*>(n), static_cast<int*>(act),
        static_cast<const float*>(cr), static_cast<const float*>(ci),
        static_cast<const int*>(dyn), i64, i32, lanes, it0, round_end, power,
        ls);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
