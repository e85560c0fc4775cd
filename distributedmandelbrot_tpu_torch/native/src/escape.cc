// Escape-time kernel, native CPU path.
//
// The framework's bit-exact *and fast* CPU compute: per-pixel early exit
// (impossible on SIMD accelerators), scalar IEEE float64 with FP
// contraction disabled at build time (-ffp-contract=off), so results are
// bit-identical to the numpy golden (ops/reference.py) and to the
// reference semantics (DistributedMandelbrotWorkerCUDA.py:39-68): z starts
// at c, iterations count 1..max_iter-1, post-update bailout |z|^2 >= 4,
// 0 if never escaped.  uint8 scaling is exact integer ceil-division with
// the reference's wrap at 256 (or clamp to 255 in quality mode).
//
// The caller supplies the coordinate arrays (numpy linspace grids), keeping
// endpoint arithmetic bit-identical to the golden path.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Closed-form interior test (main cardioid + period-2 bulb), strict by a
// margin far above the expression's f64 rounding error, so a true result
// PROVES the exact orbit never escapes — returning 0 without iterating is
// output-identical to the full loop (mirrors
// ops/escape_time.py:mandelbrot_interior; see there for the margin math).
// This is where set-crossing tiles spend ~90%+ of their iteration budget.
inline bool provably_interior(double cr, double ci) {
    const double margin = 1e-12;
    const double y2 = ci * ci;
    const double xm = cr - 0.25;
    const double q = xm * xm + y2;
    if (q * (q + xm) < 0.25 * y2 - margin) return true;  // main cardioid
    const double xp = cr + 1.0;
    return xp * xp + y2 < 0.0625 - margin;  // period-2 bulb
}

inline std::int32_t escape_iter(double cr, double ci, std::int32_t max_iter) {
    if (provably_interior(cr, ci)) return 0;
    double zr = cr;
    double zi = ci;
    for (std::int32_t it = 1; it < max_iter; ++it) {
        const double new_zr = zr * zr - zi * zi + cr;
        const double new_zi = 2.0 * zr * zi + ci;
        zr = new_zr;
        zi = new_zi;
        if (zr * zr + zi * zi >= 4.0) return it;
    }
    return 0;
}

inline std::uint8_t scale_value(std::int64_t v, std::int64_t max_iter,
                                bool clamp) {
    std::int64_t scaled = (v * 256 + max_iter - 1) / max_iter;
    if (clamp && scaled > 255) scaled = 255;
    return static_cast<std::uint8_t>(scaled & 0xFF);
}

}  // namespace

extern "C" {

// Compute pixels for `n` points; parallelized over `n_threads` (<=0 means
// hardware concurrency).
void dmtpu_escape_pixels_f64(const double* c_real, const double* c_imag,
                             std::size_t n, std::int32_t max_iter,
                             int clamp, std::uint8_t* out, int n_threads) {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned workers = n_threads > 0 ? static_cast<unsigned>(n_threads)
                                     : (hw ? hw : 1);
    if (workers > n && n > 0) workers = static_cast<unsigned>(n);
    if (workers <= 1) {
        for (std::size_t i = 0; i < n; ++i)
            out[i] = scale_value(escape_iter(c_real[i], c_imag[i], max_iter),
                                 max_iter, clamp != 0);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(workers);
    const std::size_t stride = (n + workers - 1) / workers;
    for (unsigned t = 0; t < workers; ++t) {
        const std::size_t lo = t * stride;
        const std::size_t hi = lo + stride < n ? lo + stride : n;
        if (lo >= hi) break;
        threads.emplace_back([=] {
            for (std::size_t i = lo; i < hi; ++i)
                out[i] = scale_value(
                    escape_iter(c_real[i], c_imag[i], max_iter),
                    max_iter, clamp != 0);
        });
    }
    for (auto& th : threads) th.join();
}

// Raw escape iteration counts (no uint8 scaling) — for smooth coloring and
// analysis paths.
void dmtpu_escape_counts_f64(const double* c_real, const double* c_imag,
                             std::size_t n, std::int32_t max_iter,
                             std::int32_t* out, int n_threads) {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned workers = n_threads > 0 ? static_cast<unsigned>(n_threads)
                                     : (hw ? hw : 1);
    if (workers > n && n > 0) workers = static_cast<unsigned>(n);
    if (workers <= 1) {
        for (std::size_t i = 0; i < n; ++i)
            out[i] = escape_iter(c_real[i], c_imag[i], max_iter);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(workers);
    const std::size_t stride = (n + workers - 1) / workers;
    for (unsigned t = 0; t < workers; ++t) {
        const std::size_t lo = t * stride;
        const std::size_t hi = lo + stride < n ? lo + stride : n;
        if (lo >= hi) break;
        threads.emplace_back([=] {
            for (std::size_t i = lo; i < hi; ++i)
                out[i] = escape_iter(c_real[i], c_imag[i], max_iter);
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
