// Arbitrary-precision fixed-point escape kernels, native CPU path.
//
// Exact replacements for the Python-bigint loops in ops/perturbation.py
// (_escape_count_fixed, _orbit_fixed): the per-pixel glitch repair and
// the reference-orbit computation are the only host-side hot loops in
// the deep-zoom path, and CPython bigints pay ~1.6 us per iteration in
// interpreter overhead where these limb loops pay tens of ns.
//
// Numbers are sign-magnitude, little-endian uint64 limbs.  Parity with
// Python's arbitrary-precision semantics is exact by construction:
//   - magnitudes never overflow their buffers (the caller sizes limb
//     counts from the algebraic bounds: values stay under 2^(bits+4)
//     in the bailout-4 count kernel and under 10^100 * 2^bits in the
//     orbit kernel, whose extension stops at the `huge` threshold);
//   - Python's `>>` on negatives is floor division, reproduced here as
//     truncate-toward-zero on the magnitude plus one when any dropped
//     bit was set;
//   - fixed -> float64 conversion mirrors _fixed_to_float's explicit
//     round-to-nearest (ties away from zero on the magnitude, exactly
//     as `(m + (1 << (shift-1))) >> shift` behaves).
//
// All scratch lives on the stack/heap per call; every entry point is
// pure and thread-safe.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

// magnitude helpers ------------------------------------------------------

inline int mag_cmp(const u64* x, const u64* y, int n) {
    for (int i = n - 1; i >= 0; --i) {
        if (x[i] != y[i]) return x[i] < y[i] ? -1 : 1;
    }
    return 0;
}

inline bool mag_is_zero(const u64* x, int n) {
    for (int i = 0; i < n; ++i)
        if (x[i]) return false;
    return true;
}

// dst = x + y (all n limbs); returns the carry out.
inline u64 mag_add(u64* dst, const u64* x, const u64* y, int n) {
    u64 carry = 0;
    for (int i = 0; i < n; ++i) {
        u128 s = (u128)x[i] + y[i] + carry;
        dst[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    return carry;
}

// dst = x - y, requires x >= y.
inline void mag_sub(u64* dst, const u64* x, const u64* y, int n) {
    u64 borrow = 0;
    for (int i = 0; i < n; ++i) {
        u64 yi = y[i];
        u64 xi = x[i];
        u64 d = xi - yi - borrow;
        borrow = (xi < yi || (borrow && xi == yi)) ? 1 : 0;
        dst[i] = d;
    }
}

// dst[2n] = x[n] * y[n] (schoolbook; dst must not alias x/y).
inline void mag_mul(u64* dst, const u64* x, const u64* y, int n) {
    std::memset(dst, 0, sizeof(u64) * 2 * n);
    for (int i = 0; i < n; ++i) {
        if (!x[i]) continue;
        u64 carry = 0;
        for (int j = 0; j < n; ++j) {
            u128 cur = (u128)x[i] * y[j] + dst[i + j] + carry;
            dst[i + j] = (u64)cur;
            carry = (u64)(cur >> 64);
        }
        dst[i + n] = carry;
    }
}

// dst[dst_n] = src[src_n] >> shift on the magnitude, reporting whether
// any dropped bit was set (the floor-correction signal for negatives).
inline bool mag_shr(u64* dst, int dst_n, const u64* src, int src_n,
                    int shift) {
    const int limb = shift / 64;
    const int bit = shift % 64;
    bool dropped = false;
    for (int i = 0; i < limb && i < src_n; ++i)
        if (src[i]) dropped = true;
    if (bit && limb < src_n && (src[limb] & ((u64(1) << bit) - 1)))
        dropped = true;
    for (int i = 0; i < dst_n; ++i) {
        const int lo = i + limb;
        u64 v = lo < src_n ? src[lo] : 0;
        if (bit) {
            v >>= bit;
            if (lo + 1 < src_n) v |= src[lo + 1] << (64 - bit);
        }
        dst[i] = v;
    }
    return dropped;
}

// dst += 1 (n limbs).
inline void mag_inc(u64* dst, int n) {
    for (int i = 0; i < n; ++i) {
        if (++dst[i]) return;
    }
}

// signed helpers (sign-magnitude; neg is meaningless when mag == 0) ------

// dst = x + y with signs; n limbs each; dst may alias x.
inline void signed_add(u64* dst, bool* dst_neg, const u64* x, bool x_neg,
                       const u64* y, bool y_neg, int n) {
    if (x_neg == y_neg) {
        mag_add(dst, x, y, n);
        *dst_neg = x_neg;
        return;
    }
    const int c = mag_cmp(x, y, n);
    if (c >= 0) {
        mag_sub(dst, x, y, n);
        *dst_neg = c == 0 ? false : x_neg;
    } else {
        mag_sub(dst, y, x, n);
        *dst_neg = y_neg;
    }
}

// Python floor-shift of a signed value: truncate the magnitude, then
// add one when negative and any dropped bit was set.
inline void signed_shr(u64* dst, int dst_n, const u64* src, int src_n,
                       bool neg, int shift) {
    const bool dropped = mag_shr(dst, dst_n, src, src_n, shift);
    if (neg && dropped) mag_inc(dst, dst_n);
}

inline int bit_length(const u64* x, int n) {
    for (int i = n - 1; i >= 0; --i) {
        if (x[i]) return 64 * i + (64 - __builtin_clzll(x[i]));
    }
    return 0;
}

// _fixed_to_float parity: round-to-nearest (ties away from zero) of the
// magnitude to 53 significant bits, then ldexp.
inline double fixed_to_double(const u64* mag, int n, bool neg, int bits) {
    const int bl = bit_length(mag, n);
    if (bl == 0) return 0.0;
    double out;
    if (bl > 53) {
        const int shift = bl - 53;
        // m2 = (m + (1 << (shift-1))) >> shift without a full-width
        // add: shift first, then increment when the dropped prefix
        // means the rounding constant carries into the kept window.
        // Adding 1 << (shift-1) flips the bit at shift-1; the result's
        // kept window increments iff that bit was already 1.
        const int limb = (shift - 1) / 64;
        const int bit = (shift - 1) % 64;
        u64 kept[2] = {0, 0};
        mag_shr(kept, 2, mag, n, shift);
        const bool round_up = limb < n && (mag[limb] >> bit) & 1;
        u128 m2 = ((u128)kept[1] << 64) | kept[0];
        if (round_up) m2 += 1;
        out = std::ldexp((double)(u64)(m2 & ~u64(0)) +
                             std::ldexp((double)(u64)(m2 >> 64), 64),
                         shift - bits);
    } else {
        u128 m = ((u128)(n > 1 ? mag[1] : 0) << 64) | mag[0];
        out = std::ldexp((double)(u64)(m & ~u64(0)) +
                             std::ldexp((double)(u64)(m >> 64), 64),
                         -bits);
    }
    return neg ? -out : out;
}

// One reference-convention iteration shared by both kernels.  State a/b
// is n limbs; a2/b2/t/u are 2n-limb scratch.  Updates a, b in place:
//   a, b = ((a2 - b2) >> bits) + ca, ((a*b) >> (bits-1)) + cb
struct IterState {
    int n;
    int bits;
    std::vector<u64> a, b, na, nb;
    std::vector<u64> a2, b2, t, u, sum;
    bool a_neg = false, b_neg = false;

    IterState(int n_limbs, int bits_)
        : n(n_limbs), bits(bits_), a(n_limbs), b(n_limbs), na(n_limbs),
          nb(n_limbs), a2(2 * n_limbs), b2(2 * n_limbs), t(2 * n_limbs),
          u(2 * n_limbs), sum(2 * n_limbs + 1) {}

    void square_both() {
        mag_mul(a2.data(), a.data(), a.data(), n);
        mag_mul(b2.data(), b.data(), b.data(), n);
    }

    // a2 + b2 >= threshold?  threshold is 2n+1 limbs.
    bool mag2_at_least(const u64* threshold) {
        sum[2 * n] = mag_add(sum.data(), a2.data(), b2.data(), 2 * n);
        return mag_cmp(sum.data(), threshold, 2 * n + 1) >= 0;
    }

    void update(const u64* ca, bool ca_neg, const u64* cb, bool cb_neg) {
        // t = a2 - b2 (signed; squares are non-negative)
        bool t_neg;
        const int c = mag_cmp(a2.data(), b2.data(), 2 * n);
        if (c >= 0) {
            mag_sub(t.data(), a2.data(), b2.data(), 2 * n);
            t_neg = false;
        } else {
            mag_sub(t.data(), b2.data(), a2.data(), 2 * n);
            t_neg = true;
        }
        signed_shr(na.data(), n, t.data(), 2 * n, t_neg, bits);
        bool na_neg = t_neg && !mag_is_zero(na.data(), n);
        // u = a * b (signed)
        mag_mul(u.data(), a.data(), b.data(), n);
        const bool u_neg = (a_neg != b_neg) && !mag_is_zero(u.data(), 2 * n);
        signed_shr(nb.data(), n, u.data(), 2 * n, u_neg, bits - 1);
        bool nb_neg = u_neg && !mag_is_zero(nb.data(), n);
        signed_add(a.data(), &a_neg, na.data(), na_neg, ca, ca_neg, n);
        signed_add(b.data(), &b_neg, nb.data(), nb_neg, cb, cb_neg, n);
    }
};

}  // namespace

extern "C" {

// _escape_count_fixed parity: escape iteration in 1..max_iter-1, or 0 if
// the point never escaped bailout-4 within the budget.  All magnitudes
// are n_limbs little-endian uint64; `four` is 2*n_limbs+1 limbs holding
// 4 << (2*bits).  Caller guarantees n_limbs*64 >= bits + 64.
std::int32_t dmtpu_fixed_escape(
    const u64* za, std::int32_t za_neg, const u64* zb, std::int32_t zb_neg,
    const u64* ca, std::int32_t ca_neg, const u64* cb, std::int32_t cb_neg,
    const u64* four, std::int32_t n_limbs, std::int32_t bits,
    std::int32_t max_iter) {
    IterState s(n_limbs, bits);
    std::memcpy(s.a.data(), za, sizeof(u64) * n_limbs);
    std::memcpy(s.b.data(), zb, sizeof(u64) * n_limbs);
    s.a_neg = za_neg != 0;
    s.b_neg = zb_neg != 0;
    s.square_both();
    for (std::int32_t it = 1; it < max_iter; ++it) {
        s.update(ca, ca_neg != 0, cb, cb_neg != 0);
        s.square_both();
        if (s.mag2_at_least(four)) return it;
    }
    return 0;
}

// Batch of escape counts: k points, each with its own start (za, zb)
// packed as k consecutive n_limbs-limb magnitudes (+ per-point sign
// bytes).  Family selection: julia == 0 means Mandelbrot — each point's
// start doubles as its constant and the ca/cb arguments are ignored;
// julia == 1 means Julia — ca/cb is a SINGLE shared n_limbs-limb
// constant applied to every point.  Parallelized over n_threads (<= 0
// means hardware concurrency) — the glitch-repair exact loop hands over
// thousands of independent pixels at production tile sizes.
void dmtpu_fixed_escape_batch(
    const u64* za, const std::uint8_t* za_neg,
    const u64* zb, const std::uint8_t* zb_neg,
    const u64* ca, std::int32_t ca_neg,
    const u64* cb, std::int32_t cb_neg, std::int32_t julia,
    const u64* four, std::int32_t n_limbs, std::int32_t bits,
    std::int32_t max_iter, std::int32_t k, std::int32_t* out,
    std::int32_t n_threads) {
    unsigned hw = std::thread::hardware_concurrency();
    unsigned workers = n_threads > 0 ? static_cast<unsigned>(n_threads)
                                     : (hw ? hw : 1);
    if (k > 0 && workers > static_cast<unsigned>(k))
        workers = static_cast<unsigned>(k);
    auto run = [=](std::int32_t lo, std::int32_t hi) {
        for (std::int32_t i = lo; i < hi; ++i) {
            const u64* zai = za + (std::size_t)i * n_limbs;
            const u64* zbi = zb + (std::size_t)i * n_limbs;
            const u64* cai = julia ? ca : zai;
            const u64* cbi = julia ? cb : zbi;
            const std::int32_t cani = julia ? ca_neg : za_neg[i];
            const std::int32_t cbni = julia ? cb_neg : zb_neg[i];
            out[i] = dmtpu_fixed_escape(zai, za_neg[i], zbi, zb_neg[i],
                                        cai, cani, cbi, cbni, four,
                                        n_limbs, bits, max_iter);
        }
    };
    if (workers <= 1) {
        run(0, k);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(workers);
    const std::int32_t stride = (k + (std::int32_t)workers - 1)
                                / (std::int32_t)workers;
    for (unsigned t = 0; t < workers; ++t) {
        const std::int32_t lo = (std::int32_t)t * stride;
        const std::int32_t hi = lo + stride < k ? lo + stride : k;
        if (lo >= hi) break;
        threads.emplace_back([=] { run(lo, hi); });
    }
    for (auto& th : threads) th.join();
}

// _orbit_fixed parity: emits float64 orbit entries z_1.. into z_re/z_im
// (capacity max(1, max_iter) + extra each), stopping `extra` entries
// past the first bailout-4 escape or earlier at the `huge` overflow
// threshold (10^100 << 2*bits, 2*n_limbs+1 limbs, matching the Python
// loop).  Returns the number of entries written; *valid_out receives
// the tested-orbit length.  Caller guarantees n_limbs*64 is comfortably
// above bits + 400 (values reach ~10^100 * 2^bits before the stop).
std::int32_t dmtpu_fixed_orbit(
    const u64* za, std::int32_t za_neg, const u64* zb, std::int32_t zb_neg,
    const u64* ca, std::int32_t ca_neg, const u64* cb, std::int32_t cb_neg,
    const u64* four, const u64* huge, std::int32_t n_limbs,
    std::int32_t bits, std::int32_t max_iter, std::int32_t extra,
    double* z_re, double* z_im, std::int32_t* valid_out) {
    const std::int32_t steps = max_iter > 1 ? max_iter : 1;
    IterState s(n_limbs, bits);
    std::memcpy(s.a.data(), za, sizeof(u64) * n_limbs);
    std::memcpy(s.b.data(), zb, sizeof(u64) * n_limbs);
    s.a_neg = za_neg != 0;
    s.b_neg = zb_neg != 0;
    std::int32_t n = 0;
    std::int32_t valid = -1;
    while (n < steps + extra) {
        z_re[n] = fixed_to_double(s.a.data(), n_limbs, s.a_neg, bits);
        z_im[n] = fixed_to_double(s.b.data(), n_limbs, s.b_neg, bits);
        ++n;
        s.square_both();
        if (valid < 0 && (n >= steps || s.mag2_at_least(four))) valid = n;
        if (valid >= 0 && (n >= valid + extra || s.mag2_at_least(huge)))
            break;
        s.update(ca, ca_neg != 0, cb, cb_neg != 0);
    }
    *valid_out = valid >= 0 ? valid : n;
    return n;
}

}  // extern "C"
