// Run-length codec, native fast path.
//
// Same record format as the Python codec (codecs/rle.py) and the reference
// (DistributedMandelbrot/DataChunkSerializer.cs:51-142): little-endian
// uint32 run length + uint8 value per record.  This file assumes a
// little-endian host (x86/ARM/TPU VM hosts all qualify); the Python layer
// keeps using the portable numpy path on anything else.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {
constexpr std::size_t kRecordSize = 5;
}

extern "C" {

// Number of bytes rle_encode would write for `n` input bytes.
std::size_t dmtpu_rle_encoded_size(const std::uint8_t* data, std::size_t n) {
    if (n == 0) return 0;
    std::size_t runs = 1;
    for (std::size_t i = 1; i < n; ++i) runs += (data[i] != data[i - 1]);
    return runs * kRecordSize;
}

// Encode into `out` (capacity `out_cap`); returns bytes written, or 0 if
// the capacity is insufficient or n == 0.
std::size_t dmtpu_rle_encode(const std::uint8_t* data, std::size_t n,
                             std::uint8_t* out, std::size_t out_cap) {
    if (n == 0) return 0;
    std::size_t pos = 0;
    std::size_t run_start = 0;
    for (std::size_t i = 1; i <= n; ++i) {
        if (i == n || data[i] != data[run_start]) {
            if (pos + kRecordSize > out_cap) return 0;
            std::uint32_t len = static_cast<std::uint32_t>(i - run_start);
            std::memcpy(out + pos, &len, 4);
            out[pos + 4] = data[run_start];
            pos += kRecordSize;
            run_start = i;
        }
    }
    return pos;
}

// Decode `body` into exactly `out_len` bytes.  Returns 0 on success,
// -1 malformed body length, -2 zero-length run, -3 output overflow,
// -4 output underfill.
int dmtpu_rle_decode(const std::uint8_t* body, std::size_t body_len,
                     std::uint8_t* out, std::size_t out_len) {
    if (body_len % kRecordSize != 0) return -1;
    std::size_t pos = 0;
    for (std::size_t i = 0; i < body_len; i += kRecordSize) {
        std::uint32_t len;
        std::memcpy(&len, body + i, 4);
        if (len == 0) return -2;
        if (pos + len > out_len) return -3;
        std::memset(out + pos, body[i + 4], len);
        pos += len;
    }
    return pos == out_len ? 0 : -4;
}

}  // extern "C"
