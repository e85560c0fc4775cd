// Host stand-in for the CUDA toolkit's <cuda_bf16.h>, enough for
// escape.cuh to build with a host C++ compiler (host/step_groups.cpp).
// Each bf16 operation computes in f32 and rounds once to bf16 (round to
// nearest, ties to even), as PyTorch's bf16 ops do and as the card's
// correctly rounded intrinsics give (escape.cuh, scout_escapes).
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN: keep it quiet
    return __nv_bfloat16{static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}

inline __nv_bfloat16 __hmul(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) * __bfloat162float(b));
}
inline __nv_bfloat16 __hadd(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}
inline __nv_bfloat16 __hsub(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) - __bfloat162float(b));
}
inline __nv_bfloat16 __habs(__nv_bfloat16 a) {
  return __nv_bfloat16{static_cast<uint16_t>(a.bits & 0x7fffu)};
}
