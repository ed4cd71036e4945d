// 4-bit weight code decode of the w4a8 dequant kernel (dequant_w4a8.cu):
// every route turns a code into the same int8 value,
// clip(round_half_even(f32(value) * f32(rescale)), -127, 127). The GEMMs
// that decode packed int4 weights inside their main loop (gemm_w4a8.cu and
// the W4 form of gemm_w8a8_gelu_quant.cu, through gemm_sm90.cuh's W4Src)
// look the values up in 16-entry tables that w4_table fills with the same
// values (rescale_code<false> of each code).
#pragma once

#include "common.cuh"

// byte of a packed row -> its low or high nibble, sign-extended: packed row
// 128 b + j holds logical row 256 b + j in the low nibble and 256 b + 128 + j
// in the high one (core/packing.py's block-split-half layout)
__device__ __forceinline__ int nibble(int byte, bool hi) {
  return ((((hi ? byte >> 4 : byte) & 0xF) ^ 8) - 8);
}

// signed 4-bit code -> its value: the integer itself, or the e2m1 decode
// |v| = m / 2 for e == 0, else (1 + m / 2) 2^(e - 1), e = |c| >> 1, m = |c| & 1
template <bool E2M1>
__device__ __forceinline__ float code_value(int c) {
  if (!E2M1) return static_cast<float>(c);
  const int a = abs(c), e = a >> 1;
  const float m = static_cast<float>(a & 1);
  const float mag = e == 0 ? 0.5f * m : (1.0f + 0.5f * m) * static_cast<float>(1 << (e - 1));
  return c < 0 ? -mag : mag;
}

template <bool E2M1>
__device__ __forceinline__ int8_t rescale_code(int nib, float rs) {
  int q = __float2int_rn(__fmul_rn(code_value<E2M1>(nib), rs));
  return static_cast<int8_t>(max(-127, min(127, q)));
}
