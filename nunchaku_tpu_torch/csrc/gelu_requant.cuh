// The requantize pass of the GELU -> requantize chain producer (kernel B of
// gemm_w8a8_gelu_quant.cu, row 2; also run after the pipelined producer,
// gemm_w8a8_gelu_quant_pipe.cu, row 14): per row, the max over the tiles of
// each bn-wide group of the tile maxima kernel A wrote, the scale max / 127
// (a multiply by f32(1/127), as XLA compiles it) and the group's codes
// clip(round_half_even(((g + shift) * rsmooth) * rcp(scale)), +-127) from the
// f32 g workspace; and lora_next, each output the sum of its per-tile
// partials in ascending tile order from zero.
#pragma once

#include "common.cuh"

namespace {

constexpr int RQ_THREADS = 256;
constexpr int MAX_GROUPS = 256;
constexpr int RQ_TILE = 128;  // columns of the tiles whose maxima and partials kernel A wrote

__global__ void __launch_bounds__(RQ_THREADS)
    requant_kernel(const float* __restrict__ g, const float* __restrict__ rsm,
                   const float* __restrict__ amax_part, const float* __restrict__ lora_part,
                   int8_t* __restrict__ qout, float* __restrict__ qscales,
                   float* __restrict__ lora_next, int M, int N, int R2, int bn, float shift) {
  __shared__ float rcp_s[MAX_GROUPS];
  const int R2p = (R2 + 15) / 16 * 16;
  const int m = blockIdx.x;
  const int tiles = N / RQ_TILE, tiles_per_group = bn / RQ_TILE, groups = N / bn;
  for (int j = threadIdx.x; j < groups; j += RQ_THREADS) {
    float mx = 0.f;
    for (int t = j * tiles_per_group; t < (j + 1) * tiles_per_group; ++t)
      mx = fmaxf(mx, amax_part[static_cast<size_t>(t) * M + m]);
    // max|h| / 127 as XLA compiles it: a multiply by the f32 reciprocal of 127
    const float scale = __fmul_rn(mx, 1.0f / 127.0f);
    rcp_s[j] = scale == 0.f ? 0.f : __fdiv_rn(1.0f, scale);
    qscales[static_cast<size_t>(j) * M + m] = scale;
  }
  for (int r = threadIdx.x; r < R2; r += RQ_THREADS) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s = __fadd_rn(s, lora_part[(static_cast<size_t>(t) * M + m) * R2p + r]);
    lora_next[static_cast<size_t>(m) * R2 + r] = s;
  }
  __syncthreads();
  const float4* grow = reinterpret_cast<const float4*>(g + static_cast<size_t>(m) * N);
  const float4* rs4 = reinterpret_cast<const float4*>(rsm);
  char4* qrow = reinterpret_cast<char4*>(qout + static_cast<size_t>(m) * N);
  for (int v = threadIdx.x; v < N / 4; v += RQ_THREADS) {
    const float4 gv = grow[v], rv = rs4[v];
    const float rc = rcp_s[(v * 4) / bn];
    const float gg[4] = {gv.x, gv.y, gv.z, gv.w}, rr[4] = {rv.x, rv.y, rv.z, rv.w};
    signed char q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = __fmul_rn(__fadd_rn(gg[i], shift), rr[i]);
      q[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(h, rc)), -127.f), 127.f));
    }
    qrow[v] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

// Kernel B on kernel A's workspace: g (M, N) f32, amax_part (N/128, M) f32, lora_part (N/128, M, R2p) f32.
int requant(const void* gbuf, const void* rsmooth, const void* amax_part, const void* lora_part, void* qout,
            void* qscales, void* lora_next, int M, int N, int R2, int bn, float shift, cudaStream_t s) {
  requant_kernel<<<M, RQ_THREADS, 0, s>>>(
      static_cast<const float*>(gbuf), static_cast<const float*>(rsmooth),
      static_cast<const float*>(amax_part), static_cast<const float*>(lora_part),
      static_cast<int8_t*>(qout), static_cast<float*>(qscales), static_cast<float*>(lora_next), M,
      N, R2, bn, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
