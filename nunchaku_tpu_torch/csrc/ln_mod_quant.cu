// LayerNorm + AdaLN modulate + per-token int8 quantize, with the next
// layer's low-rank down-projection (the bf16-stream producer in front of
// every qkv projection and fc1).
//
// Replaces nunchaku_tpu/ops/quantize.py _ln_mod_quant_kernel (:149,
// launched by ln_mod_quant_int8 :179):
//   y = (x - mean) * rsqrt(var + 1e-6) [* (1 + scale[b]) + shift[b]]   (f32)
//   lora_act = bf16(y) @ proj_down;  h = y * rsmooth
//   scale = max|h| * f32(1/127);  q = clip(round_half_even(h * rcp(scale)), +-127)
// (XLA compiles the JAX kernel's `absmax / 127.0` as a multiply by the f32
// reciprocal of 127; so does this kernel.)
//
// Bound on the H100: bytes. Per token it reads K bf16 and writes K int8 plus
// R + 1 floats (3 bytes per element at R = 32, K = 3072); the rank-R product
// is 2*K*R operations per token, far below the tensor cores' ridge. Design:
// a block takes 16 tokens, a warp one token at a time with the whole row in
// registers (K / 256 16-byte vectors per lane), so x is read from device
// memory once; the two LayerNorm reductions and the absmax are warp
// shuffles. bf16(y) of the 16 tokens goes to shared memory, where the
// eight warps multiply it by proj_down on the tensor cores (WMMA bf16, each
// warp one eighth of K, proj_down's fragments read from L2) and sum their
// partials in warp order. The JAX kernel's per-block f32 LN temporaries
// never leave registers here.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int ROWS = 16, THREADS = 256, WARPS = THREADS / 32;
constexpr float EPS = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 floats from a 32-byte-aligned address
__device__ __forceinline__ void load8(float (&d)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p), hi = *reinterpret_cast<const float4*>(p + 4);
  d[0] = lo.x, d[1] = lo.y, d[2] = lo.z, d[3] = lo.w, d[4] = hi.x, d[5] = hi.y, d[6] = hi.z, d[7] = hi.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// NV: 16-byte vectors (8 bf16) per lane, K = 256 * NV.
template <int NV>
__global__ void __launch_bounds__(THREADS)
    ln_mod_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ sc,
                        const float* __restrict__ sh, int ld, const bf16* __restrict__ smooth,
                        const bf16* __restrict__ pd, int8_t* __restrict__ q, float* __restrict__ asc,
                        float* __restrict__ la, int M, int S, int R) {
  constexpr int K = 256 * NV, LDY = K + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ytile = reinterpret_cast<bf16*>(smem_raw);                                    // [ROWS][LDY]
  float* rsm = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * ROWS * LDY);         // [K]
  float* part = reinterpret_cast<float*>(smem_raw);  // [WARPS][ROWS][32], after the product
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;

  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float s = smooth == nullptr ? 1.f : bf2f(smooth[k]);
    rsm[k] = s == 0.f ? 1.f : __fdiv_rn(1.f, s);
  }
  __syncthreads();

  for (int lr = warp; lr < ROWS; lr += WARPS) {
    const int row = row0 + lr;
    bf16* yrow = ytile + lr * LDY;
    if (row >= M) {
      for (int j = 0; j < NV; ++j) *reinterpret_cast<uint4*>(yrow + (lane + 32 * j) * 8) = make_uint4(0, 0, 0, 0);
      continue;
    }
    float v[NV][8];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K + (lane + 32 * j) * 8);
      const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[j][i] = bf2f(p[i]);
        s = __fadd_rn(s, v[j][i]);
      }
    }
    const float mu = __fdiv_rn(warp_sum(s), static_cast<float>(K));
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[j][i] = __fsub_rn(v[j][i], mu);
        s2 = __fadd_rn(s2, __fmul_rn(v[j][i], v[j][i]));
      }
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(s2), static_cast<float>(K)), EPS));
    const int b = row / S;
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int k0 = (lane + 32 * j) * 8;
      float a[8], c[8], r[8];
      load8(r, rsm + k0);
      if (sc != nullptr) {
        load8(a, sc + static_cast<size_t>(b) * ld + k0);
        load8(c, sh + static_cast<size_t>(b) * ld + k0);
      }
      uint4 packed;
      bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = __fmul_rn(v[j][i], rstd);
        if (sc != nullptr) y = __fmaf_rn(y, __fadd_rn(1.f, a[i]), c[i]);
        pb[i] = __float2bfloat16(y);
        v[j][i] = __fmul_rn(y, r[i]);  // h
        amax = fmaxf(amax, fabsf(v[j][i]));
      }
      *reinterpret_cast<uint4*>(yrow + k0) = packed;
    }
    const float scale = __fmul_rn(warp_max(amax), 1.0f / 127.0f);
    const float rc = scale == 0.f ? 0.f : __fdiv_rn(1.f, scale);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      uint2 packed;
      signed char* pq = reinterpret_cast<signed char*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pq[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(v[j][i], rc)), -127.f), 127.f));
      *reinterpret_cast<uint2*>(q + static_cast<size_t>(row) * K + (lane + 32 * j) * 8) = packed;
    }
    if (lane == 0) asc[row] = scale;
  }
  __syncthreads();

  // lora partial of this warp's K slice: ytile[16, kslice] @ pd[kslice, R]
  constexpr int KW = K / WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int kk = warp * KW; kk < (warp + 1) * KW; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, ytile + kk, LDY);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j * 16 < R) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, pd + static_cast<size_t>(kk) * R + j * 16, R);
        wmma::mma_sync(acc[j], a, bfr, acc[j]);
      }
    }
  }
  __syncthreads();  // the y tile is read; its memory now takes the partials
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (j * 16 < R) wmma::store_matrix_sync(part + warp * ROWS * 32 + j * 16, acc[j], 32, wmma::mem_row_major);
  __syncthreads();
  for (int t = threadIdx.x; t < ROWS * R; t += THREADS) {
    const int r = t / R, c = t % R;
    if (row0 + r >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, part[(w * ROWS + r) * 32 + c]);
    la[static_cast<size_t>(row0 + r) * R + c] = s;
  }
}

template <int NV>
int launch(const void* x, const void* sc, const void* sh, int ld, const void* smooth, const void* pd,
           void* q, void* asc, void* la, int M, int S, int R, cudaStream_t stream) {
  constexpr int K = 256 * NV;
  const size_t tile = sizeof(bf16) * ROWS * (K + 8) + sizeof(float) * K;
  const size_t part = sizeof(float) * WARPS * ROWS * 32;
  const int smem = static_cast<int>(tile > part ? tile : part);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ln_mod_quant_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ln_mod_quant_kernel<NV><<<(M + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(sc), static_cast<const float*>(sh), ld,
      static_cast<const bf16*>(smooth), static_cast<const bf16*>(pd), static_cast<int8_t*>(q),
      static_cast<float*>(asc), static_cast<float*>(la), M, S, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 (M = B*S rows of a (B, S, K) stream), mod scale / shift:
// rows of ld floats, row b = batch b, or both null (LayerNorm only),
// smooth (K,) bf16 | null, proj_down (K, R) bf16
// -> q (M, K) int8, ascales (M,) f32, lora_act (M, R) f32.
// Needs K % 256 == 0, K <= 3072, R in {16, 32}.
extern "C" int nt_ln_mod_quant(const void* x, const void* mod_scale, const void* mod_shift, int ld,
                               const void* smooth, const void* proj_down, void* q, void* ascales,
                               void* lora_act, int M, int S, int K, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 256 != 0 || (R != 16 && R != 32)) return static_cast<int>(cudaErrorInvalidValue);
  switch (K / 256) {
#define NT_LNQ_CASE(nv) \
  case nv:              \
    return launch<nv>(x, mod_scale, mod_shift, ld, smooth, proj_down, q, ascales, lora_act, M, S, R, s);
    NT_LNQ_CASE(1) NT_LNQ_CASE(2) NT_LNQ_CASE(3) NT_LNQ_CASE(4) NT_LNQ_CASE(5) NT_LNQ_CASE(6)
    NT_LNQ_CASE(7) NT_LNQ_CASE(8) NT_LNQ_CASE(9) NT_LNQ_CASE(10) NT_LNQ_CASE(11) NT_LNQ_CASE(12)
#undef NT_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
