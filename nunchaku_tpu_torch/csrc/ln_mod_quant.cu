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
// never leave registers here. The rank R is any multiple of 16 (the wrapper
// pads proj_down's columns): a warp holds R / 16 WMMA accumulators, two at
// R <= 32 (the instantiation these kernels had when they took only R 16 /
// 32, unchanged), eight above, and the warps' partials, [WARPS][ROWS][R]
// floats (64 KB a head at R 128), take the dynamic shared memory the y tile
// leaves behind. Above 128 the product runs in chunks of 128 columns, one
// head after the other, the partials of a chunk placed after the y tile
// (which every chunk reads again). Each lora_act element is the same sum in
// the same order at any R.
//
// Dual mode (DUAL = true): replaces _ln_mod_quant2_kernel (:265, launched by
// ln_mod_quant_int8_dual :292), FLUX's single block, where one modulated
// norm feeds both the qkv and the fc1 projection, each with its own smooth
// factor and proj_down. One read of x and one LayerNorm (the modulation is
// required, as in JAX); then each head's epilogue is the single mode's: h =
// y * rsmooth, its absmax, scale and codes, and bf16(y) @ proj_down on the
// shared y tile. y stays in registers and each head's h is recomputed from
// it with the same multiply, so every output of a head is bit for bit a
// single-mode launch with that head's operands. Bound: bytes, one K-wide
// bf16 read against two int8 writes (4 bytes per element), where two
// single launches read x twice (6).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int ROWS = 16, THREADS = 256, WARPS = THREADS / 32;
constexpr int RANK_CHUNK = 128;  // columns of the low-rank product a pass above rank 128
constexpr float EPS = 1e-6f;

// bytes of the y tile and the smooth factors
template <int NV, bool DUAL>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(bf16) * ROWS * (256 * NV + 8) + sizeof(float) * 256 * NV * (DUAL ? 2 : 1);
}

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

// One head's epilogue operands and outputs (the dual mode's second head).
struct Head {
  const bf16* smooth;  // (K,) | null
  const bf16* pd;      // (K, R) bf16
  int8_t* q;           // (M, K)
  float* asc;          // (M,)
  float* la;           // (M, R)
  int R;
};

__device__ __forceinline__ float rsmooth(const bf16* smooth, int k) {
  const float s = smooth == nullptr ? 1.f : bf2f(smooth[k]);
  return s == 0.f ? 1.f : __fdiv_rn(1.f, s);
}

// codes of one 8-element vector: clip(round_half_even(y * r * rc), +-127)
__device__ __forceinline__ uint2 quant8(const float (&y)[8], const float (&r)[8], float rc) {
  uint2 packed;
  signed char* pq = reinterpret_cast<signed char*>(&packed);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    pq[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(__fmul_rn(y[i], r[i]), rc)), -127.f), 127.f));
  return packed;
}

// The lora partial of this warp's K slice, ytile[16, kslice] @ pd[kslice, :R],
// into R / 16 of NJ 16-column accumulators (R a multiple of 16, R <= 16 NJ;
// pd's rows ldp apart).
template <int K, int NJ>
__device__ __forceinline__ void lora_partial(wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[NJ],
                                             const bf16* ytile, const bf16* pd, int ldp, int R, int warp) {
  constexpr int KW = K / WARPS, LDY = K + 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = warp * KW; kk < (warp + 1) * KW; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, ytile + kk, LDY);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j * 16 < R) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, pd + static_cast<size_t>(kk) * ldp + j * 16, ldp);
        wmma::mma_sync(acc[j], a, bfr, acc[j]);
      }
    }
  }
}

// This warp's partials into part ([WARPS][ROWS][R], row stride R).
template <int NJ>
__device__ __forceinline__ void lora_stash(float* part, wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[NJ],
                                           int R, int warp) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j * 16 < R) wmma::store_matrix_sync(part + warp * ROWS * R + j * 16, acc[j], R, wmma::mem_row_major);
}

// Sum the warps' partials (part: [WARPS][ROWS][R]) in warp order into la (rows ld apart).
__device__ __forceinline__ void lora_store(const float* part, float* la, int ld, int row0, int M, int R) {
  for (int t = threadIdx.x; t < ROWS * R; t += THREADS) {
    const int r = t / R, c = t % R;
    if (row0 + r >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s = __fadd_rn(s, part[(w * ROWS + r) * R + c]);
    la[static_cast<size_t>(row0 + r) * ld + c] = s;
  }
}

// NV: 16-byte vectors (8 bf16) per lane, K = 256 * NV. DUAL: a second head
// (hb) beside the first, the modulation required. NJ: 16-column lora
// accumulators a warp holds for each head (2: R <= 32; 8: R <= 128).
template <int NV, bool DUAL, int NJ>
__global__ void __launch_bounds__(THREADS)
    ln_mod_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ sc,
                        const float* __restrict__ sh, int ld, const bf16* __restrict__ smooth,
                        const bf16* __restrict__ pd, int8_t* __restrict__ q, float* __restrict__ asc,
                        float* __restrict__ la, int M, int S, int R, Head hb) {
  constexpr int K = 256 * NV, LDY = K + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ytile = reinterpret_cast<bf16*>(smem_raw);                                    // [ROWS][LDY]
  float* rsm = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * ROWS * LDY);         // [K]
  float* rsm_b = rsm + K;                            // [K], the second head's (DUAL)
  float* part = reinterpret_cast<float*>(smem_raw);  // [WARPS][ROWS][R], after the product
  float* part_b = part + WARPS * ROWS * R;           // the second head's [WARPS][ROWS][hb.R] (DUAL)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * ROWS;

  for (int k = threadIdx.x; k < K; k += THREADS) {
    rsm[k] = rsmooth(smooth, k);
    if constexpr (DUAL) rsm_b[k] = rsmooth(hb.smooth, k);
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
    if constexpr (DUAL) {
      float amax = 0.f, amax_b = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k0 = (lane + 32 * j) * 8;
        float a[8], c[8], r[8], rb[8];
        load8(a, sc + static_cast<size_t>(b) * ld + k0);
        load8(c, sh + static_cast<size_t>(b) * ld + k0);
        load8(r, rsm + k0);
        load8(rb, rsm_b + k0);
        uint4 packed;
        bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float y = __fmaf_rn(__fmul_rn(v[j][i], rstd), __fadd_rn(1.f, a[i]), c[i]);
          pb[i] = __float2bfloat16(y);
          v[j][i] = y;  // y itself: each head's h is y * rsmooth, recomputed below
          amax = fmaxf(amax, fabsf(__fmul_rn(y, r[i])));
          amax_b = fmaxf(amax_b, fabsf(__fmul_rn(y, rb[i])));
        }
        *reinterpret_cast<uint4*>(yrow + k0) = packed;
      }
      const float scale = __fmul_rn(warp_max(amax), 1.0f / 127.0f);
      const float scale_b = __fmul_rn(warp_max(amax_b), 1.0f / 127.0f);
      const float rc = scale == 0.f ? 0.f : __fdiv_rn(1.f, scale);
      const float rc_b = scale_b == 0.f ? 0.f : __fdiv_rn(1.f, scale_b);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int k0 = (lane + 32 * j) * 8;
        float r[8];
        load8(r, rsm + k0);
        *reinterpret_cast<uint2*>(q + static_cast<size_t>(row) * K + k0) = quant8(v[j], r, rc);
        load8(r, rsm_b + k0);
        *reinterpret_cast<uint2*>(hb.q + static_cast<size_t>(row) * K + k0) = quant8(v[j], r, rc_b);
      }
      if (lane == 0) {
        asc[row] = scale;
        hb.asc[row] = scale_b;
      }
      continue;
    }
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
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NJ], acc_b[DUAL ? NJ : 1];
  if (R <= 16 * NJ && (!DUAL || hb.R <= 16 * NJ)) {
    lora_partial<K, NJ>(acc, ytile, pd, R, R, warp);
    if constexpr (DUAL) lora_partial<K, NJ>(acc_b, ytile, hb.pd, hb.R, hb.R, warp);
    __syncthreads();  // the y tile is read; its memory now takes the partials
    lora_stash<NJ>(part, acc, R, warp);
    if constexpr (DUAL) lora_stash<NJ>(part_b, acc_b, hb.R, warp);
    __syncthreads();
    lora_store(part, la, R, row0, M, R);
    if constexpr (DUAL) lora_store(part_b, hb.la, hb.R, row0, M, hb.R);
    return;
  }
  // a rank above 16 NJ = 128: chunks of 128 columns of each head in turn, the partials after the y tile
  float* cpart = reinterpret_cast<float*>(smem_raw + tile_bytes<NV, DUAL>());
  for (int head = 0; head < (DUAL ? 2 : 1); ++head) {
    const bf16* hpd = head == 0 ? pd : hb.pd;
    float* hla = head == 0 ? la : hb.la;
    const int hr = head == 0 ? R : hb.R;
    for (int c0 = 0; c0 < hr; c0 += 16 * NJ) {
      const int rc = min(16 * NJ, hr - c0);
      lora_partial<K, NJ>(acc, ytile, hpd + c0, hr, rc, warp);
      lora_stash<NJ>(cpart, acc, rc, warp);
      __syncthreads();
      lora_store(cpart, hla + c0, hr, row0, M, rc);
      __syncthreads();  // the partials are read
    }
  }
}

// Dynamic shared memory: the y tile and the smooth factors, or the lora
// partials of rank(s) R (hb.R), whichever is larger; with a rank above 128,
// the y tile and the partials of one 128-column chunk after it.
template <int NV, bool DUAL>
constexpr size_t smem_bytes(int R, int Rb) {
  const size_t tile = tile_bytes<NV, DUAL>();
  if (R > RANK_CHUNK || (DUAL && Rb > RANK_CHUNK)) return tile + sizeof(float) * WARPS * ROWS * RANK_CHUNK;
  const size_t part = sizeof(float) * WARPS * ROWS * (R + (DUAL ? Rb : 0));
  return tile > part ? tile : part;
}

template <int NV, bool DUAL, int NJ>
int launch(const void* x, const void* sc, const void* sh, int ld, const void* smooth, const void* pd,
           void* q, void* asc, void* la, int M, int S, int R, const Head& hb, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {  // the limit for the largest ranks this instantiation takes (chunked above 128)
    size_t most = smem_bytes<NV, DUAL>(16 * NJ, 16 * NJ);
    if (NJ * 16 == RANK_CHUNK && smem_bytes<NV, DUAL>(RANK_CHUNK + 16, 0) > most)
      most = smem_bytes<NV, DUAL>(RANK_CHUNK + 16, 0);
    cudaError_t e = cudaFuncSetAttribute(ln_mod_quant_kernel<NV, DUAL, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int smem = static_cast<int>(smem_bytes<NV, DUAL>(R, hb.R));
  ln_mod_quant_kernel<NV, DUAL, NJ><<<(M + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(sc), static_cast<const float*>(sh), ld,
      static_cast<const bf16*>(smooth), static_cast<const bf16*>(pd), static_cast<int8_t*>(q),
      static_cast<float*>(asc), static_cast<float*>(la), M, S, R, hb);
  return static_cast<int>(cudaGetLastError());
}

// The rank step of the low-rank product: R a multiple of 16.
bool rank_ok(int R) { return R >= 16 && R % 16 == 0; }

// R <= 32 keeps two accumulators a warp (the kernel as it was built for R 16 / 32), larger ranks eight (chunks
// of 128 columns above 128).
template <int NV, bool DUAL>
int dispatch(const void* x, const void* sc, const void* sh, int ld, const void* smooth, const void* pd, void* q,
             void* asc, void* la, int M, int S, int R, const Head& hb, cudaStream_t stream) {
  return (R > 32 || hb.R > 32)
             ? launch<NV, DUAL, 8>(x, sc, sh, ld, smooth, pd, q, asc, la, M, S, R, hb, stream)
             : launch<NV, DUAL, 2>(x, sc, sh, ld, smooth, pd, q, asc, la, M, S, R, hb, stream);
}

}  // namespace

// x (M, K) bf16 (M = B*S rows of a (B, S, K) stream), mod scale / shift:
// rows of ld floats, row b = batch b, or both null (LayerNorm only),
// smooth (K,) bf16 | null, proj_down (K, R) bf16
// -> q (M, K) int8, ascales (M,) f32, lora_act (M, R) f32.
// Needs K % 256 == 0, K <= 3072, R a multiple of 16.
extern "C" int nt_ln_mod_quant(const void* x, const void* mod_scale, const void* mod_shift, int ld,
                               const void* smooth, const void* proj_down, void* q, void* ascales,
                               void* lora_act, int M, int S, int K, int R, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 256 != 0 || !rank_ok(R)) return static_cast<int>(cudaErrorInvalidValue);
  const Head none{};
  switch (K / 256) {
#define NT_LNQ_CASE(nv) \
  case nv:              \
    return dispatch<nv, false>(x, mod_scale, mod_shift, ld, smooth, proj_down, q, ascales, lora_act, M, S, R, none, s);
    NT_LNQ_CASE(1) NT_LNQ_CASE(2) NT_LNQ_CASE(3) NT_LNQ_CASE(4) NT_LNQ_CASE(5) NT_LNQ_CASE(6)
    NT_LNQ_CASE(7) NT_LNQ_CASE(8) NT_LNQ_CASE(9) NT_LNQ_CASE(10) NT_LNQ_CASE(11) NT_LNQ_CASE(12)
#undef NT_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dual mode: x and the modulation as above (both required), then two
// heads, each smooth (K,) bf16 | null and proj_down (K, R) bf16 -> q (M, K)
// int8, ascales (M,) f32, lora_act (M, R) f32. Needs K % 256 == 0, K <= 3072,
// each R a multiple of 16.
extern "C" int nt_ln_mod_quant_dual(const void* x, const void* mod_scale, const void* mod_shift, int ld,
                                    const void* smooth_a, const void* proj_down_a, void* q_a, void* ascales_a,
                                    void* lora_a, const void* smooth_b, const void* proj_down_b, void* q_b,
                                    void* ascales_b, void* lora_b, int M, int S, int K, int Ra, int Rb,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 256 != 0 || !rank_ok(Ra) || !rank_ok(Rb) || mod_scale == nullptr || mod_shift == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Head hb{static_cast<const bf16*>(smooth_b), static_cast<const bf16*>(proj_down_b),
                static_cast<int8_t*>(q_b), static_cast<float*>(ascales_b), static_cast<float*>(lora_b), Rb};
  switch (K / 256) {
#define NT_LNQ2_CASE(nv) \
  case nv:               \
    return dispatch<nv, true>(x, mod_scale, mod_shift, ld, smooth_a, proj_down_a, q_a, ascales_a, lora_a, M, S, Ra, hb, s);
    NT_LNQ2_CASE(1) NT_LNQ2_CASE(2) NT_LNQ2_CASE(3) NT_LNQ2_CASE(4) NT_LNQ2_CASE(5) NT_LNQ2_CASE(6)
    NT_LNQ2_CASE(7) NT_LNQ2_CASE(8) NT_LNQ2_CASE(9) NT_LNQ2_CASE(10) NT_LNQ2_CASE(11) NT_LNQ2_CASE(12)
#undef NT_LNQ2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
