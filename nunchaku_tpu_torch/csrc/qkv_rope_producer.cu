// Fused attention prologue of the bf16-stream configuration: split the
// fused-QKV GEMM output by head, add the projection's low-rank term, RMSNorm
// q and k, rotate them with the half-split RoPE, prescale q, and write q, k,
// v in flash's (B, H, S, D) layout -- at a row offset of caller-given
// buffers, so a dual block's txt and img streams share one joint buffer.
//
// Replaces nunchaku_tpu/ops/attention.py _qkv_rope_producer_kernel (:158,
// launched by qkv_rope_producer :212). Per (token, head), D = 128:
//   a = x [+ bf16(lora_act) @ proj_up[:, head slice]]             (f32)
//   q, k: a = a * rsqrt(mean(a^2) + 1e-6) * w;  o = a*cos + roll(a, 64)*sin
//         (sin's first half negated), q: o *= q_scale;  v: o = a
//
// Bound on the H100: bytes (read the (S, 3*H*D) bf16 GEMM output once,
// write q, k, v once; about 15 operations per element). Design: a block
// takes 64 tokens of one head (grid: token tiles x heads x batch). With the
// low-rank term, the block stages bf16(lora_act) of its tokens and the
// head's three proj_up slices in shared memory and forms the (64 x R) @
// (R x 128) products on the tensor cores (WMMA bf16, f32 accumulate) into
// a shared f32 tile, section by section. R is any multiple of 16 (the
// wrapper pads it); the tiles are dynamic shared memory sized by the call's
// R up to 128: at R 128 la 17 KB, proj_up 104 KB and the f32 tile 33 KB,
// about 152 KB (65 KB at R 32, as when the tile was static). Above 128 the
// ranks run in chunks of 128 through the same tiles, each section restaging
// la and its own proj_up rows per chunk. The products sum over R in 16-deep
// steps in order (the accumulators carried across chunks), so R 32 gives the
// bits it always gave. A warp then takes one token at a
// time: each lane holds 4 of the 128 channels (8-byte loads and stores, a
// token's head row is one 256-byte segment), the RMS sum is a warp
// shuffle, and roll(a, 64) is a shuffle with lane ^ 16.
//
// Prepare mode (PREP = true): replaces _qkv_prepare_kernel (:51, launched
// by qkv_prepare :87), the producer without the low-rank term: R = 0 at
// compile time, no shared memory, q, k, v written whole (S_out = S, row
// offset 0), and the RMSNorm's eps an argument. Its arithmetic is the
// producer's with R = 0 step for step, so the two give the same outputs
// bit for bit; JAX pads S to 128 rows, this kernel masks the ragged tile.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int D = 128, TS = 64, THREADS = 256, WARPS = THREADS / 32, RANK_CHUNK = 128;
constexpr int LDP = D + 8, LDL = D + 4;
constexpr float EPS = 1e-6f;

// Dynamic shared memory at rank R (a multiple of 16), for RC = min(R, 128) staged ranks: la [TS][RC + 8]
// bf16(lora_act) of the block's tokens, pu [3][RC][LDP] proj_up columns of this head's q, k, v slices, lr
// [TS][LDL] f32 low-rank term of the current section. Every piece starts on a 32-byte boundary, as WMMA's
// loads and stores need.
__host__ __device__ constexpr int staged(int R) { return R < RANK_CHUNK ? R : RANK_CHUNK; }
__host__ __device__ constexpr size_t la_bytes(int R) { return sizeof(bf16) * TS * (R + 8); }
__host__ __device__ constexpr size_t pu_bytes(int R) { return sizeof(bf16) * 3 * R * LDP; }
constexpr size_t smem_bytes(int R) {
  return R > 0 ? la_bytes(staged(R)) + pu_bytes(staged(R)) + sizeof(float) * TS * LDL : 0;
}

__device__ __forceinline__ void load4(float (&d)[4], const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = bf2f(b[i]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 raw;
  bf16* b = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <bool PREP>
__global__ void __launch_bounds__(THREADS)
    qkv_rope_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cosr,
                    const float* __restrict__ sinr, const bf16* __restrict__ nq,
                    const bf16* __restrict__ nk, const float* __restrict__ la,
                    const bf16* __restrict__ pu, bf16* __restrict__ qo, bf16* __restrict__ ko,
                    bf16* __restrict__ vo, int S, int H, int S_out, int off, int R_arg, float q_scale,
                    float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int R = PREP ? 0 : R_arg, RC = staged(R), LDA = RC + 8;
  bf16* sla = reinterpret_cast<bf16*>(smem_raw);                    // [TS][LDA]
  bf16* spu = reinterpret_cast<bf16*>(smem_raw + la_bytes(RC));     // [3][RC][LDP]
  float* slr = reinterpret_cast<float*>(smem_raw + la_bytes(RC) + pu_bytes(RC));  // [TS][LDL]
  const int s0 = blockIdx.x * TS, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int HD = H * D;
  const size_t row_base = static_cast<size_t>(b) * S;  // token row of (b, s0) is row_base + s0

  if constexpr (!PREP) {  // PREP: R = 0 at compile time, nothing staged
    if (R > 0 && R <= RANK_CHUNK) {  // every rank at once, for all three sections
      for (int i = threadIdx.x; i < TS * R; i += THREADS) {
        const int t = i / R, r = i % R;
        const float v = s0 + t < S ? la[(row_base + s0 + t) * R + r] : 0.f;
        sla[t * LDA + r] = __float2bfloat16(v);
      }
      // 16-byte pieces: a proj_up row of the head is 16 of them (LDP keeps each 16-byte aligned)
      for (int i = threadIdx.x; i < 3 * R * (D / 8); i += THREADS) {
        const int row = i / (D / 8), c = (i % (D / 8)) * 8, sec = row / R, r = row % R;
        *reinterpret_cast<uint4*>(spu + row * LDP + c) =
            *reinterpret_cast<const uint4*>(pu + static_cast<size_t>(r) * 3 * HD + sec * HD + h * D + c);
      }
    }
  }

  const int c0 = lane * 4;
  bf16* outs[3] = {qo, ko, vo};
  for (int sec = 0; sec < 3; ++sec) {
    if (R > 0) {
      __syncthreads();  // staging done / the previous section's lr tile is consumed
      // (64 x 128) = la (64 x R) @ pu (R x 128): warp w takes row tile w / 2, column tiles 4 (w % 2) .. +4
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
      const int fr = warp / 2, fc = (warp % 2) * 4;
      for (int j0 = 0; j0 < R; j0 += RANK_CHUNK) {
        const int rc = staged(R - j0);
        if (R > RANK_CHUNK) {  // ranks j0 .. j0 + rc of la and of this section's proj_up rows
          if (j0 > 0) __syncthreads();  // every warp has read the previous chunk
          for (int i = threadIdx.x; i < TS * rc; i += THREADS) {
            const int t = i / rc, r = i % rc;
            const float v = s0 + t < S ? la[(row_base + s0 + t) * R + j0 + r] : 0.f;
            sla[t * LDA + r] = __float2bfloat16(v);
          }
          for (int i = threadIdx.x; i < rc * (D / 8); i += THREADS) {
            const int r = i / (D / 8), c = (i % (D / 8)) * 8;
            *reinterpret_cast<uint4*>(spu + (sec * RC + r) * LDP + c) =
                *reinterpret_cast<const uint4*>(pu + static_cast<size_t>(j0 + r) * 3 * HD + sec * HD + h * D + c);
          }
          __syncthreads();
        }
#pragma unroll
        for (int kk = 0; kk < rc; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sla + fr * 16 * LDA + kk, LDA);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, spu + (sec * RC + kk) * LDP + (fc + j) * 16, LDP);
            wmma::mma_sync(acc[j], a, bf, acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(slr + fr * 16 * LDL + (fc + j) * 16, acc[j], LDL, wmma::mem_row_major);
      __syncthreads();
    }
    const bf16* w = sec == 0 ? nq : nk;
    float wv[4];
    if (sec < 2) load4(wv, w + c0);
    for (int t = warp; t < TS; t += WARPS) {
      const int s = s0 + t;
      if (s >= S) break;
      float a[4];
      load4(a, qkv + (row_base + s) * 3 * HD + sec * HD + h * D + c0);
      if (R > 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = __fadd_rn(a[i], slr[t * LDL + c0 + i]);
      }
      if (sec < 2) {
        float ss = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) ss = __fadd_rn(ss, __fmul_rn(a[i], a[i]));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
        const float rs = __frsqrt_rn(__fadd_rn(__fmul_rn(ss, 1.0f / D), eps));
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = __fmul_rn(__fmul_rn(a[i], rs), wv[i]);
        const float4 cv = *reinterpret_cast<const float4*>(cosr + static_cast<size_t>(s) * D + c0);
        const float4 sv = *reinterpret_cast<const float4*>(sinr + static_cast<size_t>(s) * D + c0);
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w}, sn[4] = {sv.x, sv.y, sv.z, sv.w};
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float rolled = __shfl_xor_sync(0xffffffffu, a[i], 16);  // channel (c + 64) % 128
          o[i] = __fadd_rn(__fmul_rn(a[i], cc[i]), __fmul_rn(rolled, sn[i]));
          if (sec == 0 && q_scale != 1.f) o[i] = __fmul_rn(o[i], q_scale);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = o[i];
      }
      store4(outs[sec] + ((static_cast<size_t>(b) * H + h) * S_out + off + s) * D + c0, a);
    }
  }
}

}  // namespace

// qkv (B, S, 3*H*128) bf16, cos / sin (S, 128) f32, norm_q / norm_k (128,)
// bf16, lora_act (B*S, R) f32 | null, proj_up (R, 3*H*128) bf16 | null
// -> rows [off, off + S) of q, k, v, each (B, H, S_out, 128) bf16.
// Needs R a multiple of 16 (0: no low-rank term).
extern "C" int nt_qkv_rope_producer(const void* qkv, const void* cos, const void* sin, const void* norm_q,
                                    const void* norm_k, const void* lora_act, const void* proj_up, void* q,
                                    void* k, void* v, int B, int S, int H, int S_out, int off, int R,
                                    float q_scale, void* stream) {
  if (R % 16 != 0 || R < 0 || (R > 0 && (lora_act == nullptr || proj_up == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem_bytes(R));
  static bool configured = false;
  if (!configured) {  // the limit for the largest staged rank
    cudaError_t e = cudaFuncSetAttribute(qkv_rope_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(RANK_CHUNK)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((S + TS - 1) / TS, H, B);
  qkv_rope_kernel<false><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const bf16*>(norm_q), static_cast<const bf16*>(norm_k), static_cast<const float*>(lora_act),
      static_cast<const bf16*>(proj_up), static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), S,
      H, S_out, off, R, q_scale, EPS);
  return static_cast<int>(cudaGetLastError());
}

// The prepare mode: qkv (B, S, 3*H*128) bf16, cos / sin (S, 128) f32,
// norm_q / norm_k (128,) bf16 -> q, k, v, each (B, H, S, 128) bf16.
extern "C" int nt_qkv_prepare(const void* qkv, const void* cos, const void* sin, const void* norm_q,
                              const void* norm_k, void* q, void* k, void* v, int B, int S, int H, float q_scale,
                              float eps, void* stream) {
  dim3 grid((S + TS - 1) / TS, H, B);
  qkv_rope_kernel<true><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<const bf16*>(norm_q), static_cast<const bf16*>(norm_k), nullptr, nullptr, static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), S, H, S, 0, 0, q_scale, eps);
  return static_cast<int>(cudaGetLastError());
}
