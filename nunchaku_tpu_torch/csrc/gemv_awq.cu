// AWQ W4A16 GEMV: bf16 activations (M <= 8 rows) times 4-bit asymmetric
// weights, f32 result.
//
// Replaces nunchaku_tpu/ops/gemv.py _gemv_kernel (:25, launched by
// awq_w4a16_linear :58):
//   w = bf16(q * s[g(k), n] - z[g(k), n])   (q an unsigned nibble, f32 math)
//   out = x @ w  (f32 accumulation)  + bias
// with g(k) = k / 64 and the (K/2, N) weight packed along K in the
// block-split-half order (byte j of pack block b holds k = 256b + j in its
// low nibble and 256b + 128 + j in its high one).
//
// Bound on the H100: bytes (the packed weight; at M 1, K 3072, N 18432 it
// reads 28.3 MB of codes and 3.5 MB of scales and zeros, 9.5 us at
// 3.35 TB/s, and does 2 FLOP per weight). Design: the (K/2, N) layout is
// N-contiguous, so each lane owns 8 neighbouring columns and reads 8 bytes
// of a packed row at a time (a warp reads 256 contiguous bytes); x for the
// block's 512 k sits in shared memory as f32. A warp's unit is 32 packed
// rows, over which both nibble planes keep one scale group, so its scales
// and zeros load once. FLUX's 18432 columns make only 72 column blocks for
// 132 SMs, so K is split too: a block's 8 warps take 8 consecutive units
// (512 k), their partial sums meet in shared memory in a fixed order, and
// a second small kernel adds the K blocks' partials in a fixed order plus
// the bias -- deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int CPT = 8;             // columns per lane
constexpr int COLS = 32 * CPT;     // columns per block
constexpr int UROWS = 32;          // packed rows per warp unit
constexpr int KBLK = 2 * UROWS * WARPS;  // logical k per block (512)
constexpr int MAXM = 8;
constexpr int G = 64;

__device__ __forceinline__ float round_bf16(float v) { return bf2f(__float2bfloat16(v)); }

__device__ __forceinline__ void load8(float (&d)[CPT], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < CPT; ++i) d[i] = bf2f(b[i]);
}

// part[ks][m][n]: the sum over this block's 512 k of x[m, k] * w[k, n]
__global__ void __launch_bounds__(THREADS)
    gemv_awq_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw, const bf16* __restrict__ ws,
                    const bf16* __restrict__ wz, float* __restrict__ part, int M, int N, int K) {
  extern __shared__ float smem[];
  float* xs = smem;               // [M][KBLK]
  float* red = smem + M * KBLK;   // [WARPS][M][COLS]
  const int ks = blockIdx.y, n0 = blockIdx.x * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kbase = KBLK * ks;
  for (int i = threadIdx.x; i < M * KBLK; i += THREADS) {
    const int m = i / KBLK, kk = kbase + i % KBLK;
    xs[i] = kk < K ? bf2f(x[static_cast<size_t>(m) * K + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MAXM][CPT];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;
  const int n = n0 + CPT * lane;
  const int p0 = kbase / 2 + UROWS * warp;  // this warp's first packed row
  if (p0 < K / 2) {
    const int klo = 256 * (p0 / 128) + p0 % 128;  // k of row p0's low nibble; high: + 128
    float slo[CPT], zlo[CPT], shi[CPT], zhi[CPT];
    load8(slo, ws + static_cast<size_t>(klo / G) * N + n);
    load8(zlo, wz + static_cast<size_t>(klo / G) * N + n);
    load8(shi, ws + static_cast<size_t>(klo / G + 2) * N + n);
    load8(zhi, wz + static_cast<size_t>(klo / G + 2) * N + n);
    const float* xlo = xs + (klo - kbase);
#pragma unroll 8
    for (int i = 0; i < UROWS; ++i) {
      const uint2 raw = *reinterpret_cast<const uint2*>(qw + static_cast<size_t>(p0 + i) * N + n);
      float wlo[CPT], whi[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const uint32_t byte = ((c < 4 ? raw.x : raw.y) >> (8 * (c % 4))) & 0xFFu;
        // 0x4B000000 | q is the f32 2^23 + q: an exact int -> float for the nibble
        const float qlo = __fsub_rn(__uint_as_float(0x4B000000u | (byte & 0xFu)), 8388608.f);
        const float qhi = __fsub_rn(__uint_as_float(0x4B000000u | (byte >> 4)), 8388608.f);
        wlo[c] = round_bf16(__fsub_rn(__fmul_rn(qlo, slo[c]), zlo[c]));
        whi[c] = round_bf16(__fsub_rn(__fmul_rn(qhi, shi[c]), zhi[c]));
      }
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          const float a = xlo[m * KBLK + i], b = xlo[m * KBLK + 128 + i];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(b, whi[c], fmaf(a, wlo[c], acc[m][c]));
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
    if (m < M)
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[(warp * M + m) * COLS + CPT * lane + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < M * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * M + m) * COLS + c];
    part[(static_cast<size_t>(ks) * M + m) * N + n0 + c] = s;
  }
}

// out[m][n] = sum over ks, in order, of part[ks][m][n], + bias[n]
__global__ void gemv_awq_finish(const float* __restrict__ part, const bf16* __restrict__ bias,
                                float* __restrict__ out, int M, int N, int KS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float s = 0.f;
  for (int ks = 0; ks < KS; ++ks) s += part[static_cast<size_t>(ks) * M * N + i];
  if (bias != nullptr) s += bf2f(bias[i % N]);
  out[i] = s;
}

}  // namespace

// x (M, K) bf16, qweight (K/2, N) int8 (unsigned nibbles), wscales and
// wzeros (K/64, N) bf16, bias (N,) bf16 | null; part (ceil(K/512), M, N)
// f32 scratch -> out (M, N) f32. Needs M <= 8, K % 256 == 0, N % 256 == 0
// (checked by the Python wrapper).
extern "C" int nt_gemv_awq(const void* x, const void* qweight, const void* wscales, const void* wzeros,
                           const void* bias, void* part, void* out, int M, int N, int K, void* stream) {
  static bool configured = false;
  const int max_smem = static_cast<int>(sizeof(float)) * MAXM * (KBLK + WARPS * COLS);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gemv_awq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (M < 1 || M > MAXM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ksplit = (K + KBLK - 1) / KBLK;
  const int smem = static_cast<int>(sizeof(float)) * M * (KBLK + WARPS * COLS);
  gemv_awq_kernel<<<dim3(N / COLS, ksplit), THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(qweight), static_cast<const bf16*>(wscales),
      static_cast<const bf16*>(wzeros), static_cast<float*>(part), M, N, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  gemv_awq_finish<<<(M * N + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                       static_cast<const bf16*>(bias), static_cast<float*>(out),
                                                       M, N, ksplit);
  return static_cast<int>(cudaGetLastError());
}
