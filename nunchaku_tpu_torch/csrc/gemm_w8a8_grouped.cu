// fc2 GEMM over grouped activation scales (the fused MLP chain's consumer),
// with the transformer block's gated residual add as an optional epilogue.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w8a8_kernel (:344) in its
// grouped_as mode, launched by _svdq_gemm_w4a4 (:1906, pallas_call :2300):
//   acc = sum over K groups g, in order, of f32(i32(qact[:, g] @ w[g, :])) * ascale[g, m]
//   out = bf16(acc * wscale[n] + bf16(lora_act) @ proj_up + bias)
// and, with the residual operands (its n_res epilogue, gemm.py:395-412;
// RES = true here), the block's gated residual instead:
//   t = bf16(out);  e = bf16(extra + bf16(extra_la) @ extra_pu)  (if extra)
//   out = bf16(x + gate[m / S] * (t + e))
// The producer (gemm_w8a8_gelu_quant.cu) emits one scale per (token,
// K group), so each group's exact int32 partial is scaled before it joins
// the f32 sum -- the same order as the JAX kernel, one group per K step.
//
// Rank-1 mode (the JAX kernel with grouped_as off, :386: out = acc * as *
// ws): ascales (1, M), G = 1, the per-token chain's consumer
// (NUNCHAKU_TPU_CHAIN_PTOKEN=1) and, with the residual operands, its
// gated-residual form. The kernel keeps one exact int32 sum over all of K
// and scales it once, f32(i32) * as * ws; the JAX kernel sums the f32 of
// each bk-step int32 partial, so at K 12288 the two can differ by f32
// rounding of the sum (below one bf16 step of the output).
//
// Stacked modes (stacked_w, :347, :366): the weight is layer idx of an
// (L, K, N) int8 stack, each layer stored (N, K), idx a device-resident
// int32 read once at entry by every block (common.cuh stacked_layer); the
// rest is the non-stacked code, bit for bit. Grouped, rank-1, and each with
// the residual epilogue. The stacked form is a template parameter: a
// runtime null check on the index cost the residual mode 5 registers and
// 2.6% of its time at FLUX's fc2 (H100).
//
// Bound on the H100: operations (2*M*N*K int8 ops; at FLUX.1-dev shapes
// K = 12288, N = 3072, M up to 4608, well above the int8 ridge). The
// residual operands add 2-3 bf16 (M, N) reads, well under 1% of the bound.
// Design: the tensor-core main loop of int8_gemm.cuh runs
// once per K group into int32 WMMA fragments; after each group the
// fragments pass through a per-warp shared-memory scratch into f32
// registers (64 per thread), where the group's scale is applied. The
// epilogue adds the rank-r branch and bias (and, with RES, the extra
// operand's rank-r2 branch through the same shared-memory tile code and
// the gated add) and writes bf16 in 16-byte vectors.
//
// Rank. R and R2 run up to 128 (nunchaku's rank-128 checkpoints): the two
// low-rank tiles live in dynamic shared memory sized by the call's ranks,
// 40 KiB in all at rank 32, as before, 136 KiB at rank 128.
#include "int8_gemm.cuh"

namespace {

using namespace i8gemm;

// Dynamic shared memory: [0, union) the main loop's two stages, reused after
// it by the lora tile (lora_bytes(R)) and the extra operand's (lora_bytes(R2),
// RES); then scratch[THREADS / 32][256] int, one accumulator fragment per warp.
struct Layout {
  size_t elora, scratch, total;
};

__host__ __device__ inline Layout layout(int R, int R2) {
  Layout l{};
  l.elora = lora_bytes(R);
  size_t uni = l.elora + lora_bytes(R2);
  const size_t stages = align128(2 * sizeof(Stage));
  if (uni < stages) uni = stages;
  l.scratch = uni;
  l.total = l.scratch + align128(static_cast<size_t>(THREADS / 32) * 256 * sizeof(int));
  return l;
}

// Gated-residual operands: x, extra (M, N) bf16; gate (B, N) f32, row m
// takes gate[m / S]; extra_la (M, R2) f32 with extra_pu (R2, N) bf16.
struct Res {
  const bf16* x;
  const float* gate;
  const bf16* extra;
  const float* ela;
  const bf16* epu;
  int S, R2;
};

__device__ __forceinline__ void load8(float (&d)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = bf2f(b[i]);
}

__device__ __forceinline__ float round_bf16(float v) { return bf2f(__float2bfloat16(v)); }

template <bool RES, bool STACKED>
__global__ void __launch_bounds__(THREADS)
    gemm_grouped_kernel(const int8_t* __restrict__ qa, const float* __restrict__ as,
                        const int8_t* __restrict__ wt, const float* __restrict__ ws,
                        const float* __restrict__ la, const bf16* __restrict__ pu,
                        const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K,
                        int G, int R, Res res, const int* __restrict__ lidx, int n_layers) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout(R, res.R2);
  Stage* st = reinterpret_cast<Stage*>(smem_raw);
  const LoraTile lora = lora_tile(smem_raw, R), elora = lora_tile(smem_raw + L.elora, res.R2);
  int* scratch = reinterpret_cast<int*>(smem_raw + L.scratch);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gk = K / G;
  if (STACKED) wt = stacked_layer(wt, lidx, n_layers, static_cast<size_t>(K) * N);
  float facc[FM][FN][8];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
#pragma unroll
      for (int i = 0; i < 8; ++i) facc[fm][fn][i] = 0.f;

  AccFrag acc[FM][FN];
  for (int g = 0; g < G; ++g) {
    zero(acc);
    mainloop(st, acc, qa, WeightI8{wt}, m0, n0, g * gk, (g + 1) * gk, K);
    const float* asg = as + static_cast<size_t>(g) * M + m0;
    for_each_fragment(scratch + (threadIdx.x / 32) * 256, acc, [&](int fm, int fn, int ml, int, const int (&v)[8]) {
      const float a = asg[ml];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        facc[fm][fn][i] = __fadd_rn(facc[fm][fn][i], __fmul_rn(static_cast<float>(v[i]), a));
    });
  }

  if (R > 0) stage_lora(lora, la, pu, m0, n0, N, R);
  if (RES && res.R2 > 0) stage_lora(elora, res.ela, res.epu, m0, n0, N, res.R2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      const int ml = wm * WM + fm * 16 + r, nl = wn * WN + fn * 16 + c0;
      const int m = m0 + ml, n = n0 + nl;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(facc[fm][fn][i], ws[n + i]);
      add_lora_bias(lora, o, ml, nl, n, R, bias);
      if (RES) {
        const size_t at = static_cast<size_t>(m) * N + n;
        float xv[8], e[8];
        load8(xv, res.x + at);
        const float* g = res.gate + static_cast<size_t>(m / res.S) * N + n;
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = round_bf16(o[i]);
        if (res.extra != nullptr) {
          load8(e, res.extra + at);
          add_lora_bias(elora, e, ml, nl, n, res.R2, nullptr);
#pragma unroll
          for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(o[i], round_bf16(e[i]));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(xv[i], __fmul_rn(g[i], o[i]));
      }
      uint4 packed;
      bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) pb[i] = __float2bfloat16(o[i]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) = packed;
    }
  }
}

}  // namespace

// qact (M, K) int8, ascales (G, M) f32, wt (N, K) int8 (the (K, N) weight
// K-contiguous), wscales (N,) f32,
// lora_act (M, R) f32 | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null,
// residual: x (M, N) bf16 | null (no residual), gate (B, N) f32 with S = M / B
// rows per batch, extra (M, N) bf16 | null, extra_la (M, R2) f32 | null,
// extra_pu (R2, N) bf16 | null
// -> out (M, N) bf16. Needs M % 128 == 0, N % 128 == 0, (K / G) % 64 == 0, R, R2 <= MAX_R (128).
// G = 1 is the rank-1 mode. layer_idx: null, or a device int32 naming the
// layer of a stack of L weights, each stored (N, K), that starts at wt.
extern "C" int nt_gemm_w8a8_grouped(const void* qact, const void* ascales, const void* wt,
                                    const void* wscales, const void* lora_act, const void* proj_up,
                                    const void* bias, const void* x, const void* gate,
                                    const void* extra, const void* extra_la, const void* extra_pu,
                                    void* out, int M, int N, int K, int G, int R, int S, int R2,
                                    const void* layer_idx, int L, void* stream) {
  dim3 grid(N / BN, M / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Res res{static_cast<const bf16*>(x), static_cast<const float*>(gate), static_cast<const bf16*>(extra),
                static_cast<const float*>(extra_la), static_cast<const bf16*>(extra_pu), S,
                extra_la == nullptr ? 0 : R2};
  static bool configured = false;
  if (R > MAX_R || res.R2 > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  if (!configured) {  // room for the largest ranks once; each launch asks for its own size
    const int most = static_cast<int>(layout(MAX_R, MAX_R).total);
    for (auto k : {gemm_grouped_kernel<true, false>, gemm_grouped_kernel<false, false>,
                   gemm_grouped_kernel<true, true>, gemm_grouped_kernel<false, true>}) {
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    configured = true;
  }
  const bool stacked = layer_idx != nullptr;
  auto kernel = x != nullptr ? (stacked ? gemm_grouped_kernel<true, true> : gemm_grouped_kernel<true, false>)
                             : (stacked ? gemm_grouped_kernel<false, true> : gemm_grouped_kernel<false, false>);
  kernel<<<grid, THREADS, static_cast<int>(layout(R, res.R2).total), s>>>(
      static_cast<const int8_t*>(qact), static_cast<const float*>(ascales),
      static_cast<const int8_t*>(wt), static_cast<const float*>(wscales),
      static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, G, R, res,
      static_cast<const int*>(layer_idx), L);
  return static_cast<int>(cudaGetLastError());
}
