// w4a8 GEMM on packed int4 weights: int8 activations times int4 codes that
// are decoded to int8 inside the main loop, never written to HBM.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w4a8h_kernel (:281, launched by
// _gemm_w4a8_hoisted :1691) in both of its modes, non-stacked and stacked
// (its layer-index form, :1714-1726: the packed codes are layer idx of an
// (L, K/2, N) stack, idx a device-resident int32 read once at entry,
// common.cuh stacked_layer; the scans reach it in rank-1 mode under
// NUNCHAKU_TPU_W4A8_XLA=0 and in grouped mode, the MLP chain's consumer, under
// NUNCHAKU_TPU_W4A8_FUSED=1), and _gemm_w4a8_kernel
// (:167, the per-M-tile kernel of explicit-tile calls, :2180-2199), which
// computes the rank-1 mode with another dequant schedule only
// (tests/test_ops.py:430-459 pins the two bit-identical):
//   rank-1 (ascales (1, M), every standalone w4a8 linear under
//   NUNCHAKU_TPU_W4A8_XLA=0):
//     out = bf16(f32(i32(qact @ w8)) * ascale[m] * wscale[n] + bf16(lora_act) @ proj_up + bias)
//   grouped (ascales (G, M), the fc2 consumer of the packed MLP chain under
//   NUNCHAKU_TPU_W4A8_FUSED=1):
//     acc = sum over K groups g, in order, of f32(i32(qact[:, g] @ w8[g, :])) * ascale[g, m]
//     out = bf16(acc * wscale[n] + bf16(lora_act) @ proj_up + bias)
// with w8 = clip(round_half_even(nibble * rescale), +-127), the int8 weight
// the dequant kernel would write. The rank-1 mode is the grouped one at
// G = 1 (0 + x is x), one kernel for both; low-rank and bias are optional
// (R = 0, null bias). The epilogue is all f32, rounded to bf16 once, as the
// JAX kernel's: the dequant route's standalone GEMM (gemm.py gemm_w8a8, JAX
// _gemm_w8a8_xla) rounds its main term to bf16 before the low-rank add, so
// the two routes differ there by a bf16 rounding, as in JAX.
//
// Bound on the H100: operations (2*M*N*K int8 ops; at FLUX.1-dev's qkv shape
// M 4608, K 3072, N 9216: 0.132 ms at 1979 TOP/s against 0.034 ms of bytes).
// Design: the tensor-core main loop of int8_gemm.cuh with the WeightW4
// operand: each k tile copies the 64 packed rows of its nibble plane and
// their rescale row with cp.async and decodes them in shared memory into the
// K-contiguous int8 tile the WMMA products read. The JAX kernel hoists the
// decode: it rescales a (K/2, bn) stripe once into VMEM for every M tile;
// here each 128 x 128 block decodes its own tiles (M / 128 times per weight:
// an SM's 228 KB holds no stripe). After each K group the int32 fragments
// pass through a per-warp shared-memory scratch into f32 registers, where
// the group's scale is applied; the epilogue adds the rank-r branch and the
// bias and writes bf16 in 16-byte vectors.
#include "int8_gemm.cuh"

namespace {

using namespace i8gemm;

// Dynamic shared memory: [0, union) the main loop's two packed stages,
// reused after it by the lora tile (lora_bytes(R)); then scratch[THREADS /
// 32][256] int, one accumulator fragment per warp.
__host__ __device__ inline size_t scratch_at(int R) {
  const size_t stages = align128(2 * sizeof(PackedStage));
  return lora_bytes(R) > stages ? lora_bytes(R) : stages;
}

__host__ __device__ inline size_t smem_bytes(int R) {
  return scratch_at(R) + align128(static_cast<size_t>(THREADS / 32) * 256 * sizeof(int));
}

__global__ void __launch_bounds__(THREADS)
    gemm_w4a8_kernel(const int8_t* __restrict__ qa, const float* __restrict__ as, WeightW4 w,
                     const float* __restrict__ ws, const float* __restrict__ la, const bf16* __restrict__ pu,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K, int G, int R,
                     const int* __restrict__ lidx, int L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* st = reinterpret_cast<PackedStage*>(smem_raw);
  const LoraTile lora = lora_tile(smem_raw, R);
  int* scratch = reinterpret_cast<int*>(smem_raw + scratch_at(R));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int gk = K / G;
  w.qw = stacked_layer(w.qw, lidx, L, static_cast<size_t>(K / 2) * N);
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
    mainloop(st, acc, qa, w, m0, n0, g * gk, (g + 1) * gk, K);
    const float* asg = as + static_cast<size_t>(g) * M + m0;
    for_each_fragment(scratch + (threadIdx.x / 32) * 256, acc, [&](int fm, int fn, int ml, int, const int (&v)[8]) {
      const float a = asg[ml];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        facc[fm][fn][i] = __fadd_rn(facc[fm][fn][i], __fmul_rn(static_cast<float>(v[i]), a));
    });
  }

  if (R > 0) stage_lora(lora, la, pu, m0, n0, N, R);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      const int ml = wm * WM + fm * 16 + r, nl = wn * WN + fn * 16 + c0;
      const int n = n0 + nl;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(facc[fm][fn][i], ws[n + i]);
      add_lora_bias(lora, o, ml, nl, n, R, bias);
      uint4 packed;
      bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; ++i) pb[i] = __float2bfloat16(o[i]);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + ml) * N + n) = packed;
    }
  }
}

}  // namespace

// qact (M, K) int8, ascales (G, M) f32 (G = 1: the rank-1 mode),
// qweight (K/2, N) int8 packed int4 codes (N-contiguous, block-split-half
// layout), rescales (K/64, N) bf16, wscales (N,) f32,
// lora_act (M, R) f32 | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null
// -> out (M, N) bf16. Needs M % 128 == 0, N % 128 == 0, K % 256 == 0,
// (K / G) % 64 == 0, R <= MAX_R (128). layer_idx: null, or a device int32
// naming the layer of a stack of L (K/2, N) code arrays that starts at
// qweight.
extern "C" int nt_gemm_w4a8(const void* qact, const void* ascales, const void* qweight, const void* rescales,
                            const void* wscales, const void* lora_act, const void* proj_up, const void* bias,
                            void* out, int M, int N, int K, int G, int R, const void* layer_idx, int L,
                            void* stream) {
  static bool configured = false;
  if (R > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  if (!configured) {  // room for the largest rank once; each launch asks for its own size
    cudaError_t e = cudaFuncSetAttribute(gemm_w4a8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(MAX_R)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(N / BN, M / BM);
  gemm_w4a8_kernel<<<grid, THREADS, static_cast<int>(smem_bytes(R)), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qact), static_cast<const float*>(ascales),
      WeightW4{static_cast<const int8_t*>(qweight), static_cast<const bf16*>(rescales), N},
      static_cast<const float*>(wscales), static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, G, R,
      static_cast<const int*>(layer_idx), L);
  return static_cast<int>(cudaGetLastError());
}
