// w4a8 GEMM on packed int4 weights: int8 activations times int4 codes that
// are decoded to int8 inside the kernel, never written to HBM.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w4a8h_kernel (:281, launched by
// _gemm_w4a8_hoisted :1691) in both of its modes, non-stacked and stacked
// (its layer-index form, :1714-1726: the packed codes are layer idx of an
// (L, K/2, N) stack, idx a device-resident int32 the copying thread reads on
// the card, clamped to [0, L), as a TMA coordinate; the scans reach it in
// rank-1 mode under NUNCHAKU_TPU_W4A8_XLA=0 and in grouped mode, the MLP
// chain's consumer, under NUNCHAKU_TPU_W4A8_FUSED=1), and _gemm_w4a8_kernel
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
// Design: the s8 wgmma + TMA loop of gemm_sm90.cuh in its warpgroup-0
// decoding form (gemm_w4_kernel with the W4Src source): two consumer
// warpgroups run wgmma m64n128k32 s8 on the A tile (TMA) and a decoded int8
// W tile; warpgroup 0 decodes each 256-k pack block of the packed weight
// (one TMA box, both nibble planes) into two K-major int8 tiles by 16-entry
// tables and byte permutes, up to three tiles ahead. The epilogue is the
// int8 grouped consumer's (grouped_epi.cuh GroupedEpi, without the
// residual: JAX applies res_apply after the packed consumer), so on the same
// logical weight the outputs are gemm_w8a8_grouped.cu's bit for bit. The
// JAX kernel hoists the decode: it rescales a (K/2, bn) stripe once into
// VMEM for every M tile; here each 128 x 128 block decodes its own tiles
// (M / 128 times per weight: an SM's 227 KB holds no stripe).
//
// Any M (a partial last row tile reads TMA's zeros and writes no row past
// M) and any rank (the low-rank tiles in chunks of 128 ranks).
#include "grouped_epi.cuh"

namespace {

using Epi = grouped::GroupedEpi<false>;

}  // namespace

// qact (M, K) int8, ascales (G, M) f32 (G = 1: the rank-1 mode),
// qweight (K/2, N) int8 packed int4 codes (N-contiguous, block-split-half
// layout), rescales (K/64, N) bf16, wscales (N,) f32,
// lora_act (M, R) f32 | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null
// -> out (M, N) bf16. Needs N % 128 == 0, K % 256 == 0, (K / G) % 64 == 0
// and 16-byte aligned operands. layer_idx: null, or a device int32 naming
// the layer of a stack of L (K/2, N) code arrays that starts at qweight.
extern "C" int nt_gemm_w4a8(const void* qact, const void* ascales, const void* qweight, const void* rescales,
                            const void* wscales, const void* lora_act, const void* proj_up, const void* bias,
                            void* out, int M, int N, int K, int G, int R, const void* layer_idx, int L,
                            void* stream) {
  if (R < 0 || G < 1 || K % G != 0 || (K / G) % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  gemm90::W4Src::Params p;
  if (!gemm90::W4Src::maps(p, qact, qweight, rescales, M, N, K, G, static_cast<const int*>(layer_idx), L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Epi::Params e{static_cast<const float*>(ascales), static_cast<const float*>(wscales),
                      static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
                      static_cast<const bf16*>(bias), static_cast<bf16*>(out), lora_act == nullptr ? 0 : R,
                      grouped::Res{}};
  return gemm90::launch_w4<Epi>(p, e, M, N, K, static_cast<cudaStream_t>(stream));
}
