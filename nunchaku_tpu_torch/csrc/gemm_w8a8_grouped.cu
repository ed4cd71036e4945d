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
// int32 that the TMA producer thread reads on the card (one tensor map
// over the whole stack; gemm_sm90.cuh TmaS8); the rest is the non-stacked
// code, bit for bit. Grouped, rank-1, and each with the residual epilogue.
//
// Bound on the H100: operations (2*M*N*K int8 ops; at FLUX.1-dev shapes
// K = 12288, N = 3072, M up to 4608, well above the int8 ridge). The
// residual operands add 2-3 bf16 (M, N) reads, well under 1% of the bound.
// Design: the wgmma + TMA main loop of gemm_sm90.cuh at its s8
// instantiation (block tile 128 x 128, K tiles of 128 bytes, a 4-stage TMA
// ring, wgmma m64n128k32 s8 into s32 accumulators). Each K group's products
// start from zero; at the group's last K tile, once they are done, each
// consumer thread folds its 64 s32 accumulators into 64 f32 running sums,
// f32(i32) * ascale[g, row] (the group's two row scales loaded as the
// group starts). A K / G that 128 does not divide ends each group on a
// 64-byte tile whose upper half TMA fills with zeros. After the last group
// the f32 sums go through shared memory to a thread per 4 x 16 block, which
// adds the rank-r branch and bias (and, with RES, the extra operand's rank-r2
// branch and the gated add) in the same order and roundings as the WMMA
// kernel did and writes bf16 in 16-byte vectors: the outputs are that
// kernel's bit for bit. A block's rank-r sums run over j once for its 64
// values (int8_gemm.cuh lora_sums_4x16: eight ranks of a row in one 16-byte
// load, proj_up chunks shared across the warp); the low-rank tiles are
// staged by cp.async and batched float4 loads. A thread per 8 columns, as
// the WMMA kernel has it, made the epilogue bound by shared-memory loads and
// by one global-load latency per staged element (a third of the kernel at
// rank 32, twice the products at rank 128). BN is 128: 64 s32
// + 64 f32 accumulators a consumer thread fit ptxas's 168-register budget of
// a 384-thread block.
//
// The epilogue (GroupedEpi) lives in grouped_epi.cuh, shared with the
// packed-int4 consumer (gemm_w4a8.cu). Rank. R and R2 take any width: the
// two low-rank tiles live in dynamic shared memory sized for one chunk of at
// most 128 ranks, over the ring once the products are done, and a wider rank
// runs its chunks one after another through them (the same sums in the same
// order, so a rank up to 128 gives the outputs it gave before).
#include "grouped_epi.cuh"

namespace {

using grouped::BN;
using grouped::GroupedEpi;
using grouped::Res;
constexpr int ST = 4;
using Src = gemm90::TmaS8<BN>;

}  // namespace

// qact (M, K) int8, ascales (G, M) f32, wt (N, K) int8 (the (K, N) weight
// K-contiguous), wscales (N,) f32,
// lora_act (M, R) f32 | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null,
// residual: x (M, N) bf16 | null (no residual), gate (B, N) f32 with S = M / B
// rows per batch, extra (M, N) bf16 | null, extra_la (M, R2) f32 | null,
// extra_pu (R2, N) bf16 | null
// -> out (M, N) bf16. Needs M % 128 == 0, N % 128 == 0, (K / G) % 64 == 0.
// G = 1 is the rank-1 mode. layer_idx: null, or a device int32 naming the
// layer of a stack of L weights, each stored (N, K), that starts at wt.
extern "C" int nt_gemm_w8a8_grouped(const void* qact, const void* ascales, const void* wt,
                                    const void* wscales, const void* lora_act, const void* proj_up,
                                    const void* bias, const void* x, const void* gate,
                                    const void* extra, const void* extra_la, const void* extra_pu,
                                    void* out, int M, int N, int K, int G, int R, int S, int R2,
                                    const void* layer_idx, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Res res{static_cast<const bf16*>(x), static_cast<const float*>(gate), static_cast<const bf16*>(extra),
                static_cast<const float*>(extra_la), static_cast<const bf16*>(extra_pu), S,
                extra_la == nullptr ? 0 : R2};
  if (R < 0 || G < 1 || K % G != 0 || (K / G) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Src::Params p;
  if (!Src::maps(p, qact, wt, M, N, K, G, static_cast<const int*>(layer_idx), L))
    return static_cast<int>(cudaErrorInvalidValue);
  auto params = [&](auto epi) {
    typename decltype(epi)::Params e{static_cast<const float*>(ascales), static_cast<const float*>(wscales),
                                     static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
                                     static_cast<const bf16*>(bias), static_cast<bf16*>(out), R, res};
    return e;
  };
  if (x != nullptr)
    return gemm90::launch<gemm90::S8, BN, ST, Src, GroupedEpi<true>>(p, params(GroupedEpi<true>{}), M, N, K, s);
  return gemm90::launch<gemm90::S8, BN, ST, Src, GroupedEpi<false>>(p, params(GroupedEpi<false>{}), M, N, K, s);
}
