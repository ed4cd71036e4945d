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
// Rank. R and R2 run up to 128 (nunchaku's rank-128 checkpoints): the two
// low-rank tiles live in dynamic shared memory sized by the call's ranks,
// over the ring once the products are done.
#include "gemm_sm90.cuh"
#include "int8_gemm.cuh"

namespace {

using gemm90::BM;
constexpr int BN = 128, ST = 4;
constexpr int LDF = BN + 8;  // f32 row stride of the staged accumulator tile (conflict-free 8-byte stores)
using Src = gemm90::TmaS8<BN>;

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

// eight bf16 of a read-only operand, as f32
__device__ __forceinline__ void load8(float (&d)[8], const bf16* p) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* b = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = bf2f(b[i]);
}

// eight f32 of the staged tile
__device__ __forceinline__ void load8f(float (&d)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

__device__ __forceinline__ void store8f(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// eight values as bf16 in one 16-byte store
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 packed;
  bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int k = 0; k < 8; ++k) pb[k] = __float2bfloat16(v[k]);
  *reinterpret_cast<uint4*>(p) = packed;
}

__device__ __forceinline__ float round_bf16(float v) { return bf2f(__float2bfloat16(v)); }

// The consumer's epilogue on the s8 main loop: the K groups' scaled f32 sum in registers, then the WMMA
// kernel's epilogue arithmetic a thread per 4 x 16 block.
template <bool RES>
struct GroupedEpi {
  struct Params {
    const float* as;  // (G, M)
    const float* ws;
    const float* la;
    const bf16* pu;
    const bf16* bias;
    bf16* out;
    int R;
    Res res;
  };
  static constexpr bool FOLDS = true;
  template <int N>
  struct State {
    float f[N / 2];  // the f32 running sum, in the accumulators' layout
    float a0, a1;    // this K group's scales of the thread's two rows
  };
  // [0, f tile) the staged sums [BM][LDF] f32; then the low-rank tiles (lora_rows_bytes(R)) and the extra's (R2)
  __host__ __device__ static int smem(const Params& e) {
    return static_cast<int>(i8gemm::align128(static_cast<size_t>(BM) * LDF * 4) + i8gemm::lora_rows_bytes(e.R) +
                            i8gemm::lora_rows_bytes(RES ? e.res.R2 : 0));
  }
  __device__ static void begin_group(const Params& e, State<BN>& st, int g, int row0, int M) {
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) st.f[i] = 0.f;
    }
    st.a0 = __ldg(e.as + static_cast<size_t>(g) * M + row0);
    st.a1 = __ldg(e.as + static_cast<size_t>(g) * M + row0 + 8);
  }
  __device__ static void fold(const Params&, State<BN>& st, const int (&acc)[BN / 2], int, int) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      st.f[i] = __fadd_rn(st.f[i], __fmul_rn(static_cast<float>(acc[i]), (i & 2) ? st.a1 : st.a0));
  }
  __device__ static void finish(const Params& e, State<BN>& st, const int (&)[BN / 2], unsigned char* sm, int m0,
                                int n0, int row0, int ct, int, int N) {
    float* ft = reinterpret_cast<float*>(sm);
    const size_t f_bytes = i8gemm::align128(static_cast<size_t>(BM) * LDF * 4);
    const i8gemm::LoraRows lora = i8gemm::lora_rows(sm + f_bytes, e.R);
    const i8gemm::LoraRows elora = i8gemm::lora_rows(sm + f_bytes + i8gemm::lora_rows_bytes(e.R), e.res.R2);
    {  // the sums into the tile: rows row0 and row0 + 8, columns 8j + 2 t4 (+1)
      const int r = row0 - m0, c = 2 * (ct & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(ft + r * LDF + 8 * j + c) = make_float2(st.f[4 * j], st.f[4 * j + 1]);
        *reinterpret_cast<float2*>(ft + (r + 8) * LDF + 8 * j + c) = make_float2(st.f[4 * j + 2], st.f[4 * j + 3]);
      }
    }
    if (e.R > 0) i8gemm::stage_lora_rows(lora, e.la, e.pu, m0, n0, N, ct, 2 * sm90::WG);
    if (RES && e.res.R2 > 0) i8gemm::stage_lora_rows(elora, e.res.ela, e.res.epu, m0, n0, N, ct, 2 * sm90::WG);
    cp_async_wait<0>();
    sm90::named_sync(gemm90::EPI_BAR);
    // a thread per 4 x 16 block: rows r0 .. r0 + 3, the 8 columns c0 + 64h of each half h of the tile
    const int r0 = (ct >> 5) * 16 + ((ct >> 3) & 3) * 4, c0 = (ct & 7) * 8;
    float s[64];  // the rank-R sums, then the extra's rank-R2 sums: s[8 (2q + h) + k]
    if (e.R > 0) i8gemm::lora_sums_4x16(lora, s, r0, c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = c0 + 64 * h, n = n0 + nl;
      float w[8], b[8];
      ldg8f(w, e.ws + n);
      if (e.bias != nullptr) load8(b, e.bias + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ml = r0 + q;
        float o[8];
        load8f(o, ft + ml * LDF + nl);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = __fmul_rn(o[k], w[k]);
        if (e.R > 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(o[k], s[8 * (2 * q + h) + k]);
        }
        if (e.bias != nullptr) {
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(o[k], b[k]);
        }
        if (RES) {  // t = bf16(out), kept in the tile for the residual pass
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = round_bf16(o[k]);
          store8f(ft + ml * LDF + nl, o);
        } else {
          store8(e.out + static_cast<size_t>(m0 + ml) * N + n, o);
        }
      }
    }
    if (!RES) return;
    const Res& res = e.res;
    if (res.extra != nullptr && res.R2 > 0) i8gemm::lora_sums_4x16(elora, s, r0, c0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = c0 + 64 * h, n = n0 + nl;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ml = r0 + q, m = m0 + ml;
        const size_t at = static_cast<size_t>(m) * N + n;
        float o[8], xv[8], gv[8];
        load8f(o, ft + ml * LDF + nl);
        load8(xv, res.x + at);
        ldg8f(gv, res.gate + static_cast<size_t>(m / res.S) * N + n);
        if (res.extra != nullptr) {
          float ev[8];
          load8(ev, res.extra + at);
          if (res.R2 > 0) {
#pragma unroll
            for (int k = 0; k < 8; ++k) ev[k] = __fadd_rn(ev[k], s[8 * (2 * q + h) + k]);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(o[k], round_bf16(ev[k]));
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = __fadd_rn(xv[k], __fmul_rn(gv[k], o[k]));
        store8(e.out + at, o);
      }
    }
  }
};

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Res res{static_cast<const bf16*>(x), static_cast<const float*>(gate), static_cast<const bf16*>(extra),
                static_cast<const float*>(extra_la), static_cast<const bf16*>(extra_pu), S,
                extra_la == nullptr ? 0 : R2};
  if (R > i8gemm::MAX_R || res.R2 > i8gemm::MAX_R || G < 1 || K % G != 0 || (K / G) % 64 != 0)
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
