// The grouped consumer's epilogue on the s8 instantiations of gemm_sm90.cuh: the K groups' scaled f32 sum in
// registers, then the WMMA kernels' epilogue arithmetic a thread per 4 x 16 block, with or without the block's
// gated residual (RES). Shared by the int8 consumer (gemm_w8a8_grouped.cu, TmaS8 source) and the packed-int4
// w4a8 GEMM (gemm_w4a8.cu, the decoding source W4Src; RES false), so the two give the same outputs bit for bit
// on the same logical weight.
//
// Rank. The rank-R branch and the residual's rank-R2 branch run in chunks of RANK_CHUNK (128) ranks through
// tiles sized for one chunk (int8_gemm.cuh lora_sums_all), each sum over the ranks in order: any rank runs, and
// shared memory stays that of rank 128. A row tile past M (the packed GEMM takes any M; RES needs M % 128 == 0)
// reads its row scales as 0 and writes no row at or past M.
#pragma once

#include "gemm_sm90.cuh"
#include "int8_gemm.cuh"

namespace {

namespace grouped {

using gemm90::BM;
constexpr int BN = 128;
constexpr int LDF = BN + 8;  // f32 row stride of the staged accumulator tile (conflict-free 8-byte stores)

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

// The consumer's epilogue on an s8 main loop: the K groups' scaled f32 sum in registers, then the WMMA
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
  // [0, f tile) the staged sums [BM][LDF] f32; then the low-rank tiles of one chunk of R and of R2 (the extra's)
  __host__ __device__ static int smem(const Params& e) {
    return static_cast<int>(i8gemm::align128(static_cast<size_t>(BM) * LDF * 4) +
                            i8gemm::lora_rows_bytes(i8gemm::lora_chunk(e.R)) +
                            i8gemm::lora_rows_bytes(i8gemm::lora_chunk(RES ? e.res.R2 : 0)));
  }
  __device__ static void begin_group(const Params& e, State<BN>& st, int g, int row0, int M) {
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) st.f[i] = 0.f;
    }
    st.a0 = row0 < M ? __ldg(e.as + static_cast<size_t>(g) * M + row0) : 0.f;
    st.a1 = row0 + 8 < M ? __ldg(e.as + static_cast<size_t>(g) * M + row0 + 8) : 0.f;
  }
  __device__ static void fold(const Params&, State<BN>& st, const int (&acc)[BN / 2], int, int) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      st.f[i] = __fadd_rn(st.f[i], __fmul_rn(static_cast<float>(acc[i]), (i & 2) ? st.a1 : st.a0));
  }
  __device__ static void finish(const Params& e, State<BN>& st, const int (&)[BN / 2], unsigned char* sm, int m0,
                                int n0, int row0, int ct, int M, int N) {
    constexpr int THREADS = 2 * sm90::WG;
    float* ft = reinterpret_cast<float*>(sm);
    const size_t f_bytes = i8gemm::align128(static_cast<size_t>(BM) * LDF * 4);
    const int rc = i8gemm::lora_chunk(e.R), rc2 = i8gemm::lora_chunk(e.res.R2);
    unsigned char* lbase = sm + f_bytes;
    unsigned char* ebase = lbase + i8gemm::lora_rows_bytes(rc);
    const i8gemm::LoraRows lora = i8gemm::lora_rows(lbase, rc);
    const i8gemm::LoraRows elora = i8gemm::lora_rows(ebase, rc2);
    auto sync = [] { sm90::named_sync(gemm90::EPI_BAR); };
    {  // the sums into the tile: rows row0 and row0 + 8, columns 8j + 2 t4 (+1)
      const int r = row0 - m0, c = 2 * (ct & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(ft + r * LDF + 8 * j + c) = make_float2(st.f[4 * j], st.f[4 * j + 1]);
        *reinterpret_cast<float2*>(ft + (r + 8) * LDF + 8 * j + c) = make_float2(st.f[4 * j + 2], st.f[4 * j + 3]);
      }
    }
    // the first chunk of each rank's tiles (all of a rank up to 128)
    if (e.R > 0) i8gemm::stage_lora_rows(lora, e.la, e.R, e.pu, m0, n0, N, M, ct, THREADS);
    if (RES && e.res.R2 > 0) i8gemm::stage_lora_rows(elora, e.res.ela, e.res.R2, e.res.epu, m0, n0, N, M, ct, THREADS);
    cp_async_wait<0>();
    sync();
    // a thread per 4 x 16 block: rows r0 .. r0 + 3, the 8 columns c0 + 64h of each half h of the tile
    const int r0 = (ct >> 5) * 16 + ((ct >> 3) & 3) * 4, c0 = (ct & 7) * 8;
    float s[64];  // the rank-R sums, then the extra's rank-R2 sums: s[8 (2q + h) + k]
    if (e.R > 0) i8gemm::lora_sums_all(lora, e.la, e.pu, e.R, m0, n0, N, M, ct, THREADS, s, r0, c0, lbase, sync);
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
        } else if (m0 + ml < M) {
          store8(e.out + static_cast<size_t>(m0 + ml) * N + n, o);
        }
      }
    }
    if (!RES) return;
    const Res& res = e.res;
    if (res.extra != nullptr && res.R2 > 0)
      i8gemm::lora_sums_all(elora, res.ela, res.epu, res.R2, m0, n0, N, M, ct, THREADS, s, r0, c0, ebase, sync);
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

}  // namespace grouped
}  // namespace
