// int8 GEMM probe: int8 A (M, K) row-major times int8 W (K, N), s32
// accumulators in registers, bf16 out. No model path launches it; the ported
// GEMM probe tools (nunchaku_tpu_torch/tools/) measure with it the s8 main loop
// the int8 chain kernels run (gemm_sm90.cuh), apart from their epilogues.
//
// Replaces the int8 bodies of the TPU probe scripts' Pallas kernels:
// tools/bench_gemm_variants.py k_i8dot (:107, launched by grid_call :27),
// k_v7 (:159) and v7_with (:178, pallas_call :188); tools/probe_int8_mxu.py
// mk_kernel (:48, pallas_mm :73) on int8 operands; tools/probe_m512.py
// kern_i8 (:30, pallas_mm :68); tools/tune_gemm_impl.py kern (:70, pallas_mm
// :92). Modes:
//   F32   false: one s32 sum over all of K; true: each 128-deep K tile's s32
//         partial converted to f32 and added in f32, in K order (k_i8dot,
//         k_v7, probe_int8_mxu line B);
//   RANK1 false: bf16(f32(acc)); true: bf16((acc * a_scale[m]) * w_scale[n])
//         in f32, in that order (k_v7). int32 -> bf16 goes through f32
//         (__int2float_rn, then __float2bfloat16_rn), as XLA's astype does.
// The weight is read K-contiguous, W stored as its (N, K) transpose: the
// layout 8-bit wgmma reads (K-major B) and the int8 chain kernels' weights.
//
// Bound on the H100: operations (2*M*N*K int8 ops at 1979 TOP/s; at M 4608,
// K 3072, N 12288 0.176 ms against 0.05 ms of bytes; at the M 512 text-stream
// shapes near the ridge).
//
// Design: the instantiations gemm90::gemm_sm90_kernel<S8, BN, ST, TmaS8<BN>,
// ProbeEpi> of the loop rows 2 and 3 run (one TMA producer warpgroup, two
// consumer warpgroups of 64 rows on wgmma m64nBNk32 s8, a ring of ST K tiles
// of 128 bytes, banded block order), with the epilogue below; and one
// persistent form of it (probe_i8_persistent_kernel): one block an SM walks
// the banded tiles blockIdx.x, + gridDim.x, ..., its producer running on into
// the next tile's K tiles while the consumers write a tile's outputs.
//   - F32 false: FOLDS false, one K group; the epilogue converts the s32 sums
//     in their wgmma layout and stores bf16 pairs from registers.
//   - F32 true: FOLDS true with every K tile its own group (TmaS8::maps with
//     G = K / 128): each tile's products start from zero and, once done
//     (wgmma.wait_group 0), fold into f32 registers (__int2float_rn, exact:
//     a tile's partial is at most 2^21 in magnitude; then __fadd_rn). The
//     other route, two s32 accumulator sets so that tile t - 1 folds under
//     tile t's products, needs 3 x 64 registers beside the addresses, over
//     the 168 ptxas gives a 384-thread kernel's consumers (C7512): not built.
//     The fold's instructions cost more than the wait (PERF.md row 22a): the
//     running sum is zeroed where it is made, not by a select at each K
//     group, and I2F (two instructions a value) beat the full-rate 2^23-bias
//     conversion (three).
// Tiles: BM 128 and BK 128 always; BN 128 at ST 3, 4 (the chain pair's own
// instantiation: tile "chain") and 6; BN 256 at ST 3 and 4 (i32 only: 128 s32
// and 128 f32 registers do not fit); the persistent form at BN 128 and 256,
// ST 4. Built: the modes the ported tools launch (nt_gemm_probe_i8 below).
#include "gemm_sm90.cuh"

namespace {

using namespace sm90;
using gemm90::A_TILE;
using gemm90::BM;
using gemm90::S8;
using gemm90::TmaS8;

// bf16(v) of the thread's outputs (rows row0 and row0 + 8, columns n0 + 8 j + 2 t4 (+1)) into out (M, N), v =
// f32(acc) (F32 false) or the f32 sum of the K tiles' partials (true), times a_scale[m] then w_scale[n] if RANK1.
template <bool F32, bool RANK1>
struct ProbeEpi {
  struct Params {
    bf16* out;
    const float* as;  // (M,) and (N,), RANK1 only
    const float* ws;
  };
  static constexpr bool FOLDS = F32;
  template <int BN>
  struct State {
    // the f32 running sum, in the accumulators' layout, zero where the state is made (before the K loop: a
    // reset at the first K group, as begin_group(g == 0), costs a select a value at every group)
    float f[F32 ? BN / 2 : 1] = {};
  };
  __host__ __device__ static int smem(const Params&) { return 0; }
  template <int BN>
  __device__ static void begin_group(const Params&, State<BN>&, int, int, int) {}
  template <int BN>
  __device__ static void fold(const Params&, State<BN>& st, const int (&acc)[BN / 2], int, int) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) st.f[i] = __fadd_rn(st.f[i], __int2float_rn(acc[i]));
  }
  template <int BN>
  __device__ static void finish(const Params& e, State<BN>& st, const int (&acc)[BN / 2], unsigned char*, int,
                                int n0, int row0, int ct, int, int N) {
    const int c = n0 + 2 * (ct & 3);
    float a0 = 1.f, a1 = 1.f;
    if constexpr (RANK1) {
      a0 = __ldg(e.as + row0);
      a1 = __ldg(e.as + row0 + 8);
    }
    bf16* dst0 = e.out + static_cast<size_t>(row0) * N + c;
    bf16* dst1 = dst0 + static_cast<size_t>(8) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (F32)
          v[q] = st.f[4 * j + q];
        else
          v[q] = __int2float_rn(acc[4 * j + q]);
      }
      if constexpr (RANK1) {
        const float2 w = __ldg(reinterpret_cast<const float2*>(e.ws + c + 8 * j));
        v[0] = __fmul_rn(__fmul_rn(v[0], a0), w.x);
        v[1] = __fmul_rn(__fmul_rn(v[1], a0), w.y);
        v[2] = __fmul_rn(__fmul_rn(v[2], a1), w.x);
        v[3] = __fmul_rn(__fmul_rn(v[3], a1), w.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) = __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) = __floats2bfloat162_rn(v[2], v[3]);
    }
  }
};

// The persistent form: gemm_sm90_kernel's producer and consumers over the banded tiles blockIdx.x + i gridDim.x.
// The ring's K tiles run on from one output tile to the next (K tile c of the block in stage c % ST), so the
// producer loads the next tile's first ST K tiles while the consumers write this one's outputs; each K tile's stage
// is released once its products are done (the last of each K group after its wait_group 0). The epilogue writes
// from registers only (ProbeEpi: no shared memory), so it needs no barrier with the other consumer warpgroup.
template <int BN, int ST, class Epi>
__global__ void __launch_bounds__(gemm90::THREADS, 1)
    probe_i8_persistent_kernel(const __grid_constant__ typename TmaS8<BN>::Params p,
                               const __grid_constant__ typename Epi::Params e, int M, int N, int K) {
  using Src = TmaS8<BN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + gemm90::bar_offset<ST, Src, Epi>(e));
  uint64_t* empty = full + ST;
  const int mt = M / BM, nt = N / BN, tiles = mt * nt;
  const int groups = Src::groups(p), tpg = Src::group_tiles(p, K);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (role == 0) {
    // ---- producer ----
    reg_dealloc<gemm90::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int c = 0;
      for (int v = blockIdx.x; v < tiles; v += gridDim.x) {
        int m0, n0;
        gemm90::band_tile(v, mt, nt, BN, m0, n0);
        for (int t = 0; t < groups * tpg; ++t, ++c) {
          const int s = c % ST;
          mbar_wait(empty + s, ((c / ST) & 1) ^ 1);
          Src::load(p, sm + s * Src::STAGE, full + s, m0, n0, t);
        }
      }
    }
    return;
  }
  // ---- consumers: 64 rows a warpgroup ----
  reg_alloc<gemm90::CONSUMER_REGS>();
  const int ct = threadIdx.x - WG, cw = ct / WG, warp = (ct % WG) / 32, lane = ct % 32;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int c = 0;
  for (int v = blockIdx.x; v < tiles; v += gridDim.x) {
    int m0, n0;
    gemm90::band_tile(v, mt, nt, BN, m0, n0);
    const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
    typename Epi::template State<BN> st;
    for (int g = 0; g < groups; ++g) {
      Epi::begin_group(e, st, g, row0, M);
      for (int i = 0; i < tpg; ++i, ++c) {
        const int s = c % ST;
        mbar_wait(full + s, (c / ST) & 1);
        const unsigned char* a = sm + s * Src::STAGE + cw * 64 * 128;
        const unsigned char* w = sm + s * Src::STAGE + A_TILE;
        reg_fence(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < S8::BK / S8::K_STEP; ++kk)  // a K group's first k step overwrites (one group: the tile)
          S8::mma<BN>(acc, sw128_desc(a + kk * 32), S8::w_desc(w, kk), i > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();  // K tile c - 1's products are done
        if (i > 0 && lane == 0) mbar_arrive(empty + (c - 1) % ST);
      }
      wg_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty + (c - 1) % ST);
      if constexpr (Epi::FOLDS) Epi::fold(e, st, acc, g, row0);
    }
    Epi::finish(e, st, acc, sm, m0, n0, row0, ct, M, N);
  }
}

template <int BN, int ST, class Epi>
int launch_persistent(const typename TmaS8<BN>::Params& p, const typename Epi::Params& e, int M, int N, int K,
                      cudaStream_t stream) {
  const int bytes = gemm90::smem_bytes<ST, TmaS8<BN>, Epi>(e);
  if (bytes > gemm90::MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(probe_i8_persistent_kernel<BN, ST, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = M / BM * (N / BN), grid = tiles < sm_count() ? tiles : sm_count();
  probe_i8_persistent_kernel<BN, ST, Epi><<<grid, gemm90::THREADS, bytes, stream>>>(p, e, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int ST, bool PERSISTENT, bool F32, bool RANK1>
int launch(const void* a, const void* wt, const float* as, const float* ws, bf16* out, int M, int N, int K,
           cudaStream_t stream) {
  using Epi = ProbeEpi<F32, RANK1>;
  if (M <= 0 || N <= 0 || K <= 0 || M % BM || N % BN || K % (F32 ? S8::BK : 64) ||
      (RANK1 && (as == nullptr || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  typename TmaS8<BN>::Params p;
  if (!TmaS8<BN>::maps(p, a, wt, M, N, K, F32 ? K / S8::BK : 1, nullptr, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const typename Epi::Params e{out, as, ws};
  if constexpr (PERSISTENT)
    return launch_persistent<BN, ST, Epi>(p, e, M, N, K, stream);
  else
    return gemm90::launch<S8, BN, ST, TmaS8<BN>, Epi>(p, e, M, N, K, stream);
}

// the modes built at a tile: i32 cast always, f32 cast and f32 rank-1 where the ported tools launch them
template <int BN, int ST, bool PERSISTENT, bool F32_CAST, bool F32_RANK1>
int launch_mode(int f32acc, int rank1, const void* a, const void* wt, const float* as, const float* ws, bf16* out,
                int M, int N, int K, cudaStream_t stream) {
  if (!f32acc && !rank1) return launch<BN, ST, PERSISTENT, false, false>(a, wt, as, ws, out, M, N, K, stream);
  if constexpr (F32_CAST) {
    if (f32acc && !rank1) return launch<BN, ST, PERSISTENT, true, false>(a, wt, as, ws, out, M, N, K, stream);
  }
  if constexpr (F32_RANK1) {
    if (f32acc && rank1) return launch<BN, ST, PERSISTENT, true, true>(a, wt, as, ws, out, M, N, K, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (M, K) int8 row-major, wt (N, K) int8 (the (K, N) weight, K-contiguous),
// as (M,) and ws (N,) f32 (rank1 only, else null) -> out (M, N) bf16; every
// pointer 16-byte aligned. tile (BN, ring stages): 0 "chain" (128, 4), 1
// (128, 3), 2 (128, 6), 3 (256, 3), 4 (256, 4), 5 persistent (128, 4), 6
// persistent (256, 4). Built (f32acc, rank1): (0, 0) at every tile; (1, 1) at
// tiles 0, 1, 2, 5; (1, 0) at tile 0. M % 128 == 0, N % BN == 0, K % 64 == 0 (K % 128 == 0 with f32acc).
extern "C" int nt_gemm_probe_i8(const void* a, const void* wt, const void* as, const void* ws, void* out, int M,
                                int N, int K, int tile, int f32acc, int rank1, void* stream) {
  const auto* pas = static_cast<const float*>(as);
  const auto* pws = static_cast<const float*>(ws);
  auto* po = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_mode<128, 4, false, true, true>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 1: return launch_mode<128, 3, false, false, true>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 2: return launch_mode<128, 6, false, false, true>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 3: return launch_mode<256, 3, false, false, false>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 4: return launch_mode<256, 4, false, false, false>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 5: return launch_mode<128, 4, true, false, true>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    case 6: return launch_mode<256, 4, true, false, false>(f32acc, rank1, a, wt, pas, pws, po, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
