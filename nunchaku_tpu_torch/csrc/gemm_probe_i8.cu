// int8 GEMM probe: int8 A (M, K) row-major times int8 W (K, N), int32
// accumulators in registers, bf16 out. No model path launches it; the ported
// GEMM probe tools (nunchaku_tpu_torch/tools/) measure the card's int8
// product with it, apart from any epilogue of the chain kernels.
//
// Replaces the int8 bodies of the TPU probe scripts' Pallas kernels:
// tools/bench_gemm_variants.py k_i8dot (:107, launched by grid_call :27),
// k_v7 (:159) and v7_with (:178, pallas_call :188); tools/probe_int8_mxu.py
// mk_kernel (:48, pallas_mm :73) on int8 operands; tools/probe_m512.py
// kern_i8 (:30, pallas_mm :68); tools/tune_gemm_impl.py kern (:70, pallas_mm
// :92). Template parameters:
//   ACC   F32ACC = false: one int32 sum over all of K; true: each K tile's
//         int32 partial converted to f32 (rn) and added in f32, in K order
//         (k_i8dot, k_v7, probe_int8_mxu line B);
//   EPI   RANK1 = false: bf16(f32(acc)); true: bf16((acc * a_scale[m]) *
//         w_scale[n]) in f32, in that order (k_v7). int32 -> bf16 goes
//         through f32 (__int2float_rn, then __float2bfloat16_rn), as XLA's
//         astype does;
//   tile  (BM, BN, BK, warps along M, stages), 8 warps in every tile.
// The weight is read K-contiguous, W stored as its (N, K) transpose: the
// tensor cores' int8 layout (mma.sync s8 takes B "col", and ldmatrix .trans
// does not transpose 8-bit data), the layout of int8_gemm.cuh.
//
// Bound on the H100: operations (2*M*N*K int8 ops at 1979 TOP/s; at M 4608,
// K 3072, N 12288 0.176 ms against 0.05 ms of bytes; at the M 512 text-stream
// shapes near the ridge). Design: a STAGES-deep cp.async ring of A and W
// tiles in shared memory, rows BK + 16 bytes apart (ldmatrix's eight row
// addresses fall in distinct banks); each warp owns a WTM x WTN sub-tile as
// m16n8k32 s8 mma.sync fragments (mma.cuh), loaded by ldmatrix as in
// flash_fixed_i8.cu, so the accumulators' register layout is known and the
// epilogue writes bf16 pairs from registers. In the f32 mode a warp first
// loads the whole K tile's fragments, then runs each output fragment's
// chain over the tile into a 4-register int32 partial and adds it to the f32
// accumulator: one int32 partial live at a time, so the 64 x 64 warp tiles
// fit 255 registers with both sums.
//
// The 128 x 128 x 64 tile keeps the chain kernels' geometry (2 x 4 warps of
// 64 x 32, two stages). The "chain" tile is int8_gemm.cuh's own main loop
// (WMMA, i8gemm::mainloop) with this kernel's epilogue, int32 only: that
// loop takes all of K in one call and its WMMA fragments' register layout
// is opaque, so a per-K-tile f32 conversion would need a hook inside the
// file every chain kernel compiles; its int32 cast form alone shows the chain
// kernels' main-loop rate without their epilogues. Built: the modes the
// ported tools launch (nt_gemm_probe_i8 below).
#include "int8_gemm.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;

template <int BM_, int BN_, int BK_, int WARPS_M_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, STAGES = STAGES_;
  static constexpr int WARPS_N = THREADS / 32 / WARPS_M;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // a warp's sub-tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;             // its m16 / n8 mma tiles
  static constexpr int KS = BK / 32;                            // k32 steps of a K tile
  static constexpr int LD = BK + 16;                            // shared row stride, bytes
  static constexpr int STAGE_BYTES = (BM + BN) * LD;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(NT % 2 == 0 && WTM % 16 == 0 && BK % 32 == 0 && STAGES >= 2, "tile shape");
};

typedef Tile<128, 128, 64, 2, 2> T128x128x64;   // the chain kernels' geometry
typedef Tile<128, 128, 128, 2, 3> T128x128x128;
typedef Tile<128, 256, 64, 2, 3> T128x256x64;   // 64 x 64 warp tiles
typedef Tile<256, 128, 64, 4, 3> T256x128x64;

// A rows m0.. and W (as (N, K)) rows n0.. of K tile k0 into one stage: a[BM][LD] then b[BN][LD]
template <class T>
__device__ __forceinline__ void load_stage(int8_t* st, const int8_t* a, const int8_t* wt, int m0, int n0, int k0,
                                           int K) {
  constexpr int CH = T::BK / 16;
  for (int c = threadIdx.x; c < T::BM * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    cp_async16(st + r * T::LD + cc * 16, a + static_cast<size_t>(m0 + r) * K + k0 + cc * 16, true);
  }
  int8_t* sb = st + T::BM * T::LD;
  for (int c = threadIdx.x; c < T::BN * CH; c += THREADS) {
    const int r = c / CH, cc = c % CH;
    cp_async16(sb + r * T::LD + cc * 16, wt + static_cast<size_t>(n0 + r) * K + k0 + cc * 16, true);
  }
}

template <class T, bool F32ACC, bool RANK1>
__global__ void __launch_bounds__(THREADS)
    gemm_probe_i8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt, const float* __restrict__ as,
                         const float* __restrict__ ws, bf16* __restrict__ out, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which 8x8 matrix, which of its rows
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int nk = K / T::BK;

  int acc[T::MT][T::NT][4];                                     // i32: the sum over K
  float facc[F32ACC ? T::MT : 1][F32ACC ? T::NT : 1][4];        // f32: the sum of the K tiles' partials
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        if constexpr (F32ACC) facc[i][j][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load_stage<T>(smem + s * T::STAGE_BYTES, a, wt, m0, n0, s * T::BK, K);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with the stage refilled next
    const int tn = t + T::STAGES - 1;
    if (tn < nk) load_stage<T>(smem + (tn % T::STAGES) * T::STAGE_BYTES, a, wt, m0, n0, tn * T::BK, K);
    cp_async_commit();
    const int8_t* sa = smem + (t % T::STAGES) * T::STAGE_BYTES + (wm * T::WTM) * T::LD;
    const int8_t* sb = smem + (t % T::STAGES) * T::STAGE_BYTES + (T::BM + wn * T::WTN) * T::LD;
    if constexpr (!F32ACC) {
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks) {
        uint32_t af[T::MT][4];
#pragma unroll
        for (int i = 0; i < T::MT; ++i)  // matrix mi: rows +8*(mi&1), bytes +16*(mi>>1)
          ldsm_x4(sa + (i * 16 + (mi & 1) * 8 + mr) * T::LD + ks * 32 + (mi >> 1) * 16, af[i][0], af[i][1],
                  af[i][2], af[i][3]);
#pragma unroll
        for (int j2 = 0; j2 < T::NT / 2; ++j2) {
          // matrix mi: W rows (n) +8*(mi>>1) (next n8 tile), bytes +16*(mi&1) (b1 half)
          uint32_t b0, b1, b2, b3;
          ldsm_x4(sb + (j2 * 16 + (mi >> 1) * 8 + mr) * T::LD + ks * 32 + (mi & 1) * 16, b0, b1, b2, b3);
#pragma unroll
          for (int i = 0; i < T::MT; ++i) {
            mma_s8(acc[i][2 * j2], af[i], b0, b1);
            mma_s8(acc[i][2 * j2 + 1], af[i], b2, b3);
          }
        }
      }
    } else {
      uint32_t af[T::KS][T::MT][4], bfr[T::KS][T::NT][2];
#pragma unroll
      for (int ks = 0; ks < T::KS; ++ks) {
#pragma unroll
        for (int i = 0; i < T::MT; ++i)
          ldsm_x4(sa + (i * 16 + (mi & 1) * 8 + mr) * T::LD + ks * 32 + (mi >> 1) * 16, af[ks][i][0],
                  af[ks][i][1], af[ks][i][2], af[ks][i][3]);
#pragma unroll
        for (int j2 = 0; j2 < T::NT / 2; ++j2)
          ldsm_x4(sb + (j2 * 16 + (mi >> 1) * 8 + mr) * T::LD + ks * 32 + (mi & 1) * 16, bfr[ks][2 * j2][0],
                  bfr[ks][2 * j2][1], bfr[ks][2 * j2 + 1][0], bfr[ks][2 * j2 + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          int p[4] = {0, 0, 0, 0};  // this K tile's exact int32 partial
#pragma unroll
          for (int ks = 0; ks < T::KS; ++ks) mma_s8(p, af[ks][i], bfr[ks][j][0], bfr[ks][j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) facc[i][j][e] = __fadd_rn(facc[i][j][e], __int2float_rn(p[e]));
        }
    }
  }
  cp_async_wait<0>();

  // fragment (i, j): rows g / g + 8 of m16 tile i, columns 2 t4, 2 t4 + 1 of n8 tile j
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * T::WTM + i * 16 + g + 8 * h;
      const float sa_m = RANK1 ? __ldg(as + m) : 1.f;
      bf16* dst = out + static_cast<size_t>(m) * N + n0 + wn * T::WTN + 2 * t4;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        float v0, v1;
        if constexpr (F32ACC) {
          v0 = facc[i][j][2 * h];
          v1 = facc[i][j][2 * h + 1];
        } else {
          v0 = __int2float_rn(acc[i][j][2 * h]);
          v1 = __int2float_rn(acc[i][j][2 * h + 1]);
        }
        if constexpr (RANK1) {
          const int n = n0 + wn * T::WTN + j * 8 + 2 * t4;
          v0 = __fmul_rn(__fmul_rn(v0, sa_m), __ldg(ws + n));
          v1 = __fmul_rn(__fmul_rn(v1, sa_m), __ldg(ws + n + 1));
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// int8_gemm.cuh's main loop (the chain kernels' 128 x 128 x 64 WMMA loop, two
// stages) over all of K, int32, with the cast epilogue.
__host__ __device__ constexpr int chain_smem() {
  return static_cast<int>(i8gemm::align128(2 * sizeof(i8gemm::Stage)) + (i8gemm::THREADS / 32) * 256 * sizeof(int));
}

__global__ void __launch_bounds__(i8gemm::THREADS)
    gemm_probe_i8_chain_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ wt, bf16* __restrict__ out,
                               int N, int K) {
  using namespace i8gemm;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto* st = reinterpret_cast<Stage*>(smem_raw);
  int* scratch = reinterpret_cast<int*>(smem_raw + align128(2 * sizeof(Stage)));
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  AccFrag acc[FM][FN];
  zero(acc);
  mainloop(st, acc, a, WeightI8{wt}, m0, n0, 0, K, K);
  for_each_fragment(scratch + (threadIdx.x / 32) * 256, acc, [&](int, int, int ml, int nl, const int (&v)[8]) {
    uint4 packed;
    bf16* pb = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) pb[i] = __float2bfloat16_rn(__int2float_rn(v[i]));
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + ml) * N + n0 + nl) = packed;
  });
}

template <class T, bool F32ACC, bool RANK1>
int launch(const int8_t* a, const int8_t* wt, const float* as, const float* ws, bf16* out, int M, int N, int K,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gemm_probe_i8_kernel<T, F32ACC, RANK1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(N / T::BN, M / T::BM);
  gemm_probe_i8_kernel<T, F32ACC, RANK1><<<grid, THREADS, T::SMEM, stream>>>(a, wt, as, ws, out, N, K);
  return static_cast<int>(cudaGetLastError());
}

// the modes built at each tile: those the ported tools launch (ACC f32 with the cast
// epilogue at 128 x 128 x 64 only: bench_gemm_variants k_i8dot, probe_int8_mxu line B)
template <class T, bool F32_CAST>
int launch_mode(int f32acc, int rank1, const int8_t* a, const int8_t* wt, const float* as, const float* ws,
                bf16* out, int M, int N, int K, cudaStream_t stream) {
  if (f32acc && rank1) return launch<T, true, true>(a, wt, as, ws, out, M, N, K, stream);
  if (!f32acc && !rank1) return launch<T, false, false>(a, wt, as, ws, out, M, N, K, stream);
  if constexpr (F32_CAST) {
    if (f32acc) return launch<T, true, false>(a, wt, as, ws, out, M, N, K, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a (M, K) int8 row-major, wt (N, K) int8 (the (K, N) weight, K-contiguous),
// as (M,) and ws (N,) f32 (rank1 only, else null) -> out (M, N) bf16.
// tile: 0 128x128x64, 1 128x128x128, 2 128x256x64, 3 256x128x64, 4 the chain
// main loop (128x128x64). Built (f32acc, rank1): (0, 0) and (1, 1) at tiles
// 0-3, (1, 0) at tile 0, (0, 0) at tile 4. M, N, K multiples of the tile.
extern "C" int nt_gemm_probe_i8(const void* a, const void* wt, const void* as, const void* ws, void* out, int M,
                                int N, int K, int tile, int f32acc, int rank1, void* stream) {
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pw = static_cast<const int8_t*>(wt);
  const auto* pas = static_cast<const float*>(as);
  const auto* pws = static_cast<const float*>(ws);
  auto* po = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_mode<T128x128x64, true>(f32acc, rank1, pa, pw, pas, pws, po, M, N, K, s);
    case 1: return launch_mode<T128x128x128, false>(f32acc, rank1, pa, pw, pas, pws, po, M, N, K, s);
    case 2: return launch_mode<T128x256x64, false>(f32acc, rank1, pa, pw, pas, pws, po, M, N, K, s);
    case 3: return launch_mode<T256x128x64, false>(f32acc, rank1, pa, pw, pas, pws, po, M, N, K, s);
    case 4: {
      if (f32acc || rank1) return static_cast<int>(cudaErrorInvalidValue);
      dim3 grid(N / i8gemm::BN, M / i8gemm::BM);
      gemm_probe_i8_chain_kernel<<<grid, i8gemm::THREADS, chain_smem(), s>>>(pa, pw, po, N, K);
      return static_cast<int>(cudaGetLastError());
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
