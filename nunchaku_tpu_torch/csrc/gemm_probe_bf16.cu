// bf16-operand GEMM probe: A (M, K) times W (K, N) on bf16 operands with f32
// accumulation, bf16 out, each operand stored as bf16, as int8 codes (cast
// to bf16, exact) or as packed int4 codes (core/packing.py's block-split-half
// layout: packed column / row 128 b + j holds logical 256 b + j in its low
// nibble and 256 b + 128 + j in its high one, w4_decode.cuh nibble()). With
// SCALED, each decoded operand is multiplied by its group-64 scale and
// rounded to bf16, as the TPU bodies' code.astype(bf16) * scale: one rounding
// of an exact f32 product. No model path launches it; the ported GEMM probe
// tools (nunchaku_tpu_torch/tools/) measure with it what decoding and
// scaling cost a bf16 product.
//
// Replaces the bf16-product bodies of the TPU probe scripts' Pallas kernels:
// tools/bench_gemm_variants.py (grid_call :27) k_bf (:55, bf16 x bf16), k_v1
// (:70, packed both, no scales), k_v2 (:81, int8-held codes, both scaled),
// k_v4 (:96, packed A, int8-held W, scaled) and k_v6 (:118, packed both,
// scaled: its lo / hi nibble planes as two products are a TPU relayout
// workaround; one decode in shared memory computes the same function);
// tools/probe_int8_mxu.py mk_kernel (:48, pallas_mm :73) on bf16 operands;
// tools/probe_m512.py kern_cvt (:47, int8 cast to bf16 inside).
//
// Bound on the H100: operations (2*M*N*K bf16 flop at 989 TFLOP/s; 0.352 ms
// at M 4608, K 3072, N 12288 against about 0.05 ms of bytes). Design: block
// tile 128 x 128 x 64 (one scale group a K tile), 8 warps as 2 x 4 of 64 x 32,
// mma.sync m16n8k16 bf16 (mma.cuh). Each K tile's operands arrive in their
// stored form through a two-stage cp.async ring with their scale rows; a
// bf16 operand lands in its padded bf16 tile and is read from there, a coded
// one (64 bytes a row: one nibble plane of the packed rows p0 = k0 / 256 *
// 128 + k0 % 128, high when k0 % 256 >= 128, or the int8 codes) is decoded
// in shared memory into a padded bf16 tile (144-byte A rows, 272-byte W
// rows: ldmatrix's eight row addresses in distinct banks). A is read with
// ldmatrix, W (N-contiguous) with ldmatrix .trans.
#include "mma.cuh"
#include "w4_decode.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int WARPS_N = 4, WTM = 64, WTN = 32, MT = WTM / 16, NT = WTN / 8;
constexpr int LDA = BK + 8;  // bf16 elements per row of a bf16 A tile
constexpr int LDW = BN + 8;  // bf16 elements per row of a bf16 W tile
constexpr int F_BF16 = 0, F_I8 = 1, F_P4 = 2;

template <int AF, int WF, bool SCALED>
struct Layout {
  static constexpr int RAW_A = AF == F_BF16 ? BM * LDA * 2 : BM * BK;  // stage bytes of A as stored
  static constexpr int RAW_W = WF == F_BF16 ? BK * LDW * 2 : BK * BN;
  static constexpr int SCALES = SCALED ? 2 * (BM + BN) : 0;  // the K tile's scale rows, bf16
  static constexpr int STAGE = RAW_A + RAW_W + SCALES;
  static constexpr int DEC_A = AF == F_BF16 ? 0 : BM * LDA * 2;  // decoded bf16 tiles
  static constexpr int DEC_W = WF == F_BF16 ? 0 : BK * LDW * 2;
  static constexpr int SMEM = 2 * STAGE + DEC_A + DEC_W;
};

template <int AF, int WF, bool SCALED>
__device__ __forceinline__ void load_stage(unsigned char* st, const void* a, const void* w, const bf16* as,
                                           const bf16* ws, int m0, int n0, int k0, int M, int N, int K) {
  using L = Layout<AF, WF, SCALED>;
  const int p0 = k0 / 256 * 128 + k0 % 128;  // the packed column / row of a p4 K tile
  if constexpr (AF == F_BF16) {
    const bf16* pa = static_cast<const bf16*>(a);
    for (int c = threadIdx.x; c < BM * (BK / 8); c += THREADS) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      cp_async16(st + (r * LDA + cc * 8) * 2, pa + static_cast<size_t>(m0 + r) * K + k0 + cc * 8, true);
    }
  } else {
    const int8_t* pa = static_cast<const int8_t*>(a);
    const int ld = AF == F_P4 ? K / 2 : K, c0 = AF == F_P4 ? p0 : k0;
    for (int c = threadIdx.x; c < BM * (BK / 16); c += THREADS) {
      const int r = c / (BK / 16), cc = c % (BK / 16);
      cp_async16(st + r * BK + cc * 16, pa + static_cast<size_t>(m0 + r) * ld + c0 + cc * 16, true);
    }
  }
  unsigned char* sw = st + L::RAW_A;
  if constexpr (WF == F_BF16) {
    const bf16* pw = static_cast<const bf16*>(w);
    for (int c = threadIdx.x; c < BK * (BN / 8); c += THREADS) {
      const int r = c / (BN / 8), cc = c % (BN / 8);
      cp_async16(sw + (r * LDW + cc * 8) * 2, pw + static_cast<size_t>(k0 + r) * N + n0 + cc * 8, true);
    }
  } else {
    const int8_t* pw = static_cast<const int8_t*>(w);
    const int r0 = WF == F_P4 ? p0 : k0;
    for (int c = threadIdx.x; c < BK * (BN / 16); c += THREADS) {
      const int r = c / (BN / 16), cc = c % (BN / 16);
      cp_async16(sw + r * BN + cc * 16, pw + static_cast<size_t>(r0 + r) * N + n0 + cc * 16, true);
    }
  }
  if constexpr (SCALED) {  // scale rows k0 / 64 of (K/64, M) and (K/64, N)
    unsigned char* ss = sw + L::RAW_W;
    const int gk = k0 / 64;
    if (threadIdx.x < BM / 8)
      cp_async16(ss + threadIdx.x * 16, as + static_cast<size_t>(gk) * M + m0 + threadIdx.x * 8, true);
    else if (threadIdx.x < (BM + BN) / 8)
      cp_async16(ss + threadIdx.x * 16, ws + static_cast<size_t>(gk) * N + n0 + (threadIdx.x - BM / 8) * 8, true);
  }
}

// a stored code (int8, or one nibble of a packed byte) -> its bf16 value, times its scale when SCALED
template <int F, bool SCALED>
__device__ __forceinline__ bf16 decode(uint8_t byte, bool hi, float scale) {
  const int code = F == F_P4 ? nibble(byte, hi) : static_cast<int>(static_cast<int8_t>(byte));
  const float v = static_cast<float>(code);
  return __float2bfloat16_rn(SCALED ? __fmul_rn(v, scale) : v);
}

template <int AF, int WF, bool SCALED>
__global__ void __launch_bounds__(THREADS)
    gemm_probe_bf16_kernel(const void* __restrict__ a, const void* __restrict__ w, const bf16* __restrict__ as,
                           const bf16* __restrict__ ws, bf16* __restrict__ out, int M, int N, int K) {
  using L = Layout<AF, WF, SCALED>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* dec_a = reinterpret_cast<bf16*>(smem_raw + 2 * L::STAGE);
  bf16* dec_w = reinterpret_cast<bf16*>(smem_raw + 2 * L::STAGE + L::DEC_A);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  load_stage<AF, WF, SCALED>(smem_raw, a, w, as, ws, m0, n0, 0, M, N, K);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1 (its stage and the decoded tiles)
    if (t + 1 < nk) load_stage<AF, WF, SCALED>(smem_raw + ((t + 1) & 1) * L::STAGE, a, w, as, ws, m0, n0,
                                                (t + 1) * BK, M, N, K);
    cp_async_commit();
    const unsigned char* st = smem_raw + (t & 1) * L::STAGE;
    const bf16* sc = reinterpret_cast<const bf16*>(st + L::RAW_A + L::RAW_W);  // [BM] A scales, [BN] W scales
    const bool hi = (t * BK) % 256 >= 128;
    if constexpr (AF != F_BF16) {  // (row, 8 consecutive k) a thread at a time
      for (int c = threadIdx.x; c < BM * (BK / 8); c += THREADS) {
        const int r = c / (BK / 8), k8 = (c % (BK / 8)) * 8;
        const uint2 raw = *reinterpret_cast<const uint2*>(st + r * BK + k8);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
        const float s = SCALED ? bf2f(sc[r]) : 1.f;
        uint4 v;
        bf16* pv = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[e] = decode<AF, SCALED>(b[e], hi, s);
        *reinterpret_cast<uint4*>(dec_a + r * LDA + k8) = v;
      }
    }
    if constexpr (WF != F_BF16) {  // (k row, 8 consecutive n) a thread at a time
      const unsigned char* sw = st + L::RAW_A;
      for (int c = threadIdx.x; c < BK * (BN / 8); c += THREADS) {
        const int r = c / (BN / 8), n8 = (c % (BN / 8)) * 8;
        const uint2 raw = *reinterpret_cast<const uint2*>(sw + r * BN + n8);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
        uint4 v;
        bf16* pv = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) pv[e] = decode<WF, SCALED>(b[e], hi, SCALED ? bf2f(sc[BM + n8 + e]) : 1.f);
        *reinterpret_cast<uint4*>(dec_w + r * LDW + n8) = v;
      }
    }
    if constexpr (AF != F_BF16 || WF != F_BF16) __syncthreads();  // the decoded tiles, seen by every warp

    const bf16* ta = (AF == F_BF16 ? reinterpret_cast<const bf16*>(st) : dec_a) + (wm * WTM) * LDA;
    const bf16* tw = (WF == F_BF16 ? reinterpret_cast<const bf16*>(st + L::RAW_A) : dec_w) + wn * WTN;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)  // matrix mi: rows +8*(mi&1), k +8*(mi>>1)
        ldsm_x4(ta + (i * 16 + (mi & 1) * 8 + mr) * LDA + kk * 16 + (mi >> 1) * 8, af[i][0], af[i][1], af[i][2],
                af[i][3]);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        // transposed: matrix mi covers k rows +8*(mi&1) (b1 half), n columns +8*(mi>>1) (next n8 tile)
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(tw + (kk * 16 + (mi & 1) * 8 + mr) * LDW + j2 * 16 + (mi >> 1) * 8, b0, b1, b2, b3);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * j2], af[i], b0, b1);
          mma_bf16(acc[i][2 * j2 + 1], af[i], b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WTM + i * 16 + g + 8 * h;
      bf16* dst = out + static_cast<size_t>(m) * N + n0 + wn * WTN + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

template <int AF, int WF, bool SCALED>
int launch(const void* a, const void* w, const bf16* as, const bf16* ws, bf16* out, int M, int N, int K,
           cudaStream_t stream) {
  using L = Layout<AF, WF, SCALED>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gemm_probe_bf16_kernel<AF, WF, SCALED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(N / BN, M / BM);
  gemm_probe_bf16_kernel<AF, WF, SCALED><<<grid, THREADS, L::SMEM, stream>>>(a, w, as, ws, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) bf16 | (M, K) int8 codes | (M, K/2) packed int4; w (K, N) bf16 |
// (K, N) int8 | (K/2, N) packed int4, N-contiguous; forms 0 bf16, 1 int8, 2
// packed int4; scaled: as (K/64, M), ws (K/64, N) bf16, else null -> out (M,
// N) bf16. Built forms (a, w, scaled): (0,0,0) (1,1,0) (2,2,0) (1,1,1) (2,1,1)
// (2,2,1). M, N multiples of 128, K of 64 (of 256 with a packed operand).
extern "C" int nt_gemm_probe_bf16(const void* a, const void* w, const void* as, const void* ws, void* out, int M,
                                  int N, int K, int a_form, int w_form, int scaled, void* stream) {
  const auto* pas = static_cast<const bf16*>(as);
  const auto* pws = static_cast<const bf16*>(ws);
  auto* po = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int key = a_form * 100 + w_form * 10 + (scaled ? 1 : 0);
  switch (key) {
    case 0: return launch<F_BF16, F_BF16, false>(a, w, pas, pws, po, M, N, K, s);
    case 110: return launch<F_I8, F_I8, false>(a, w, pas, pws, po, M, N, K, s);
    case 220: return launch<F_P4, F_P4, false>(a, w, pas, pws, po, M, N, K, s);
    case 111: return launch<F_I8, F_I8, true>(a, w, pas, pws, po, M, N, K, s);
    case 211: return launch<F_P4, F_I8, true>(a, w, pas, pws, po, M, N, K, s);
    case 221: return launch<F_P4, F_P4, true>(a, w, pas, pws, po, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
