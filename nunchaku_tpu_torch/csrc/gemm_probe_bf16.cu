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
// at M 4608, K 3072, N 12288 against about 0.05 ms of bytes). Design: every
// form runs on the wgmma + TMA main loop of gemm_sm90.cuh (K tiles of 64 =
// one scale group, wgmma from shared memory). bf16 x bf16: block tile 128 x
// 256 (wgmma m64n256k16; 128 x 128 tiles ask L2 for ~15 TB/s at the bf16
// peak), TMA copies each K tile of A and W straight into the
// 128-byte-swizzled tiles wgmma reads. A coded form: block tile 128 x 128,
// TMA brings the stored bytes (64 a row: one nibble plane of the packed rows
// p0 = k0 / 256 * 128 + k0 % 128, high when k0 % 256 >= 128, or the int8
// codes) into a raw stage, a bulk copy the K tile's scale rows beside them;
// the two consumer warpgroups decode the stage into swizzled bf16 tiles (16
// bytes, eight values, a store) while the tensor cores run the previous
// tile's products. The decode forms each code's f32 value with byte permutes
// and one subtraction (the 2^23 bias), never I2F, whose quarter rate would
// make the decode, not the products, the bound.
#include "gemm_sm90.cuh"

namespace {

using namespace gemm90;

constexpr int BN_BF16 = 256, BN_CODED = 128, ST = 4;  // block N of the bf16 and the coded forms; ring depth
constexpr int F_I8 = 1, F_P4 = 2;                 // the coded forms (0: bf16)

// bf16 operands: A (M, K) and W (K, N), each K tile copied by TMA into the swizzled tiles as it is
template <int BN>
struct TmaBf16 {
  struct Params {
    CUtensorMap a, w;  // A boxes of 64 columns x 128 rows; W 64 columns x 64 rows; both swizzled
  };
  static constexpr int STAGE = Tiles<BN>::BYTES, EXTRA = 0;
  static constexpr bool DECODES = false;
  __device__ static void load(const Params& p, unsigned char* st, uint64_t* full, int m0, int n0, int t) {
    mbar_expect_tx(full, STAGE);
    tma_load_2d(st, &p.a, full, t * BK, m0);
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) tma_load_2d(st + A_TILE + q * PANEL, &p.w, full, n0 + 64 * q, t * BK);
  }
  __device__ static const unsigned char* tiles(const Params&, const unsigned char* st, unsigned char*, int, int) {
    return st;
  }
};

// four stored codes (a word: int8 codes, or packed int4 bytes of which the low or high nibbles) -> their f32
// values, exactly: each code offset to an unsigned byte u (int8: code + 128; int4: nibble ^ 8, as nibble()
// decodes it) and placed under the exponent of 2^23, so the float is 2^23 + u, minus the bias
template <int F>
__device__ __forceinline__ void codes4(uint32_t word, bool hi, float (&f)[4]) {
  const uint32_t u = F == F_P4 ? ((hi ? word >> 4 : word) & 0x0F0F0F0Fu) ^ 0x08080808u : word ^ 0x80808080u;
  const float bias = F == F_P4 ? 8388616.f : 8388736.f;  // 2^23 + 8, 2^23 + 128
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) - bias;
}

// eight stored codes (8 bytes) -> eight bf16 values (16 bytes): bf16(code), or bf16(code * s[e]) when SCALED
template <int F, bool SCALED>
__device__ __forceinline__ uint4 decode8(uint2 raw, bool hi, const float (&s)[8]) {
  float f[8];
  codes4<F>(raw.x, hi, reinterpret_cast<float(&)[4]>(f[0]));
  codes4<F>(raw.y, hi, reinterpret_cast<float(&)[4]>(f[4]));
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = SCALED ? pack_bf16(__fmul_rn(f[2 * e], s[2 * e]), __fmul_rn(f[2 * e + 1], s[2 * e + 1]))
                  : pack_bf16(f[2 * e], f[2 * e + 1]);
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Coded operands: the stored bytes of a K tile (A: 128 rows x 64 bytes; W: 64 rows x 128 bytes) by TMA into a
// raw stage, the K tile's scale rows ((K/64, M) and (K/64, N) bf16) by bulk copies beside them; the consumers
// decode them into the swizzled bf16 tiles of one of three rotating buffers.
template <int AF, int WF, bool SCALED>
struct Decoded {
  struct Params {
    CUtensorMap a, w;  // uint8 boxes, unswizzled: A 64 columns x 128 rows, W 128 columns x 64 rows
    const bf16* as;
    const bf16* ws;
    int M, N;
  };
  static constexpr int RAW_A = BM * BK, RAW_W = BK * BN_CODED, SCALES = SCALED ? 2 * (BM + BN_CODED) : 0;
  static constexpr int STAGE = (RAW_A + RAW_W + SCALES + 1023) / 1024 * 1024;
  static constexpr int EXTRA = DEC_BUFFERS * Tiles<BN_CODED>::BYTES;
  static constexpr bool DECODES = true;

  __device__ static void load(const Params& p, unsigned char* st, uint64_t* full, int m0, int n0, int t) {
    const int k0 = t * BK, p0 = k0 / 256 * 128 + k0 % 128;  // the packed column / row of a p4 K tile
    mbar_expect_tx(full, RAW_A + RAW_W + SCALES);
    tma_load_2d(st, &p.a, full, AF == F_P4 ? p0 : k0, m0);
    tma_load_2d(st + RAW_A, &p.w, full, n0, WF == F_P4 ? p0 : k0);
    if (SCALED) {  // scale row t (one group of 64 is one K tile)
      bulk_load(st + RAW_A + RAW_W, p.as + static_cast<size_t>(t) * p.M + m0, 2 * BM, full);
      bulk_load(st + RAW_A + RAW_W + 2 * BM, p.ws + static_cast<size_t>(t) * p.N + n0, 2 * BN_CODED, full);
    }
  }

  // 256 consumer threads, ct: A as 1024 (row, 8 k) chunks, W as 1024 (k row, 8 n) chunks, four of each a
  // thread; a chunk is one 16-byte store into its swizzled place (chunk index XOR row % 8)
  __device__ static const unsigned char* tiles(const Params&, const unsigned char* st, unsigned char* extra, int t,
                                               int ct) {
    unsigned char* dec = extra + (t % DEC_BUFFERS) * Tiles<BN_CODED>::BYTES;
    const bf16* sc = reinterpret_cast<const bf16*>(st + RAW_A + RAW_W);  // [BM] A scales, [BN_CODED] W scales
    const bool hi = (t * BK) % 256 >= 128;
#pragma unroll
    for (int i = 0; i < BM * (BK / 8) / 256; ++i) {
      const int c = ct + 256 * i, r = c >> 3, j = c & 7;
      const uint2 raw = *reinterpret_cast<const uint2*>(st + r * BK + j * 8);
      float s[8];
      const float sr = SCALED ? bf2f(sc[r]) : 1.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = sr;
      *reinterpret_cast<uint4*>(dec + r * 128 + ((j ^ (r & 7)) << 4)) = decode8<AF, SCALED>(raw, hi, s);
    }
#pragma unroll
    for (int i = 0; i < BK * (BN_CODED / 8) / 256; ++i) {
      const int c = ct + 256 * i, r = c / (BN_CODED / 8), n8 = c % (BN_CODED / 8);
      const uint2 raw = *reinterpret_cast<const uint2*>(st + RAW_A + r * BN_CODED + n8 * 8);
      float s[8];
      if (SCALED) {
        const uint4 s8 = *reinterpret_cast<const uint4*>(sc + BM + n8 * 8);
        const bf16* ps = reinterpret_cast<const bf16*>(&s8);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = bf2f(ps[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = 1.f;
      }
      const int q = n8 >> 3, j = n8 & 7;  // W panel, 16-byte chunk of its row
      *reinterpret_cast<uint4*>(dec + A_TILE + q * PANEL + r * 128 + ((j ^ (r & 7)) << 4)) =
          decode8<WF, SCALED>(raw, hi, s);
    }
    fence_proxy_async();  // the stores, visible to wgmma's reads
    return dec;
  }
};

int bf16_form(const void* a, const void* w, bf16* out, int M, int N, int K, cudaStream_t stream) {
  typename TmaBf16<BN_BF16>::Params p;
  if (!matrix_map(&p.a, a, 2, M, K, K, BM, 64, true) || !matrix_map(&p.w, w, 2, K, N, N, BK, 64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  return gemm90::launch<Bf16, BN_BF16, ST, TmaBf16<BN_BF16>>(p, out, M, N, K, stream);
}

template <int AF, int WF, bool SCALED>
int coded_form(const void* a, const void* w, const bf16* as, const bf16* ws, bf16* out, int M, int N, int K,
               cudaStream_t stream) {
  using S = Decoded<AF, WF, SCALED>;
  typename S::Params p;
  const int lda = AF == F_P4 ? K / 2 : K, rows_w = WF == F_P4 ? K / 2 : K;
  if (!matrix_map(&p.a, a, 1, M, lda, lda, BM, BK, false) ||
      !matrix_map(&p.w, w, 1, rows_w, N, N, BK, BN_CODED, false))
    return static_cast<int>(cudaErrorInvalidValue);
  p.as = as;
  p.ws = ws;
  p.M = M;
  p.N = N;
  return gemm90::launch<Bf16, BN_CODED, ST, S>(p, out, M, N, K, stream);
}

}  // namespace

// a (M, K) bf16 | (M, K) int8 codes | (M, K/2) packed int4; w (K, N) bf16 |
// (K, N) int8 | (K/2, N) packed int4, N-contiguous; forms 0 bf16, 1 int8, 2
// packed int4; scaled: as (K/64, M), ws (K/64, N) bf16, else null -> out (M,
// N) bf16. Built forms (a, w, scaled): (0,0,0) (1,1,0) (2,2,0) (1,1,1) (2,1,1)
// (2,2,1). M, N multiples of 128, K of 64 (of 256 with a packed operand);
// every pointer 16-byte aligned.
extern "C" int nt_gemm_probe_bf16(const void* a, const void* w, const void* as, const void* ws, void* out, int M,
                                  int N, int K, int a_form, int w_form, int scaled, void* stream) {
  const auto* pas = static_cast<const bf16*>(as);
  const auto* pws = static_cast<const bf16*>(ws);
  auto* po = static_cast<bf16*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int key = a_form * 100 + w_form * 10 + (scaled ? 1 : 0);
  switch (key) {
    case 0: return bf16_form(a, w, po, M, N, K, s);
    case 110: return coded_form<F_I8, F_I8, false>(a, w, pas, pws, po, M, N, K, s);
    case 220: return coded_form<F_P4, F_P4, false>(a, w, pas, pws, po, M, N, K, s);
    case 111: return coded_form<F_I8, F_I8, true>(a, w, pas, pws, po, M, N, K, s);
    case 211: return coded_form<F_P4, F_I8, true>(a, w, pas, pws, po, M, N, K, s);
    case 221: return coded_form<F_P4, F_P4, true>(a, w, pas, pws, po, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
