// w4a8 weight dequant: packed 4-bit codes (K/2, N) -> per-channel int8,
// written K-contiguous as an (N, K) array (the caller views it as (K, N)).
//
// Replaces nunchaku_tpu/ops/gemm.py _dequant_w4a8_kernel (:1074, launched by
// dequant_w4a8_pallas :1104) in both of its code forms, non-stacked and in
// its stacked (layer-index) mode (stacked_w, :1077-1080, reached through
// _w4a8_dequant :1962-1973 by the scans' attach_stacked_weights): there the
// codes are layer idx of an (L, K/2, N) stack, idx a device-resident int32
// that each block reads once (clamped to [0, L)) as a TMA coordinate, the
// rest the same code. Packed row 128 b + j holds logical rows 256 b + j (low
// nibble) and 256 b + 128 + j (high nibble); each nibble is sign-extended
// and, in the e2m1 form (nvfp4-a8: an nvfp4 checkpoint served through the
// int8 products), decoded to its fp4 value {0, +-.5, +-1, +-1.5, +-2, +-3,
// +-4, +-6} (the stray code -8 to -8, as the JAX package's _decode_e2m1
// does), then multiplied in f32 by the bf16 rescale of its group (64 rows
// for int4 codes, 16 for e2m1), rounded half-to-even and clipped to +-127.
// The output is transposed relative to the JAX kernel's (K, N) buffer
// because int8 tensor-core products take both operands K-contiguous (the
// "TN" layout): the port's GEMM kernels and cuBLAS behind torch._int_mm read
// it without another pass.
//
// Bound on the H100: bytes. Each weight moves 1.5 bytes (0.5 in, 1 out) plus
// 2/64 bytes of rescale (2/16 for e2m1): 17.3 us at FLUX fc1 (K 3072, N
// 12288) at 3.35 TB/s. What the card could lose besides: a type conversion
// a weight (I2F / F2I retire at 16 a clock an SM, 37.7 M weights a
// conversion cost ~10 us at fc1), byte-wide or bank-conflicted shared
// accesses, and a block that loads, then decodes, then stores in turn.
//
// Design. A unit is one pack block (128 packed rows = 256 k) of 128 columns.
// One persistent block an SM walks its units (grid-strided);
// its first thread reads the stack's layer once, keeps up to four units'
// codes and rescales in flight by TMA (a 4-stage ring of raw boxes: the
// 128 x 128 codes and the unit's 4 (int4) or 16 (e2m1) rescale rows) and
// sends each decoded unit out by two TMA stores (box 128 k x 128 n, 128-byte
// swizzled), keeping two units' outputs in flight. Warp w decodes quarter w
// of a unit (plane w / 2: the low or high nibbles, packed rows 64 (w % 2) ..
// + 63; in the e2m1 form two warps share a quarter) with no type
// conversion: per column and rescale group a 16-entry int8 table of the
// values a code takes (16 products rounded by the 1.5 * 2^23 addition,
// symmetric under sign), looked up by byte permutes; four
// packed rows of four columns (four 32-bit loads) turn into four words of
// four k each, transposed in the permutes, stored 16 bytes a lane into the
// swizzled tile (eight lanes, eight 16-byte chunks: no bank conflict). The
// int4 form is gemm_sm90.cuh's w4_decode_quarter, the decoder of the packed
// GEMMs (their card tests hold them to this kernel's codes); the e2m1 form
// builds its tables from the e2m1 magnitudes, one per 16-row group, four
// times the int4 form's, so eight warps share its units (device 0.025
// against 0.037 ms with four at FLUX fc1, H100 80GB HBM3 at 700 W; two
// blocks of four an SM with a shorter ring were no faster). Global traffic is TMA only: whole 128-byte
// lines on both sides.
#include "gemm_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BN = 128;              // columns of a unit (output rows)
constexpr int CODES = 128 * BN;      // a unit's packed rows: one pack block
constexpr int TILE = BN * 128;       // one output tile: BN rows of 128 k bytes, 128-byte swizzled
constexpr int E2M1_WARPS = 8;        // decoding warps of the e2m1 form (the int4 form has four)
constexpr int ST = 4;                // raw boxes in the ring
constexpr int OUT = 2;               // units whose output tiles are in flight
static_assert(gemm90::W4Src::BN == BN && gemm90::W4Src::CODES == CODES, "the packed GEMMs' box");

template <bool E2M1>
struct Form {
  static constexpr int G = E2M1 ? 16 : 64;             // rows of a rescale group
  static constexpr int RS_ROWS = 256 / G;              // rescale rows of a unit
  static constexpr int RAW = CODES + RS_ROWS * BN * 2;  // a raw box: codes, then rescale rows (bf16)
  static constexpr int SMEM = OUT * 2 * TILE + ST * RAW + 8 * ST + 1024;
  static constexpr int WARPS = E2M1 ? E2M1_WARPS : 4;  // a quarter of a unit a warp, or a part of one
  static constexpr int THREADS = 32 * WARPS;
  static_assert(RAW % 1024 == 0, "raw boxes 1024-byte aligned");
};

// The 16 int8 values of the e2m1 codes under rescale r, in w4_table's layout: t[0..1] codes 0 .. 7, t[2..3]
// codes -8 .. -1. The magnitudes of codes 1 .. 8 are 0.5, 1, 1.5, 2, 3, 4, 6 and 8 (only -8 occurs); a product
// of one with a bf16 rescale is exact in f32, rounded half to even by the 1.5 * 2^23 addition, clipped first.
__device__ __forceinline__ void e2m1_table(float r, uint32_t (&t)[4]) {
  constexpr float MAGIC = 12582912.f;
  constexpr float MAG[8] = {0.5f, 1.f, 1.5f, 2.f, 3.f, 4.f, 6.f, 8.f};
  const float a = fabsf(r), sg = r < 0.f ? -1.f : 1.f;
  uint32_t pos[8], neg[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float x = fminf(__fmul_rn(MAG[c], a), 127.f);
    pos[c] = __float_as_uint(__fmaf_rn(sg, x, MAGIC));
    neg[c] = __float_as_uint(__fmaf_rn(-sg, x, MAGIC));
  }
  t[0] = gemm90::w4_bytes(0u, pos[0], pos[1], pos[2]);
  t[1] = gemm90::w4_bytes(pos[3], pos[4], pos[5], pos[6]);
  t[2] = gemm90::w4_bytes(neg[7], neg[6], neg[5], neg[4]);
  t[3] = gemm90::w4_bytes(neg[3], neg[2], neg[1], neg[0]);
}

// gemm90::w4_decode_quarter's walk with e2m1 tables: steps s0 .. s0 + STEPS - 1 of quarter w of a raw box
// (PLANE = w / 2, packed rows 64 (w % 2) .. + 63) into k bytes [64 slot, 64 slot + 64) of an output tile; step
// s's 16 rows (16 c .. 16 c + 15 of the quarter, c = (s + lane / 2) % 4) are one rescale group, row 4 w + c of
// the box's 16. Two warps of STEPS 2 (s0 0 and 2) share a quarter: for each lane they take its four c between them.
template <int PLANE, int STEPS>
__device__ __forceinline__ void e2m1_decode_quarter(const unsigned char* raw, int w, unsigned char* wt, int slot,
                                                    int lane, int s0) {
  const unsigned char* rows = raw + (64 * (w & 1)) * BN + 4 * lane;
  uint32_t wd[16 * STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int c = (s0 + s + (lane >> 1)) & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i) wd[16 * s + i] = *reinterpret_cast<const uint32_t*>(rows + (16 * c + i) * BN);
  }
  uint2 rsv[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int c = (s0 + s + (lane >> 1)) & 3;
    rsv[s] = *reinterpret_cast<const uint2*>(raw + CODES + (4 * w + c) * (BN * 2) + 8 * lane);
  }
  const uint32_t M44 = 0x44444444u, LO = 0x10101010u, HI = 0x32323232u, M0F = 0x0F0F0F0Fu, M77 = 0x77777777u;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int c = (s0 + s + (lane >> 1)) & 3;
    uint32_t t[4][4];
    e2m1_table(__uint_as_float(rsv[s].x << 16), t[0]);
    e2m1_table(__uint_as_float(rsv[s].x & 0xFFFF0000u), t[1]);
    e2m1_table(__uint_as_float(rsv[s].y << 16), t[2]);
    e2m1_table(__uint_as_float(rsv[s].y & 0xFFFF0000u), t[3]);
    uint32_t o[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w0 = wd[16 * s + 4 * q], w1 = wd[16 * s + 4 * q + 1];
      const uint32_t w2 = wd[16 * s + 4 * q + 2], w3 = wd[16 * s + 4 * q + 3];
      const uint32_t A = PLANE ? gemm90::w4_select(w0 >> 4, w1, M0F) : gemm90::w4_select(w0, w1 << 4, M0F);
      const uint32_t B = PLANE ? gemm90::w4_select(w2 >> 4, w3, M0F) : gemm90::w4_select(w2, w3 << 4, M0F);
      const uint32_t magA = gemm90::w4_and(A, M77), magB = gemm90::w4_and(B, M77);
      const uint32_t hA = gemm90::and_or(A >> 1, M44, LO), hB = gemm90::and_or(B >> 1, M44, HI);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = static_cast<uint32_t>(j | ((j + 4) << 4));
        const uint32_t mag = __byte_perm(magA, magB, sel);
        const uint32_t lo = __byte_perm(t[j][0], t[j][1], mag), hi = __byte_perm(t[j][2], t[j][3], mag);
        o[j][q] = __byte_perm(lo, hi, __byte_perm(hA, hB, sel));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * lane + j;
      *reinterpret_cast<uint4*>(wt + n * 128 + (((4 * slot + c) ^ (n & 7)) << 4)) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    }
  }
}

// Kernel parameters: the tensor maps of the codes (N, K/2, L) uint8, the rescales (N, K/G) bf16 and the output
// (K, N)^T = (N, K) uint8 (128-byte swizzle), the layer index (null: not a stack), and the unit walk: nb pack
// blocks a column tile; block b takes units b, b + grid, ..., per of them and one more if b < rem; unit u is
// pack block u % nb of column tile u / nb, the quotient by the multiplier div = ceil(2^32 / nb) (exact for u,
// nb < 2^16). So the card divides no integer (a division is a conversion to float and back).
struct Params {
  CUtensorMap codes, rs, out;
  const int* layer_idx;
  int L, nb, per, rem;
  unsigned long long div;
};

template <bool E2M1>
__global__ void __launch_bounds__(Form<E2M1>::THREADS, 1) dequant_w4a8_kernel(const __grid_constant__ Params p) {
  using F = Form<E2M1>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = sm + OUT * 2 * TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * F::RAW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = static_cast<int>(gridDim.x);
  int layer = 0;
  auto unit = [&](int i, int& k0, int& n0) {  // this block's i-th unit: its first k and column
    const unsigned u = blockIdx.x + static_cast<unsigned>(i * stride);
    const unsigned nt = static_cast<unsigned>((u * p.div) >> 32);
    k0 = 256 * static_cast<int>(u - nt * p.nb);
    n0 = BN * static_cast<int>(nt);
  };
  auto load = [&](int i) {  // unit i's codes and rescales into stage i % ST
    int k0, n0;
    unit(i, k0, n0);
    unsigned char* raw = ring + (i % ST) * F::RAW;
    mbar_expect_tx(full + i % ST, F::RAW);
    tma_load_3d(raw, &p.codes, full + i % ST, n0, k0 / 2, layer);
    tma_load_2d(raw + CODES, &p.rs, full + i % ST, n0, k0 / F::G);
  };
  auto store = [&](int i) {  // unit i's two tiles, from output buffer i % OUT
    int k0, n0;
    unit(i, k0, n0);
    const unsigned char* tiles = sm + (i % OUT) * 2 * TILE;
    tma_store_2d(&p.out, tiles, k0, n0);
    tma_store_2d(&p.out, tiles + TILE, k0 + 128, n0);
    bulk_commit();
  };
  const int count = p.per + (static_cast<int>(blockIdx.x) < p.rem);  // this block's units

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
    if (p.layer_idx != nullptr) {
      layer = __ldg(p.layer_idx);
      layer = layer < 0 ? 0 : (layer >= p.L ? p.L - 1 : layer);
    }
    for (int i = 0; i < ST && i < count; ++i) load(i);
  }
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    if (i > 0) {
      fence_proxy_async();  // unit i - 1's tiles, visible to the TMA store
      __syncthreads();      // every quarter of unit i - 1 is decoded: its stage and tiles are done with
      if (threadIdx.x == 0) {
        store(i - 1);
        bulk_wait<1, true>();  // unit i - 2's stores have read output buffer i % OUT
        if (i + ST - 1 < count) load(i + ST - 1);  // into unit i - 1's stage
      }
      __syncthreads();
    }
    mbar_wait(full + i % ST, (i / ST) & 1);
    const unsigned char* raw = ring + (i % ST) * F::RAW;
    const int quarter = warp & 3;
    unsigned char* tile = sm + (i % OUT) * 2 * TILE + (quarter >> 1) * TILE;
    if constexpr (E2M1) {
      constexpr int STEPS = 16 / F::WARPS;
      if (quarter < 2)
        e2m1_decode_quarter<0, STEPS>(raw, quarter, tile, quarter & 1, lane, (warp >> 2) * STEPS);
      else
        e2m1_decode_quarter<1, STEPS>(raw, quarter, tile, quarter & 1, lane, (warp >> 2) * STEPS);
    } else {
      if (warp < 2)
        gemm90::w4_decode_quarter<0>(raw, warp, tile, warp & 1, lane);
      else
        gemm90::w4_decode_quarter<1>(raw, warp, tile, warp & 1, lane);
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0 && count > 0) {
    store(count - 1);
    bulk_wait<0, false>();  // every store is done before the block's shared memory goes
  }
}

template <bool E2M1>
int launch(const void* qweight, const void* rescales, void* out, int K, int N, const int* layer_idx, int L,
           cudaStream_t stream) {
  using F = Form<E2M1>;
  Params p;
  const cuuint64_t n = static_cast<cuuint64_t>(N), k = static_cast<cuuint64_t>(K);
  p.layer_idx = layer_idx;
  p.L = layer_idx != nullptr ? L : 1;
  p.nb = K / 256;
  const int units = p.nb * ((N + BN - 1) / BN), grid = units < sm_count() ? units : sm_count();
  p.per = units / grid;
  p.rem = units % grid;
  p.div = ((1ull << 32) + p.nb - 1) / p.nb;
  const cuuint64_t c_dims[3] = {n, k / 2, static_cast<cuuint64_t>(p.L)}, c_str[2] = {n, k / 2 * n};
  const cuuint32_t c_box[3] = {BN, 128, 1};
  const cuuint64_t r_dims[2] = {n, k / F::G}, r_str[1] = {2 * n};
  const cuuint32_t r_box[2] = {BN, F::RS_ROWS};
  const cuuint64_t o_dims[2] = {k, n}, o_str[1] = {k};
  const cuuint32_t o_box[2] = {128, BN};
  if (units >= (1 << 16) ||
      !tensor_map(&p.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qweight, c_dims, c_str, c_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&p.rs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rescales, r_dims, r_str, r_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&p.out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, out, o_dims, o_str, o_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(dequant_w4a8_kernel<E2M1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dequant_w4a8_kernel<E2M1><<<grid, F::THREADS, F::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qweight (K/2, N) int8, rescales (K/G, N) bf16 -> out (N, K) int8 holding
// the (K, N) weight K-contiguous. e2m1 == 0: int4 codes, G = 64; e2m1 == 1:
// e2m1 codes, G = 16. layer_idx: null, or a device int32 naming the layer
// of a stack of L (K/2, N) code arrays that starts at qweight. Needs
// K % 256 == 0, N % 64 == 0 (checked by the Python wrapper).
extern "C" int nt_dequant_w4a8(const void* qweight, const void* rescales, void* out, int K, int N, int e2m1,
                               const void* layer_idx, int L, void* stream) {
  if (K <= 0 || N <= 0 || K % 256 != 0 || N % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* idx = static_cast<const int*>(layer_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return e2m1 ? launch<true>(qweight, rescales, out, K, N, idx, L, s)
              : launch<false>(qweight, rescales, out, K, N, idx, L, s);
}
