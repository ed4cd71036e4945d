// w4a8 weight dequant: packed 4-bit codes (K/2, N) -> per-channel int8,
// written K-contiguous as an (N, K) array (the caller views it as (K, N)).
//
// Replaces nunchaku_tpu/ops/gemm.py _dequant_w4a8_kernel (:1074, launched by
// dequant_w4a8_pallas :1104) in both of its code forms, non-stacked and in
// its stacked (layer-index) mode (stacked_w, :1077-1080, reached through
// _w4a8_dequant :1962-1973 by the scans' attach_stacked_weights): there the
// codes are layer idx of an (L, K/2, N) stack, idx a device-resident int32
// read once at entry (common.cuh stacked_layer), the rest the same code.
// Packed row 128*b + j holds logical rows 256*b + j (low nibble) and 256*b + 128 + j (high
// nibble); each nibble is sign-extended and, in the e2m1 form (nvfp4-a8:
// an nvfp4 checkpoint served through the int8 products), decoded to its fp4
// value {0, +-.5, +-1, +-1.5, +-2, +-3, +-4, +-6} (the stray code -8 to -8,
// as the JAX package's _decode_e2m1 does), then multiplied in f32 by the
// bf16 rescale of its group (64 rows for int4 codes, 16 for e2m1), rounded
// half-to-even and clipped to +-127 -- the same codes, bit for bit. The
// decode is arithmetic on registers (exact powers of two), no table; it
// lives in w4_decode.cuh, shared with the GEMMs that decode inline. The output is transposed relative to the JAX kernel's (K, N) buffer
// because int8 tensor-core products take both operands K-contiguous (the
// "TN" layout): the port's GEMM kernels and cuBLAS behind torch._int_mm read
// it without another pass.
//
// Bound on the H100: bytes. Each weight moves 1.5 bytes (0.5 in, 1 out) plus
// 2/64 bytes of rescale (2/16 for e2m1), and does one multiply (after a few
// integer ops of decode in the e2m1 form) -- far below the ops/byte
// ridge. Design: a block turns one pack block (128 packed rows = 256 logical
// rows) by 64 columns into a 64 x 256 K-contiguous tile through shared
// memory. Reads are 16-byte vectors along N (64 contiguous bytes per packed
// row), writes are 16-byte vectors along K (256 contiguous bytes per output
// row), so both sides stay coalesced.
#include "w4_decode.cuh"

namespace {

constexpr int TN = 64;    // output rows (columns n of the weight) per block
constexpr int TK = 256;   // logical k per block: one pack block
constexpr int THREADS = 256;

// G: rows per rescale group (64 for int4 codes, 16 for e2m1)
template <bool E2M1, int G>
__global__ void __launch_bounds__(THREADS)
    dequant_w4a8_kernel(const int8_t* __restrict__ qw, const bf16* __restrict__ rs,
                        int8_t* __restrict__ out, int K, int N, const int* __restrict__ lidx, int L) {
  __shared__ __align__(16) int8_t tile[TN][TK + 16];
  const int n0 = blockIdx.x * TN, b = blockIdx.y;
  const int j = threadIdx.x >> 1;    // packed row within the pack block
  const int c0 = (threadIdx.x & 1) * 32;  // which 32 of the tile's 64 columns
  const int p = b * (TK / 2) + j;
  const int row_lo = b * TK + j, row_hi = row_lo + TK / 2;
  qw = stacked_layer(qw, lidx, L, static_cast<size_t>(K / 2) * N);

  uint4 packed[2];
  bf16 rlo[32], rhi[32];
  const uint4* src = reinterpret_cast<const uint4*>(qw + static_cast<size_t>(p) * N + n0 + c0);
  const uint4* slo = reinterpret_cast<const uint4*>(rs + static_cast<size_t>(row_lo / G) * N + n0 + c0);
  const uint4* shi = reinterpret_cast<const uint4*>(rs + static_cast<size_t>(row_hi / G) * N + n0 + c0);
  packed[0] = src[0];
  packed[1] = src[1];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    reinterpret_cast<uint4*>(rlo)[v] = slo[v];
    reinterpret_cast<uint4*>(rhi)[v] = shi[v];
  }
  const int8_t* pb = reinterpret_cast<const int8_t*>(packed);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    tile[c0 + i][j] = rescale_code<E2M1>(nibble(pb[i], false), bf2f(rlo[i]));
    tile[c0 + i][TK / 2 + j] = rescale_code<E2M1>(nibble(pb[i], true), bf2f(rhi[i]));
  }
  __syncthreads();
  const int r = threadIdx.x >> 2, seg = (threadIdx.x & 3) * (TK / 4);
  const uint4* from = reinterpret_cast<const uint4*>(&tile[r][seg]);
  uint4* to = reinterpret_cast<uint4*>(out + static_cast<size_t>(n0 + r) * K + b * TK + seg);
#pragma unroll
  for (int v = 0; v < TK / 4 / 16; ++v) to[v] = from[v];
}

}  // namespace

// qweight (K/2, N) int8, rescales (K/G, N) bf16 -> out (N, K) int8 holding
// the (K, N) weight K-contiguous. e2m1 == 0: int4 codes, G = 64; e2m1 == 1:
// e2m1 codes, G = 16. layer_idx: null, or a device int32 naming the layer
// of a stack of L (K/2, N) code arrays that starts at qweight. Needs
// K % 256 == 0, N % 64 == 0 (checked by the Python wrapper).
extern "C" int nt_dequant_w4a8(const void* qweight, const void* rescales, void* out, int K, int N, int e2m1,
                               const void* layer_idx, int L, void* stream) {
  dim3 grid(N / TN, K / TK);
  auto kernel = e2m1 ? dequant_w4a8_kernel<true, 16> : dequant_w4a8_kernel<false, 64>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qweight), static_cast<const bf16*>(rescales),
      static_cast<int8_t*>(out), K, N, static_cast<const int*>(layer_idx), L);
  return static_cast<int>(cudaGetLastError());
}
