// fc1 GEMM with the GELU -> requantize epilogue (the fused MLP chain's
// producer), on an int8 weight or, in its W4 form, on packed int4 weights;
// each form non-stacked or stacked, each with grouped or per-token scales.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w8a8_gelu_quant_kernel (:460,
// launched by svdq_gemm_w8a8_gelu_quant :1264) and, in the W4 form (the
// W4Src source of gemm_sm90.cuh), _gemm_w4a8_gelu_quant_kernel (:721,
// launched by _gelu_quant_w4a8 :1471 under NUNCHAKU_TPU_W4A8_FUSED=1): the
// packed (K/2, N) codes and their (K/64, N) rescales are decoded to int8 in
// shared memory per k tile, the same values the dequant kernel writes, so
// both forms give the same outputs bit for bit on the same logical weight.
// The JAX kernel decodes a (K/2, bn) stripe once into VMEM and reuses it for
// every M tile; an SM's 228 KB holds no such stripe (fc1's is 4.7 MB), so
// here each block decodes its own tiles again (M / 128 times per weight).
//   out = i32(qact @ w) * ascale[m] * wscale[n] + bf16(lora_act) @ proj_up + bias
//   g = tanh-GELU(out);  lora_next = bf16(g) @ proj_down_next
//   h = (g [+ 0.171875]) * rsmooth_next;  one int8 scale per (token, bn-column
//   tile): scale = max|h| * f32(1/127), q = clip(round_half_even(h * rcp(scale)), +-127)
//
// Stacked modes (stacked_w, :478, :497 and :750): the weight is layer idx of
// an (L, K, N) int8 or (L, K/2, N) packed stack, idx a device-resident int32
// that the copying thread of kernel A reads on the card, clamped to [0, L),
// as a TMA coordinate (one tensor map over the whole stack); the rest is the
// non-stacked code, so a stacked launch is bit-identical to the non-stacked
// one on that layer.
//
// Per-token mode: replaces _gemm_w8a8_gelu_quant_ptoken_kernel (:534, its
// epilogue _gelu_quant_ptoken :607, under NUNCHAKU_TPU_CHAIN_PTOKEN=1): one
// scale per token over all N columns, qscales (1, M), which the rank-1 mode
// of the consumer (gemm_w8a8_grouped.cu at G = 1) takes. The TPU kernel
// keeps a (bm, N) f32 row stripe in VMEM and quantizes it at the last N tile
// (512 x 12288 x 4 B = 25 MB at FLUX fc1); a Hopper block has 227 KB of
// shared memory, less than 16 such rows. So the per-token mode is these two
// kernels with one scale group of bn = N: kernel A's f32 g and its per-tile
// row maxima and low-rank partials go through HBM as in the grouped mode,
// and kernel B takes the max over every tile of the row, quantizes with
// rcp(max / 127) and sums the partials in ascending tile order (JAX: the
// partials of each bn = 1536 tile summed in order, lp_acc_ref +=, :583). The
// workspace costs about 2 x M x N x 4 B of traffic: 0.45 GB at FLUX fc1 (M
// 4608, N 12288), ~0.14 ms at 3.35 TB/s. A cluster / DSMEM row exchange that
// keeps g on chip is later work.
//
// Bound on the H100: operations. At FLUX.1-dev shapes (M up to 4608, K 3072,
// N 12288) the int8 product is 2*M*N*K operations on 2*M*K + K*N input bytes
// -- far above the int8 ridge of ~590 ops/byte (the W4 form reads K*N/2
// weight bytes, and its decode, a few CUDA-core instructions per weight per
// M tile, is work beside the products). Design: two kernels.
// Kernel A is the tensor-core int8 GEMM on the wgmma + TMA main loop of
// gemm_sm90.cuh at its s8 instantiation (block tile 128 x 128, K tiles of 128
// bytes, wgmma m64n128k32 s8 into s32 accumulators; a K that 128 does not
// divide ends on a tile TMA fills with zeros past K). The int8 form reads W
// by TMA (TmaS8, a 4-stage ring); the W4 form runs the warpgroup-0 decoding
// form (gemm_w4_kernel, W4Src): warpgroup 0 decodes each 256-k pack block of
// the packed weight into two int8 tiles, up to three ahead of the products.
// One epilogue (GeluEpi) serves both: the scales, the rank-r up-projection,
// the bias and the GELU in the WMMA kernels' operations and order; g written
// as f32; max|h| over each row of the 128-column tile; and the bf16(g) tile
// times the matching 128 rows of proj_down_next on the tensor cores (WMMA
// bf16, 16 rows a warp), one rank-r partial per (128-column tile, row). So
// both forms give the same outputs bit for bit. The accumulators go through
// shared memory to a thread per 4 x 16 block, whose rank-r sums run over the
// ranks once for its 64 values (int8_gemm.cuh lora_sums_4x16): a thread per
// 8 columns left the epilogue bound by shared-memory loads. The pipelined
// producer (gemm_w8a8_gelu_quant_pipe.cu) runs these epilogue operations in
// this order on its own warps, beside the next tile's products.
// Kernel B streams g once more: per row it takes the
// max over the tiles of each bn-wide group, quantizes, and sums the low-rank
// partials in tile order. The scale needs a max over bn = 1536 columns, more
// than one GEMM tile holds, hence the f32 round trip of g; keeping g on chip
// is left to a later version.
//
// Rank. The low-rank widths R (this layer) and R2 (the next) take any width.
// The epilogue's shared memory is laid out at run time for one chunk of each:
// the low-rank tiles of up to 128 ranks of R, the g tile, the proj_down tile
// of up to 128 of R2's columns rounded up to 16 (132 KiB at rank 32, 202 KiB
// at rank 128 and above). A wider rank runs its chunks one after another
// through the same tiles: R's sums continue over the ranks in order, R2's
// partial columns are each their own sum, so a rank up to 128 gives the
// outputs it gave before. The low-rank partial runs over R2 in 32-column
// slices of two WMMA accumulators, so registers do not grow with the rank;
// the partial buffer is sized by R2 (tiles x M x R2p), and kernel B sums the
// tiles in tile order, as the JAX producer does.
#include "gelu_requant.cuh"
#include "gemm_sm90.cuh"
#include "int8_gemm.cuh"

namespace {

using namespace i8gemm;

constexpr int LDG = BN + 8;     // bf16 row stride of the g tile (272 bytes)

__host__ __device__ constexpr int round16(int r) { return (r + 15) / 16 * 16; }

// Kernel A on the s8 main loop of gemm_sm90.cuh: the int8 form (TmaS8) and the W4 form (W4Src).
namespace s8 {

constexpr int BM = gemm90::BM, BN = 128, ST = 4;
constexpr int LDA = BN + 8;  // int row stride of the staged accumulator tile (conflict-free 8-byte stores)
using Src = gemm90::TmaS8<BN>;

struct GeluEpi {
  struct Params {
    const float* as;
    const float* ws;
    const float* la;
    const bf16* pu;
    const bf16* bias;
    const float* rsm;
    const bf16* pd;
    float* g;
    float* amax_part;
    float* lora_part;
    int R, R2;
    float shift;
  };
  static constexpr bool FOLDS = false;
  template <int N>
  struct State {};
  // [0, acc) the staged accumulators [BM][LDA] int; the low-rank tiles of one chunk of R
  // (lora_rows_bytes); the g tile [BM][LDG] bf16; the proj_down tile of one chunk of R2p columns [BN][PC + 8]
  // bf16 (PC = min(R2p, 128))
  __host__ __device__ static size_t acc_bytes() { return i8gemm::align128(static_cast<size_t>(BM) * LDA * 4); }
  __host__ __device__ static size_t g_bytes() { return i8gemm::align128(static_cast<size_t>(BM) * LDG * 2); }
  __host__ __device__ static int pd_cols(int R2) { return i8gemm::lora_chunk(round16(R2)); }
  __host__ __device__ static int smem(const Params& e) {
    return static_cast<int>(acc_bytes() + i8gemm::lora_rows_bytes(i8gemm::lora_chunk(e.R)) + g_bytes() +
                            i8gemm::align128(static_cast<size_t>(BN) * (pd_cols(e.R2) + 8) * 2));
  }
  // columns [p0, p0 + pc) of proj_down_next rows n0.. (zeros past R2) into the tile: 16-byte copies when a row's
  // R2 bf16 are 16-byte aligned
  __device__ static void stage_pd(const Params& e, bf16* pdt, int LDP, int p0, int pc, int n0, int ct) {
    const int R2 = e.R2;
    if (R2 % 8 == 0) {
      for (int i = ct; i < BN * (pc / 8); i += 2 * sm90::WG) {
        const int c = i / (pc / 8), q = i % (pc / 8);
        cp_async16(pdt + c * LDP + 8 * q, e.pd + static_cast<size_t>(n0 + c) * R2 + p0 + 8 * q, p0 + 8 * q < R2);
      }
    } else {
      for (int i = ct; i < BN * pc; i += 2 * sm90::WG) {
        const int c = i / pc, r = i % pc;
        pdt[c * LDP + r] = p0 + r < R2 ? e.pd[static_cast<size_t>(n0 + c) * R2 + p0 + r] : __float2bfloat16(0.f);
      }
    }
  }
  __device__ static void begin_group(const Params&, State<BN>&, int, int, int) {}
  __device__ static void finish(const Params& e, State<BN>&, const int (&acc)[BN / 2], unsigned char* sm, int m0,
                                int n0, int row0, int ct, int M, int N) {
    const int R = e.R, R2 = e.R2, R2p = round16(R2), PC = pd_cols(R2), LDP = PC + 8, RC = i8gemm::lora_chunk(R);
    int* at = reinterpret_cast<int*>(sm);
    unsigned char* lbase = sm + acc_bytes();
    const i8gemm::LoraRows lora = i8gemm::lora_rows(lbase, RC);
    bf16* gt = reinterpret_cast<bf16*>(lbase + i8gemm::lora_rows_bytes(RC));  // [BM][LDG]: bf16(g)
    bf16* pdt = reinterpret_cast<bf16*>(lbase + i8gemm::lora_rows_bytes(RC) + g_bytes());  // [BN][LDP]
    auto sync = [] { sm90::named_sync(gemm90::EPI_BAR); };
    {  // the accumulators into the tile: rows row0 and row0 + 8, columns 8j + 2 t4 (+1)
      const int r = row0 - m0, c = 2 * (ct & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<int2*>(at + r * LDA + 8 * j + c) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(at + (r + 8) * LDA + 8 * j + c) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    // proj_down_next rows n0.., its first PC columns, zero-padded to R2p
    stage_pd(e, pdt, LDP, 0, PC, n0, ct);
    // bf16(lora_act[m0:, :RC]) and proj_up[:RC, n0:]
    if (R > 0) i8gemm::stage_lora_rows(lora, e.la, R, e.pu, m0, n0, N, M, ct, 2 * sm90::WG);
    cp_async_commit();
    cp_async_wait<0>();
    sync();
    const int tile = n0 / BN;
    // a thread per 4 x 16 block: rows r0 .. r0 + 3, the 8 columns c0 + 64h of each half h of the tile; a
    // warp's eight c0 span each half
    const int r0 = (ct >> 5) * 16 + ((ct >> 3) & 3) * 4, c0 = (ct & 7) * 8;
    float s[64];  // the rank-R sums, s[8 (2q + h) + k]
    if (R > 0) i8gemm::lora_sums_all(lora, e.la, e.pu, R, m0, n0, N, M, ct, 2 * sm90::WG, s, r0, c0, lbase, sync);
    float a[4], hm[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = __ldg(e.as + m0 + r0 + q);
      hm[q] = 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nl = c0 + 64 * h, n = n0 + nl;
      float w[8], rs[8], b[8];
      ldg8f(w, e.ws + n);
      ldg8f(rs, e.rsm + n);
      if (e.bias != nullptr) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(e.bias + n));
#pragma unroll
        for (int k = 0; k < 8; ++k) b[k] = bf2f(reinterpret_cast<const bf16*>(&raw)[k]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ml = r0 + q, m = m0 + ml;
        const int4 v0 = *reinterpret_cast<const int4*>(at + ml * LDA + nl);
        const int4 v1 = *reinterpret_cast<const int4*>(at + ml * LDA + nl + 4);
        const int v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        float out[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) out[k] = __fmul_rn(__fmul_rn(static_cast<float>(v[k]), a[q]), w[k]);
        if (R > 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) out[k] = __fadd_rn(out[k], s[8 * (2 * q + h) + k]);
        }
        if (e.bias != nullptr) {
#pragma unroll
          for (int k = 0; k < 8; ++k) out[k] = __fadd_rn(out[k], b[k]);
        }
        float gv[8];
        uint4 gb;
        bf16* gbp = reinterpret_cast<bf16*>(&gb);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          gv[k] = tanh_gelu(out[k]);
          hm[q] = fmaxf(hm[q], fabsf(__fmul_rn(__fadd_rn(gv[k], e.shift), rs[k])));
          gbp[k] = __float2bfloat16(gv[k]);
        }
        float4* dst = reinterpret_cast<float4*>(e.g + static_cast<size_t>(m) * N + n);
        dst[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
        dst[1] = make_float4(gv[4], gv[5], gv[6], gv[7]);
        *reinterpret_cast<uint4*>(&gt[ml * LDG + nl]) = gb;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // max|h| over the row's 128 columns: the eight column blocks of its lanes
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) hm[q] = fmaxf(hm[q], __shfl_xor_sync(0xffffffffu, hm[q], d));
      if ((ct & 7) == 0) e.amax_part[static_cast<size_t>(tile) * M + m0 + r0 + q] = hm[q];
    }
    sm90::named_sync(gemm90::EPI_BAR);  // the g tile is complete

    // low-rank partial of this tile: bf16(g)[16 rows of this warp, 128] @ pd[128, R2p], 32 columns (two
    // accumulators) at a time, the proj_down tile's PC columns at a time (each partial column its own sum)
    namespace wmma = nvcuda::wmma;
    const int warp = ct / 32;
    float* dst = e.lora_part + (static_cast<size_t>(tile) * M + m0 + warp * 16) * R2p;
    for (int p0 = 0, j0 = 0; j0 < R2p; j0 += 32) {
      if (j0 == p0 + PC) {  // the next columns of proj_down through the same tile
        p0 = j0;
        sync();  // every warp has read the previous columns
        stage_pd(e, pdt, LDP, p0, i8gemm::lora_chunk(R2p - p0), n0, ct);
        cp_async_commit();
        cp_async_wait<0>();
        sync();
      }
      const int nf = R2p - j0 >= 32 ? 2 : 1;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> lp[2];
      wmma::fill_fragment(lp[0], 0.f);
      wmma::fill_fragment(lp[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
        wmma::load_matrix_sync(ga, &gt[(warp * 16) * LDG + kk * 16], LDG);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j < nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> pb;
            wmma::load_matrix_sync(pb, &pdt[(kk * 16) * LDP + j0 - p0 + j * 16], LDP);
            wmma::mma_sync(lp[j], ga, pb, lp[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nf) wmma::store_matrix_sync(dst + j0 + j * 16, lp[j], R2p, wmma::mem_row_major);
    }
  }
};

// Kernel A (the int8 form on TmaS8, or with packed codes and rescales the W4 form on W4Src), then kernel B.
int launch(const void* qact, const void* ascales, const void* wt, const void* rescales, const void* wscales,
           const void* lora_act, const void* proj_up, const void* bias, const void* rsmooth, const void* proj_down,
           void* gbuf, void* amax_part, void* lora_part, void* qout, void* qscales, void* lora_next, int M, int N,
           int K, int R, int R2, int bn, float shift, const void* layer_idx, int L, void* stream) {
  if (R < 0 || R2 < 1 || K % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GeluEpi::Params e{static_cast<const float*>(ascales), static_cast<const float*>(wscales),
                          static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
                          static_cast<const bf16*>(bias), static_cast<const float*>(rsmooth),
                          static_cast<const bf16*>(proj_down), static_cast<float*>(gbuf),
                          static_cast<float*>(amax_part), static_cast<float*>(lora_part),
                          lora_act == nullptr ? 0 : R, R2, shift};
  int err;
  if (rescales == nullptr) {
    Src::Params p;
    if (!Src::maps(p, qact, wt, M, N, K, 1, static_cast<const int*>(layer_idx), L))
      return static_cast<int>(cudaErrorInvalidValue);
    err = gemm90::launch<gemm90::S8, BN, ST, Src, GeluEpi>(p, e, M, N, K, s);
  } else {
    gemm90::W4Src::Params p;
    if (!gemm90::W4Src::maps(p, qact, wt, rescales, M, N, K, 1, static_cast<const int*>(layer_idx), L))
      return static_cast<int>(cudaErrorInvalidValue);
    err = gemm90::launch_w4<GeluEpi>(p, e, M, N, K, s);
  }
  if (err != 0) return err;
  return requant(gbuf, rsmooth, amax_part, lora_part, qout, qscales, lora_next, M, N, R2, bn, shift, s);
}

}  // namespace s8

}  // namespace

// qact (M, K) int8, ascales (M,) f32, wt (N, K) int8 (the (K, N) weight
// K-contiguous), wscales (N,) f32,
// lora_act (M, R) f32 | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null,
// rsmooth_next (N,) f32, proj_down_next (N, R2) bf16; scratch gbuf (M, N) f32,
// amax_part (N/128, M) f32, lora_part (N/128, M, R2p) f32 with R2p = R2
// rounded up to 16
// -> qout (M, N) int8, qscales (N/bn, M) f32, lora_next (M, R2) f32.
// Needs M % 128 == 0, N % 128 == 0, K % 64 == 0, bn % 128 == 0, N / bn <= 256,
// R2 >= 1 (any R, R2). bn = N is the per-token mode (qscales (1, M)).
// layer_idx: null, or a device int32 naming the layer of a stack of L
// weights, each stored (N, K), that starts at wt.
extern "C" int nt_gemm_w8a8_gelu_quant(const void* qact, const void* ascales, const void* wt,
                                       const void* wscales, const void* lora_act,
                                       const void* proj_up, const void* bias, const void* rsmooth,
                                       const void* proj_down, void* gbuf, void* amax_part,
                                       void* lora_part, void* qout, void* qscales, void* lora_next,
                                       int M, int N, int K, int R, int R2, int bn, float shift,
                                       const void* layer_idx, int L, void* stream) {
  return s8::launch(qact, ascales, wt, nullptr, wscales, lora_act, proj_up, bias, rsmooth, proj_down, gbuf,
                    amax_part, lora_part, qout, qscales, lora_next, M, N, K, R, R2, bn, shift, layer_idx, L, stream);
}

// The W4 form: qweight (K/2, N) int8 packed int4 codes (N-contiguous, the
// block-split-half layout) with rescales (K/64, N) bf16 in place of wt;
// every other operand as above. Needs K % 256 == 0 besides. layer_idx: null,
// or a device int32 naming the layer of a stack of L (K/2, N) code arrays
// that starts at qweight (the rescales are that layer's).
extern "C" int nt_gemm_w4a8_gelu_quant(const void* qact, const void* ascales, const void* qweight,
                                       const void* rescales, const void* wscales, const void* lora_act,
                                       const void* proj_up, const void* bias, const void* rsmooth,
                                       const void* proj_down, void* gbuf, void* amax_part,
                                       void* lora_part, void* qout, void* qscales, void* lora_next,
                                       int M, int N, int K, int R, int R2, int bn, float shift,
                                       const void* layer_idx, int L, void* stream) {
  if (rescales == nullptr || K % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return s8::launch(qact, ascales, qweight, rescales, wscales, lora_act, proj_up, bias, rsmooth, proj_down, gbuf,
                    amax_part, lora_part, qout, qscales, lora_next, M, N, K, R, R2, bn, shift, layer_idx, L, stream);
}
