// int8 x int8 -> int32 tensor-core main loop (WMMA) of the packed-int4
// forms: the W4 form of the chain producer (gemm_w8a8_gelu_quant.cu) and the
// packed w4a8 GEMM (gemm_w4a8.cu); also of the pipelined producer
// (gemm_w8a8_gelu_quant_pipe.cu) and the int8 GEMM probe's "chain" tile
// (gemm_probe_i8.cu). The int8 chain kernels' int8 forms run on the s8
// instantiation of gemm_sm90.cuh and take only the low-rank helpers at the
// end of this file (LoraRows, stage_lora_rows, lora_sums_4x16: the products
// of add_lora_bias in its order), so both forms' epilogues stay the same
// arithmetic.
//
// Block tile 128 x 128 x 64, eight warps as 2 (M) x 4 (N), warp tile
// 64 x 32 = 4 x 2 WMMA 16x16x16 s8 fragments. Both operands are
// K-contiguous (the tensor cores' native int8 "TN" layout): activations
// (M, K) row-major, the weight as its (N, K) transpose -- the (K, N) weight
// the dequant kernel writes K-contiguous. They stream through a two-stage
// cp.async ring in shared memory, each stage holding 16-byte k chunks
// ([chunk][row][16]) so that every 16x16 WMMA fragment is one contiguous,
// 32-byte-aligned 256-byte block (WMMA needs 256-bit-aligned fragment
// pointers, which a plain 64-byte-wide row tile cannot give at odd 16-byte
// offsets).
//
// The weight operand is a template parameter of mainloop: WeightI8 copies
// the int8 (N, K) tile straight into the stage; WeightW4 copies the packed
// int4 (K/2, N) tile and its rescale row as they lie in memory and decodes
// them in shared memory into the same K-contiguous int8 layout before the
// tile's products, so no int8 copy of the weight ever reaches HBM. Each
// weight form's select_layer moves its pointer to one layer of a stack (the
// stacked modes, common.cuh stacked_layer): K*N bytes a layer for int8,
// K*N/2 for packed int4.
#pragma once

#include <mma.h>

#include "w4_decode.cuh"

namespace i8gemm {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int WM = 64, WN = 32;
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int KC = BK / 16;
constexpr int MAX_R = 128;  // largest low-rank width the wrappers pass (nunchaku's rank-128 checkpoints)

struct Stage {
  int8_t a[KC][BM][16];  // a[kc][m] = qact[m0 + m, k0 + 16 kc : +16]
  int8_t b[KC][BN][16];  // b[kc][n] = w[k0 + 16 kc : +16, n0 + n]
};

// bf16(lora_act) rows and proj_up columns of one tile, staged for the
// epilogue in dynamic shared memory sized by the call's rank R:
// la[R][BM] (transposed: at a given rank column the 16 rows a warp reads
// sit side by side, not R apart in one bank), pu[R][BN] (lora_bytes(R)
// bytes from `base`).
struct LoraTile {
  bf16* la;
  bf16* pu;
  int R;
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ constexpr size_t lora_bytes(int R) {
  return align128(static_cast<size_t>(BM) * R * sizeof(bf16)) + align128(static_cast<size_t>(R) * BN * sizeof(bf16));
}

__device__ __forceinline__ LoraTile lora_tile(unsigned char* base, int R) {
  return LoraTile{reinterpret_cast<bf16*>(base),
                  reinterpret_cast<bf16*>(base + align128(static_cast<size_t>(BM) * R * sizeof(bf16))), R};
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> BFrag;

// the activation tile qa[m0:+BM, k0:+BK] into st.a
__device__ __forceinline__ void load_a(Stage& st, const int8_t* qa, int m0, int k0, int K) {
  for (int c = threadIdx.x; c < BM * KC; c += THREADS) {
    int r = c / KC, kc = c % KC;
    cp_async16(&st.a[kc][r][0], qa + static_cast<size_t>(m0 + r) * K + k0 + kc * 16, true);
  }
}

// The int8 weight (K, N), read from its (N, K) K-contiguous storage wt.
// load() fills a whole stage, activations first, in one function (the
// int8 forms' code is then the same as before the weight operand was a
// template parameter).
struct WeightI8 {
  using StageT = Stage;
  static constexpr bool kDecode = false;
  const int8_t* wt;
  __device__ __forceinline__ void load(Stage& st, const int8_t* qa, int m0, int n0, int k0, int K) const {
    for (int c = threadIdx.x; c < BM * KC; c += THREADS) {
      int r = c / KC, kc = c % KC;
      cp_async16(&st.a[kc][r][0], qa + static_cast<size_t>(m0 + r) * K + k0 + kc * 16, true);
    }
    for (int c = threadIdx.x; c < BN * KC; c += THREADS) {
      int r = c / KC, kc = c % KC;
      cp_async16(&st.b[kc][r][0], wt + static_cast<size_t>(n0 + r) * K + k0 + kc * 16, true);
    }
  }
  __device__ __forceinline__ void decode(Stage&, int) const {}
  // layer idx of an (L, K, N) stack whose layers are each stored (N, K)
  __device__ __forceinline__ void select_layer(const int* idx, int L, int K, int N) {
    wt = stacked_layer(wt, idx, L, static_cast<size_t>(K) * N);
  }
};

// A stage of the packed-int4 weight: the raw tile and its rescale row beside
// the decoded int8 tile in Stage::b.
struct PackedStage : Stage {
  int8_t raw[BK][BN];  // raw[j][n] = qweight[p0 + j, n0 + n], the 64 packed rows of this k tile
  bf16 rs[BN];         // rescales[k0 / 64, n0 + n]
};

// The packed-int4 w4a8 weight: qweight (K/2, N) int8, N-contiguous, in the
// block-split-half layout, with bf16 rescales (K/64, N); logical row k
// decodes to clip(round(nibble * rescale[k / 64]), +-127), as the dequant
// kernel writes it. A 64-row logical k tile (k0 % 64 == 0) is one rescale
// group and one nibble plane of 64 consecutive packed rows: packed row
// (k0 / 256) * 128 + k0 % 128 on, the high nibble when k0 % 256 >= 128. So
// each packed byte is read twice, once per plane (the second read mostly
// from L2). The copy is 16-byte cp.async vectors along N; the decode gives
// each thread one (column, 16-k chunk) at a time: 16 byte reads down a
// column of the raw tile (a warp reads 32 consecutive bytes of one row, no
// bank conflict), one 16-byte store into b[kc][n].
struct WeightW4 {
  using StageT = PackedStage;
  static constexpr bool kDecode = true;
  const int8_t* qw;
  const bf16* rs;
  int N;
  __device__ __forceinline__ void load(PackedStage& st, const int8_t* qa, int m0, int n0, int k0, int K) const {
    load_a(st, qa, m0, k0, K);
    const int p0 = k0 / 256 * 128 + k0 % 128;
    for (int c = threadIdx.x; c < BK * BN / 16; c += THREADS) {
      int r = c / (BN / 16), cc = c % (BN / 16);
      cp_async16(&st.raw[r][cc * 16], qw + static_cast<size_t>(p0 + r) * N + n0 + cc * 16, true);
    }
    if (threadIdx.x < BN / 8)
      cp_async16(&st.rs[threadIdx.x * 8], rs + static_cast<size_t>(k0 / 64) * N + n0 + threadIdx.x * 8, true);
  }
  __device__ __forceinline__ void decode(PackedStage& st, int k0) const {
    const bool hi = k0 % 256 >= 128;
    for (int t = threadIdx.x; t < BN * KC; t += THREADS) {
      const int n = t % BN, kc = t / BN;
      const float r = bf2f(st.rs[n]);
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int8_t c = rescale_code<false>(nibble(st.raw[kc * 16 + q * 4 + e][n], hi), r);
          v[q] |= static_cast<uint32_t>(static_cast<uint8_t>(c)) << (8 * e);
        }
      }
      *reinterpret_cast<uint4*>(&st.b[kc][n][0]) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  // layer idx of an (L, K/2, N) stack of packed codes (the rescales are the layer's own)
  __device__ __forceinline__ void select_layer(const int* idx, int L, int K, int N) {
    qw = stacked_layer(qw, idx, L, static_cast<size_t>(K / 2) * N);
  }
};

// The main loop's barrier: the whole block, or (the pipelined producer) a
// named barrier over the THREADS threads that run the main loop.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// acc += qa[m0:m0+BM, kb:ke] @ w[kb:ke, n0:n0+BN]; (ke - kb) % BK == 0.
// st2 is the two-stage ring of the weight's stage type. Returns with every
// copy landed and the main loop's threads synchronised (by sync), so the
// caller may reuse the ring's memory right away.
template <class W, class Sync = BlockSync>
__device__ __forceinline__ void mainloop(typename W::StageT* st2, AccFrag (&acc)[FM][FN], const int8_t* qa,
                                         const W& w, int m0, int n0, int kb, int ke, int K, Sync sync = Sync()) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int tiles = (ke - kb) / BK;
  w.load(st2[0], qa, m0, n0, kb, K);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) w.load(st2[(t + 1) & 1], qa, m0, n0, kb + (t + 1) * BK, K);
    cp_async_commit();
    cp_async_wait<1>();
    sync();
    if constexpr (W::kDecode) {  // the raw tile -> st.b, seen by every warp before the products
      w.decode(st2[t & 1], kb + t * BK);
      sync();
    }
    const Stage& st = st2[t & 1];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      AFrag a[FM];
      BFrag b[FN];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm) wmma::load_matrix_sync(a[fm], &st.a[kc][wm * WM + fm * 16][0], 16);
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) wmma::load_matrix_sync(b[fn], &st.b[kc][wn * WN + fn * 16][0], 16);
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) wmma::mma_sync(acc[fm][fn], a[fm], b[fn], acc[fm][fn]);
    }
    sync();
  }
  cp_async_wait<0>();
  sync();
}

__device__ __forceinline__ void zero(AccFrag (&acc)[FM][FN]) {
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) wmma::fill_fragment(acc[fm][fn], 0);
}

// Hands each lane 8 consecutive accumulator values of one fragment row:
// f(fm, fn, ml, nl, v) with (ml, nl) the tile-local row and first column.
// scr is this warp's 16x16 int scratch in shared memory. Lanes 2r and 2r+1
// hold row r of a fragment (columns 0-7 and 8-15).
template <class F>
__device__ __forceinline__ void for_each_fragment(int* scr, AccFrag (&acc)[FM][FN], F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      wmma::store_matrix_sync(scr, acc[fm][fn], 16, wmma::mem_row_major);
      __syncwarp();
      int v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = scr[r * 16 + c0 + i];
      __syncwarp();
      f(fm, fn, wm * WM + fm * 16 + r, wn * WN + fn * 16 + c0, v);
    }
  }
}

// Stage bf16(lora_act[m0:, :R]) (transposed) and proj_up[:R, n0:] for the epilogue.
__device__ __forceinline__ void stage_lora(const LoraTile& lt, const float* la, const bf16* pu, int m0, int n0,
                                           int N, int R) {
  for (int i = threadIdx.x; i < BM * R; i += THREADS) {
    int j = i / BM, r = i % BM;
    lt.la[i] = __float2bfloat16(la[static_cast<size_t>(m0 + r) * R + j]);
  }
  for (int i = threadIdx.x; i < R * BN; i += THREADS) {
    int j = i / BN, c = i % BN;
    lt.pu[i] = pu[static_cast<size_t>(j) * N + n0 + c];
  }
  __syncthreads();
}

// out[i] += bf16(la[ml, :]) . pu[:, nl + i] (f32), then + bias, for 8 columns.
__device__ __forceinline__ void add_lora_bias(const LoraTile& lt, float (&out)[8], int ml, int nl, int n,
                                              int R, const bf16* bias) {
  if (R > 0) {
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    for (int j = 0; j < R; ++j) {
      float a = bf2f(lt.la[j * BM + ml]);
      const bf16* prow = lt.pu + static_cast<size_t>(j) * BN + nl;
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = fmaf(a, bf2f(prow[i]), s[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __fadd_rn(out[i], s[i]);
  }
  if (bias != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __fadd_rn(out[i], bf2f(bias[n + i]));
  }
}

// The s8 epilogues' low-rank tiles (gemm_w8a8_gelu_quant.cu, gemm_w8a8_grouped.cu): bf16(lora_act[m0:, :R])
// row-major, rows ld = R rounded up to 8, plus 8, apart (16-byte aligned rows: eight ranks a load), and
// proj_up[:R, n0:] [R][BN]; lora_rows_bytes(R) bytes from `base`.
struct LoraRows {
  bf16* la;
  bf16* pu;
  int R, ld;
};

__host__ __device__ constexpr int lora_rows_ld(int R) { return (R + 7) / 8 * 8 + 8; }

__host__ __device__ constexpr size_t lora_rows_bytes(int R) {
  return R == 0 ? 0
                : align128(static_cast<size_t>(BM) * lora_rows_ld(R) * sizeof(bf16)) +
                      align128(static_cast<size_t>(R) * BN * sizeof(bf16));
}

__device__ __forceinline__ LoraRows lora_rows(unsigned char* base, int R) {
  return LoraRows{reinterpret_cast<bf16*>(base),
                  reinterpret_cast<bf16*>(base + align128(static_cast<size_t>(BM) * lora_rows_ld(R) * sizeof(bf16))),
                  R, lora_rows_ld(R)};
}

// The tiles of lr by `threads` threads (index ct), the loads in flight together: proj_up's rows by 16-byte
// cp.async copies, lora_act's rows by batches of float4 loads (scalar when R % 4 != 0). The caller waits for
// the copies (cp_async_wait<0>) and synchronises its threads before reading them.
__device__ __forceinline__ void stage_lora_rows(const LoraRows& lr, const float* __restrict__ la,
                                                const bf16* __restrict__ pu, int m0, int n0, int N, int ct,
                                                int threads) {
  const int R = lr.R;
  for (int i = ct; i < R * (BN / 8); i += threads) {
    const int j = i / (BN / 8), c = i % (BN / 8);
    cp_async16(lr.pu + j * BN + 8 * c, pu + static_cast<size_t>(j) * N + n0 + 8 * c, true);
  }
  cp_async_commit();
  if (R % 4 == 0) {  // item i: row i / (R / 4), ranks 4 (i % (R / 4)) .. + 3
    constexpr int BATCH = 4;
    const int q = R / 4;
    for (int i0 = ct; i0 < BM * q; i0 += BATCH * threads) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * threads;
        if (i < BM * q) v[u] = __ldg(reinterpret_cast<const float4*>(la + static_cast<size_t>(m0) * R) + i);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * threads;
        if (i < BM * q) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(lr.la + (i / q) * lr.ld + 4 * (i % q));
          d[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
          d[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
        }
      }
    }
  } else {
    for (int i = ct; i < BM * R; i += threads)
      lr.la[(i / R) * lr.ld + i % R] = __float2bfloat16(__ldg(la + static_cast<size_t>(m0) * R + i));
  }
}

// The rank-R sums of add_lora_bias for a thread's 4 x 16 block of the tile (the s8 epilogues' thread tile:
// rows r0 .. r0 + 3, columns c0 .. c0 + 7 and c0 + 64 .. c0 + 71): s[8 (2q + h) + i] = sum over j in order of
// fmaf(bf16(la[r0 + q, j]), pu[j, c0 + 64h + i]), the same products and order as add_lora_bias. Eight ranks of
// a row are one 16-byte load; eight threads with c0 = 0, 8, .., 56 read 128 contiguous bytes of a proj_up row.
__device__ __forceinline__ void lora_sums_4x16(const LoraRows& lr, float (&s)[64], int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  auto rank = [&](int j, const float (&a)[4]) {
    const bf16* prow = lr.pu + static_cast<size_t>(j) * BN + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 raw = *reinterpret_cast<const uint4*>(prow + 64 * h);
      const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[8 * (2 * q + h) + i] = fmaf(a[q], bf2f(p[i]), s[8 * (2 * q + h) + i]);
    }
  };
  int j0 = 0;
  for (; j0 + 8 <= lr.R; j0 += 8) {
    uint4 la8[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) la8[q] = *reinterpret_cast<const uint4*>(lr.la + (r0 + q) * lr.ld + j0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = bf2f(reinterpret_cast<const bf16*>(&la8[q])[u]);
      rank(j0 + u, a);
    }
  }
  for (int j = j0; j < lr.R; ++j) {
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = bf2f(lr.la[(r0 + q) * lr.ld + j]);
    rank(j, a);
  }
}

}  // namespace i8gemm
