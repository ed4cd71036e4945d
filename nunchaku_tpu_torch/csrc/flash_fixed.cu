// Fixed-shift flash attention, non-causal, head_dim 128.
//
// Replaces nunchaku_tpu/ops/attention.py _flash_kernel_fixed (:403, launched
// by flash_attention :672 with fixed_softmax=True, out_bshd=True), with and
// without its kv mask (:410-411, :428-429):
//   s = f32(q . k) [+ mask[b, col]];  padded kv columns -> -1e30
//   p = exp2(min(s, 116) - 16)        (no running max: q carries the log2(e)
//                                      softmax scale, so s stays far below 116)
//   l = sum of the f32 p;  o = (bf16(p) @ v) / l, written as (B, S, H*D) bf16
// p can reach 2^100, so the PV product takes bf16 p (fp16 would overflow).
//
// Bound on the H100: operations (4*S_q*S_kv*D per head in bf16; at FLUX.1-dev
// S = 4608 the work per byte is ~S/2, far above the bf16 ridge). Design: the
// FlashAttention-2 register layout on mma.sync m16n8k16 bf16. A block owns
// 128 query rows of one (batch, head); each of its 8 warps keeps its 16 rows
// of q as A fragments in registers. K and V stream in 64-row tiles through a
// two-stage cp.async ring (272-byte rows, so ldmatrix's eight row addresses
// fall in distinct banks). A warp's 16 x 64 logits stay in the mma
// accumulators; the fixed-shift exp2 runs on them in place, and the
// accumulators, packed to bf16 pairs, are exactly the A fragments of the
// p @ v product (V's B fragments come from ldmatrix.trans). With no running
// max there is no rescaling; the f32 row sums meet across the lane quad at
// the end.
//
// The mask form (MASK = true; Qwen-Image's padded prompts) adds a (B, S_kv)
// f32 log2-domain bias, 0 or -1e30 for a bool mask, to the logits before the
// cap: each thread reads the bias of its 16 columns of a kv tile (L1-resident:
// every warp of the block reads the same 64) and seeds its mma accumulators
// with it, so the loads are in flight during the q . k product and s = bias
// + q . k. A 0 bias leaves the logits bit for bit those of the unmasked
// kernel; a masked column gives exp2(min(-1e30 + q . k, 116) - 16) =
// exp2(-1e30), exactly 0, so it adds nothing to the row sum or to p @ v. The text keys
// come first in the joint sequence, so masked columns sit in the first kv
// tiles, which the loop treats like any other.
//
// The block-sparse form (IDX = true) replaces _bs_kernel_fixed (:1109,
// launched by block_sparse_attention :1241 with fixed_softmax=True): the same
// arithmetic (logits times an f32 scale_log2, 1 when q is prescaled), but each
// query row attends only to the kv blocks of bkv columns that select_blocks
// picked for its query block of bq rows. The ids, (B*H, Sq/bq, kk) int32
// ascending, stay on the card (the TPU kernel's scalar prefetch); a block reads
// the kk ids of its own 128 rows (bq is a multiple of 128, so the tile lies in
// one query block) and walks their 64-column sub-tiles in order. Only the
// largest id can be the ragged tail block (ids ascend): its sub-tiles past Skv
// are not visited, and its columns past Skv inside a visited one are masked as
// in the dense loop. At FLUX.1-dev 2048px and sparsity 0.5 a row sees 5 of the
// 11 kv blocks of 1536, so the bound is 5/11 of dense attention's; each
// visited tile costs what a dense one does.
//
// The denominator form (DENOM = true) replaces _flash_kernel_fixed_denom (:461,
// flash_attention :672 with return_denom=True), the step kernel of the ring
// (sequence-parallel) attention in nunchaku_tpu/parallel/sp.py: the dense loop
// unchanged (logits times scale_log2, exactly 1 for a prescaled q), the output
// in (B, H, Sq, D) and the f32 row sum l = sum p written beside it as (B, H,
// Sq). The fixed shift makes partial results over disjoint kv shards combine
// exactly, o = sum_i o_i l_i / sum_i l_i, so each ring step needs only o and l.
// The TPU kernel's (BH, S, 128) lane-broadcast l (a Mosaic tiling workaround)
// has no counterpart: one lane of each row's quad stores its l.
//
// The two-tile form (U = 2) replaces _flash_kernel_fixed2 (:508, flash_attention
// with kv_unroll=2): each main-loop step holds two 64-row kv tiles in its stage
// and issues both tiles' q . k products before the first tile's exp2 pass, the
// TPU kernel's overlap of the second block's matrix work with the first
// block's softmax; here the tensor cores of the second product and the exp2 of
// the first are independent instructions the scheduler can interleave. As in
// JAX, each step adds (sum p1 + sum p2) to a thread's row sums and a1 + a2 to
// the accumulators (through the mma chain); the columns past Skv of a step
// (a kv length that is no multiple of two tiles) are masked like the dense
// loop's. It holds twice the logits in registers (64 more a thread) and a
// stage of 2 x 128 kv rows (139 KB of shared memory for the two stages).
#include "mma.cuh"
#include "sparse_walk.cuh"

namespace {

constexpr int D = 128, BQ = 128, BKV = 64, WARPS = 8, THREADS = WARPS * 32;
constexpr int LDK = D + 8;  // bf16 row stride of the k/v/q tiles (272 bytes)
constexpr float SHIFT = 16.f, CAP = 116.f, NEG_INF = -1e30f;

template <int U>  // kv tiles of BKV rows per main-loop step
struct Stage {
  bf16 k[U * BKV][LDK];
  bf16 v[U * BKV][LDK];
};
template <int U>
struct Smem {
  Stage<U> st[2];  // st[1] holds the q tile ([BQ][LDK]) before the kv loop starts
};
static_assert(sizeof(Stage<1>) == sizeof(bf16) * BQ * LDK, "q staging uses one stage");

template <int U>
__device__ __forceinline__ void load_kv(Stage<U>& st, const bf16* kp, const bf16* vp, int kv0, int Skv) {
  for (int c = threadIdx.x; c < U * BKV * (D / 8); c += THREADS) {
    const int r = c / (D / 8), cc = c % (D / 8);
    const int row = kv0 + r;
    const bool ok = static_cast<unsigned>(row) < static_cast<unsigned>(Skv);
    const size_t off = static_cast<size_t>(ok ? row : 0) * D + cc * 8;
    cp_async16(&st.k[r][cc * 8], kp + off, ok);
    cp_async16(&st.v[r][cc * 8], vp + off, ok);
  }
}

// MASK: kv-mask bias; IDX: block-sparse walk; DENOM: also store l, (B, H, S, D)
// out; U: kv tiles a step. The logits take scale_log2 in every form but the
// plain and masked ones (1 for a prescaled q: the product is then exact).
template <bool MASK, bool IDX, bool DENOM = false, int U = 1>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fixed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ mask,
                       bf16* __restrict__ out, float* __restrict__ lsum, int H, int Sq, int Skv, int bshd,
                       Sparse sp) {
  static_assert(!(MASK && (IDX || DENOM || U > 1)) && !(IDX && (DENOM || U > 1)) && (U == 1 || U == 2),
                "one form at a time");
  constexpr bool SCALED = IDX || DENOM || U > 1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<U>& sm = *reinterpret_cast<Smem<U>*>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group / column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which 8x8 matrix, which of its rows
  const bf16* qp = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kp = k + static_cast<size_t>(bh) * Skv * D;
  const bf16* vp = v + static_cast<size_t>(bh) * Skv * D;
  const float* mp = MASK ? mask + static_cast<size_t>(b) * Skv : nullptr;
  const KvWalk<IDX, U * BKV> walk(sp, bh, q0, Skv);

  bf16(*qs)[LDK] = reinterpret_cast<bf16(*)[LDK]>(&sm.st[1]);
  for (int c = threadIdx.x; c < BQ * (D / 8); c += THREADS) {
    const int r = c / (D / 8), cc = c % (D / 8);
    const int row = q0 + r;
    const bool ok = row < Sq;
    cp_async16(&qs[r][cc * 8], qp + static_cast<size_t>(ok ? row : 0) * D + cc * 8, ok);
  }
  cp_async_commit();
  load_kv(sm.st[0], kp, vp, walk.start(0), Skv);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q A fragments: matrix mi covers rows +8*(mi&1), columns +8*(mi>>1) of a 16x16 chunk
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(&qs[warp * 16 + (mi & 1) * 8 + mr][kk * 16 + (mi >> 1) * 8], qf[kk][0], qf[kk][1],
            qf[kk][2], qf[kk][3]);
  __syncthreads();  // stage 1 is free for k/v

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // f32 row sums of p for rows g and g + 8

  const int nt = walk.nt;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) load_kv(sm.st[(t + 1) & 1], kp, vp, walk.start(t + 1), Skv);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Stage<U>& st = sm.st[t & 1];
    const int kv0 = walk.start(t);

    float s[U][BKV / 8][4];  // logits, then p: tile u, kv n8 tile j, (row g | g+8) x (column pair t4)
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      float m0 = 0.f, m1 = 0.f;  // the bias of columns col, col + 1 (0 past Skv: masked below)
      if (MASK) {
        const int col = kv0 + j * 8 + t4 * 2;
        if (col < Skv) m0 = __ldg(mp + col);
        if (col + 1 < Skv) m1 = __ldg(mp + col + 1);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][j][0] = s[u][j][2] = m0;
        s[u][j][1] = s[u][j][3] = m1;
      }
    }
    // every tile's q . k before the first exp2 pass
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j2 = 0; j2 < BKV / 16; ++j2) {
          // matrix mi: kv rows +8*(mi>>1) (next n8 tile), d columns +8*(mi&1) (b1 half)
          uint32_t b0, b1, b2, b3;
          ldsm_x4(&st.k[u * BKV + j2 * 16 + (mi >> 1) * 8 + mr][kk * 16 + (mi & 1) * 8], b0, b1, b2, b3);
          mma_bf16(s[u][2 * j2], qf[kk], b0, b1);
          mma_bf16(s[u][2 * j2 + 1], qf[kk], b2, b3);
        }
      }
    }

    float tl0[U], tl1[U];  // U = 2: each tile's sums of p, added to l0 / l1 together (JAX's sum p1 + sum p2)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      tl0[u] = tl1[u] = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + u * BKV + j * 8 + t4 * 2 + (e & 1);
          const float x = static_cast<unsigned>(col) < static_cast<unsigned>(Skv)
                              ? (SCALED ? __fmul_rn(s[u][j][e], sp.scale_log2) : s[u][j][e])
                              : NEG_INF;
          const float p = exp2f(fminf(x, CAP) - SHIFT);
          s[u][j][e] = p;
          if (U == 1) {
            if (e < 2) l0 += p; else l1 += p;
          } else {
            if (e < 2) tl0[u] += p; else tl1[u] += p;
          }
        }
      }
    }
    if (U == 2) {
      l0 += tl0[0] + tl0[U - 1];
      l1 += tl1[0] + tl1[U - 1];
    }

#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16(s[u][2 * c][0], s[u][2 * c][1]), pack_bf16(s[u][2 * c][2], s[u][2 * c][3]),
                                pack_bf16(s[u][2 * c + 1][0], s[u][2 * c + 1][1]),
                                pack_bf16(s[u][2 * c + 1][2], s[u][2 * c + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          // transposed: matrix mi covers kv rows +8*(mi&1) (b1 half), d columns +8*(mi>>1) (next n8 tile)
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(&st.v[u * BKV + c * 16 + (mi & 1) * 8 + mr][n2 * 16 + (mi >> 1) * 8], b0, b1, b2, b3);
          mma_bf16(o[2 * n2], pa, b0, b1);
          mma_bf16(o[2 * n2 + 1], pa, b2, b3);
        }
      }
    }
    __syncthreads();  // stage t&1 is refilled by the next iteration's copy
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  if (DENOM && t4 == 0) {
    if (row0 < Sq) lsum[static_cast<size_t>(bh) * Sq + row0] = l0;
    if (row1 < Sq) lsum[static_cast<size_t>(bh) * Sq + row1] = l1;
  }
  // (B, Sq, H*D): row stride H*D from (b, 0, h); (B, H, Sq, D): stride D from (b, h, 0)
  const size_t ld = bshd ? static_cast<size_t>(H) * D : D;
  bf16* base = out + (bshd ? (static_cast<size_t>(b) * Sq * H + h) * D : static_cast<size_t>(bh) * Sq * D);
  bf16* dst0 = base + row0 * ld;
  bf16* dst1 = dst0 + 8 * ld;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst0 + d) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][0], l0), __fdiv_rn(o[n][1], l0));
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst1 + d) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][2], l1), __fdiv_rn(o[n][3], l1));
  }
}

template <bool MASK, bool IDX, bool DENOM = false, int U = 1>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, float* lsum, int B, int H,
           int Sq, int Skv, int bshd, const Sparse& sp, cudaStream_t stream) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(Smem<U>));
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fixed_kernel<MASK, IDX, DENOM, U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fixed_kernel<MASK, IDX, DENOM, U><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(out), lsum, H, Sq, Skv, bshd, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, Sq, 128) carrying softmax-scale * log2(e), k/v (B, H, Skv, 128)
// bf16, mask null or (B, Skv) f32 log2-domain bias -> out (B, Sq, H*128) bf16.
extern "C" int nt_flash_fixed(const void* q, const void* k, const void* v, const void* mask, void* out,
                              int B, int H, int Sq, int Skv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sparse dense{nullptr, 0, 0, 0, 0, 1.f};
  return mask ? launch<true, false>(q, k, v, mask, out, nullptr, B, H, Sq, Skv, 1, dense, s)
              : launch<false, false>(q, k, v, mask, out, nullptr, B, H, Sq, Skv, 1, dense, s);
}

// Block-sparse: q (B, H, Sq, 128), k/v (B, H, Skv, 128) bf16, idx (B*H, nq,
// kk) int32 kv-block ids (nq = ceil(Sq / bq); bq, bkv multiples of 128),
// logits times scale_log2 -> out (B, Sq, H*128) when bshd, else (B, H, Sq, 128).
extern "C" int nt_bs_fixed(const void* q, const void* k, const void* v, const void* idx, void* out, int B,
                           int H, int Sq, int Skv, int nq, int kk, int bq, int bkv, int bshd,
                           float scale_log2, void* stream) {
  if (bq % BQ || bkv % BKV || kk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Sparse sp{static_cast<const int*>(idx), nq, kk, bq, bkv, scale_log2};
  return launch<false, true>(q, k, v, nullptr, out, nullptr, B, H, Sq, Skv, bshd, sp,
                             static_cast<cudaStream_t>(stream));
}

// Denominator form: q (B, H, Sq, 128), k/v (B, H, Skv, 128) bf16, logits times
// scale_log2 -> out (B, H, Sq, 128) bf16 and l (B, H, Sq) f32, the row sums of p.
extern "C" int nt_flash_fixed_denom(const void* q, const void* k, const void* v, void* out, void* l, int B, int H,
                                    int Sq, int Skv, float scale_log2, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  return launch<false, false, true>(q, k, v, nullptr, out, static_cast<float*>(l), B, H, Sq, Skv, 0, dense,
                                    static_cast<cudaStream_t>(stream));
}

// Two-tile form: as nt_flash_fixed without a mask, logits times scale_log2, out
// (B, Sq, H*128) when bshd, else (B, H, Sq, 128).
extern "C" int nt_flash_fixed_unroll2(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
                                      int Skv, int bshd, float scale_log2, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  return launch<false, false, false, 2>(q, k, v, nullptr, out, nullptr, B, H, Sq, Skv, bshd, dense,
                                        static_cast<cudaStream_t>(stream));
}
