// Online-softmax flash attention, non-causal, one head dim D per instantiation:
// 64 (SDXL's self- and cross-attention), 112 (SANA's cross-attention) and 128
// (FLUX / Qwen-Image under fixed_softmax = False, with its mask, block-sparse
// and token-major forms) on the Hopper attention core (flash_sm90.cuh, policy
// ONLINE); 256 and 512 (the VAE decoder's single-head mid-block attention) on
// the head-dim split kernel below.
//
// Replaces nunchaku_tpu/ops/attention.py _flash_kernel (:607, launched by
// flash_attention :672 with fixed_softmax=False), with and without its kv
// mask (:610-613, :634-635), writing (B, H, Sq, D) or, as out_bshd=True,
// (B, Sq, H*D). Per kv tile of BKV columns (128 on the core, 32 on the split
// kernel; JAX's tile is up to 1536), for each query row:
//   s = f32(q . k) * (scale * log2 e) [+ mask[b, col]];   kv columns >= Skv -> -1e30
//   m_new = max(m, rowmax(s));  p = bf16(exp2(bf16(s - m_new)))
//   alpha = exp2(m - m_new);  l = l * alpha + sum(f32(p))
//   acc = acc * alpha + p @ v (f32);  at the end out = bf16(acc / l), (B, H, Sq, D).
// On the core p is ex2.approx.ftz.bf16x2 of the bf16-rounded argument, two
// at a time, and alpha ex2.approx.ftz; the split kernel takes exp2f of the
// bf16-rounded argument, rounded to bf16. The _rn intrinsics keep nvcc from
// contracting the scale, the subtraction and the l update into FMAs, so the
// steps round as the plain twin's torch ops do. The twin rescales at the
// same tile (ops/attention.py online_tile).
//
// Bound on the H100: operations (4*Sq*Skv*D bf16 FLOP per head), and at D 64
// the exponentials too (SDXL's self-attention at S 4096, 10 heads: 1.7e8 of
// them, ~0.045 ms at ~16 ex2 a clock an SM, as long as its products). On the
// core a consumer's exp2 pass of one tile runs while the tensor cores do the
// previous tile's p . v, and the two consumer warpgroups of a block interleave
// too. The core's D 64 takes four k / v stages; D 112 runs as D 128 with the
// last 16 columns zero (TMA fills them), seven k16 steps of q . k and 112
// output columns stored. SDXL's cross-attention Skv = 77 is one tile, its
// columns 77-127 masked; SANA's 300 three, the last holding 44.
//
// The mask form (MASK, D 128: Qwen-Image's attention under fixed_softmax =
// False) adds a (B, S_kv) f32 log2-domain bias, 0 or -1e30 for a bool mask,
// to the scaled logits. A masked column's -1e30 only becomes a row's running
// max while every column seen so far was masked (a prompt whose first tile is
// all padding); the first unmasked tile then rescales l and acc by
// exp2(-1e30 - m) = 0, and from there on a masked column's p is exp2(-1e30) =
// 0. Every row of the joint sequence has valid keys (image keys are never
// masked), so the result is that of the unmasked keys alone.
//
// The block-sparse form (IDX, D 128) replaces _bs_kernel (:1153, launched by
// block_sparse_attention :1241 with fixed_softmax=False): each query row
// attends only to the kv blocks that select_blocks picked for its query
// block, read from a (B*H, Sq/bq, kk) int32 id tensor on the card
// (sparse_walk.cuh); the producer loads, and the consumers walk, the selected
// blocks' 128-column tiles in ascending order, one rescale a tile. The first
// tile of a row always holds valid columns (a block starts below Skv), so the
// running max starts from a real logit; the tail block's tiles past Skv are
// not visited. With every block selected the output is the dense form's bit
// for bit.
//
// The token-major form (TOK, D 128) replaces _flash_kernel_bshd (:927,
// launched by flash_attention_bshd :848): q, k, v and the output are (B, S,
// H, D); the tensor maps view them as (D, H, S, B), so a box of 128 token rows
// of one head is read at a row stride of H * D and neither side needs a
// transposed copy in device memory. The JAX kernel's logit factor scale *
// log2(e) is the wrapper's scale_log2; the loop is the dense one, so the
// output equals the dense form's on the transposed tensors bit for bit.
//
// The split kernel (D 256 and 512): mma.sync m16n8k16 in the FlashAttention-2
// register layout, with the head dim split between warps, because a 16 x 512
// f32 accumulator (256 registers a thread) does not fit. A block owns 64
// query rows of one (batch, head) and runs 8 warps: warp w takes row group
// w % 4 (16 rows) and head-dim half w / 4 (D/2 columns). For each 32-column kv
// tile a warp computes the partial logits q[:, half] . k[:, half]^T, trades
// them with its partner warp (w ^ 4) through shared memory, and adds the other
// half; float addition commutes, so both warps of a pair hold bit-identical
// logits, row max, p and alpha. Each then rescales and accumulates its own
// D/2 output columns (16 x 256 f32 = 128 registers a thread at D = 512). q
// stays in shared memory and is re-read by ldmatrix for each tile; k and v
// stream through a two-stage cp.async ring. At D = 512 that is 65 KB of q,
// 130 KB of k/v stages and 16 KB of logit exchange: one block per SM.
#include "flash_sm90.cuh"

namespace {

using sm90::bf16_exp2;
using sm90::quad_max;

constexpr int BQ = 64, BKV = 32, WARPS = 8, THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct SplitSmem {
  static constexpr int LD = D + 8;  // bf16 row stride: an odd number of 16-byte chunks
  bf16 q[BQ][LD];
  bf16 k[2][BKV][LD];
  bf16 v[2][BKV][LD];
  float xs[WARPS][BKV / 2][32];  // partial logits: [warp][fragment value][lane]
};

// rows [row0, row0 + rows) of a (nrows, D) matrix into a tile; rows past the
// end are zero-filled without being read
template <int D>
__device__ __forceinline__ void load_rows(bf16 (*dst)[D + 8], const bf16* src, int row0, int rows, int nrows) {
  for (int c = threadIdx.x; c < rows * (D / 8); c += THREADS) {
    const int r = c / (D / 8), cc = c % (D / 8);
    const int row = row0 + r;
    const bool ok = static_cast<unsigned>(row) < static_cast<unsigned>(nrows);
    cp_async16(&dst[r][cc * 8], src + static_cast<size_t>(ok ? row : 0) * D + cc * 8, ok);
  }
}

__device__ __forceinline__ void pair_sync(int id) {  // the two warps of one row group
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       bf16* __restrict__ out, int H, int Sq, int Skv, float scale_log2, int bshd) {
  constexpr int DH = D / 2, NT = BKV / 8;
  static_assert(DH % 16 == 0, "each warp half must be a whole number of k16 steps");
  using Smem = SplitSmem<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 3, c0 = (warp >> 2) * DH;  // row group, first head-dim column
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment row group / column pair
  const int mi = lane >> 3, mr = lane & 7;         // ldmatrix: which 8x8 matrix, which of its rows
  const bf16* qp = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kp = k + static_cast<size_t>(bh) * Skv * D;
  const bf16* vp = v + static_cast<size_t>(bh) * Skv * D;

  load_rows<D>(sm.q, qp, q0, BQ, Sq);
  load_rows<D>(sm.k[0], kp, 0, BKV, Skv);
  load_rows<D>(sm.v[0], vp, 0, BKV, Skv);
  cp_async_commit();

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the running sums
  float* mine = &sm.xs[warp][0][0];
  const float* theirs = &sm.xs[warp ^ 4][0][0];

  const int nt = (Skv + BKV - 1) / BKV;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {
      load_rows<D>(sm.k[st ^ 1], kp, (t + 1) * BKV, BKV, Skv);
      load_rows<D>(sm.v[st ^ 1], vp, (t + 1) * BKV, BKV, Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kv0 = t * BKV;

    float s[NT][4];  // kv tile j, (row g | g+8) x (column pair t4)
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      // q A fragment: matrix mi covers rows +8*(mi&1), columns +8*(mi>>1)
      uint32_t a[4];
      ldsm_x4(&sm.q[rg * 16 + (mi & 1) * 8 + mr][c0 + kk * 16 + (mi >> 1) * 8], a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int j2 = 0; j2 < BKV / 16; ++j2) {
        // matrix mi: kv rows +8*(mi>>1) (next n8 tile), d columns +8*(mi&1) (b1 half)
        uint32_t b0, b1, b2, b3;
        ldsm_x4(&sm.k[st][j2 * 16 + (mi >> 1) * 8 + mr][c0 + kk * 16 + (mi & 1) * 8], b0, b1, b2, b3);
        mma_bf16(s[2 * j2], a, b0, b1);
        mma_bf16(s[2 * j2 + 1], a, b2, b3);
      }
    }

    // the partner warp holds the same fragment positions for the other half
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = s[j][e];
    pair_sync(1 + rg);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t4 * 2 + (e & 1);
        const float x = __fmul_rn(__fadd_rn(s[j][e], theirs[(j * 4 + e) * 32 + lane]), scale_log2);
        s[j][e] = col < Skv ? x : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]); else mx1 = fmaxf(mx1, s[j][e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(__fsub_rn(m0, mn0)), al1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = bf16_exp2(__fsub_rn(s[j][e], e < 2 ? mn0 : mn1));
        s[j][e] = p;
        if (e < 2) ls0 += p; else ls1 += p;
      }
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      // p (exact in bf16) as the A fragment of p @ v
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]), pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < DH / 16; ++n2) {
        // transposed: matrix mi covers kv rows +8*(mi&1) (b1 half), d columns +8*(mi>>1) (next n8 tile)
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(&sm.v[st][c * 16 + (mi & 1) * 8 + mr][c0 + n2 * 16 + (mi >> 1) * 8], b0, b1, b2, b3);
        mma_bf16(o[2 * n2], pa, b0, b1);
        mma_bf16(o[2 * n2 + 1], pa, b2, b3);
      }
    }
    __syncthreads();  // stage st and the exchange slots are rewritten next iteration
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + rg * 16 + g, row1 = row0 + 8;
  // (B, Sq, H*D): row stride H*D from (b, 0, h); (B, H, Sq, D): stride D from (b, h, 0)
  const size_t ld = bshd ? static_cast<size_t>(H) * D : D;
  bf16* base = out + (bshd ? (static_cast<size_t>(b) * Sq * H + h) * D : static_cast<size_t>(bh) * Sq * D);
  bf16* dst0 = base + row0 * ld + c0;
  bf16* dst1 = dst0 + 8 * ld;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int d = n * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst0 + d) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][0], l0), __fdiv_rn(o[n][1], l0));
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst1 + d) =
          __floats2bfloat162_rn(__fdiv_rn(o[n][2], l1), __fdiv_rn(o[n][3], l1));
  }
}

template <int D>
int launch_split(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq, int Skv,
                 float scale_log2, int bshd, cudaStream_t stream) {
  static_assert(sizeof(SplitSmem<D>) <= 232448, "shared memory over the H100's 227 KB");
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(SplitSmem<D>));
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_split_kernel<D><<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                          static_cast<const bf16*>(v), static_cast<bf16*>(out), H,
                                                          Sq, Skv, scale_log2, bshd);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int FORM>
int launch_core(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int H, int Sq,
                int Skv, int bshd, const Sparse& sp, cudaStream_t stream) {
  return sm90::launch<sm90::ONLINE, D, FORM>(q, k, v, mask, out, nullptr, B, H, Sq, Skv, bshd, sp, stream);
}

}  // namespace

// q (B, H, Sq, D), k/v (B, H, Skv, D) bf16, mask null or a (B, Skv) f32
// log2-domain bias whose rows are padded with -1e30 to a multiple of 128 (D =
// 128 only) -> out (B, H, Sq, D) bf16, or (B, Sq, H*D)
// when bshd != 0; D in {64, 112, 128, 256, 512}; scale_log2 = softmax scale * log2(e), as f32.
extern "C" int nt_flash_online(const void* q, const void* k, const void* v, const void* mask, void* out,
                               int B, int H, int Sq, int Skv, int D, int bshd, float scale_log2,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  if (mask) {
    if (D != 128) return static_cast<int>(cudaErrorInvalidValue);
    return launch_core<128, sm90::MASK>(q, k, v, mask, out, B, H, Sq, Skv, bshd, dense, s);
  }
  switch (D) {
    case 64: return launch_core<64, sm90::PLAIN>(q, k, v, nullptr, out, B, H, Sq, Skv, bshd, dense, s);
    case 112: return launch_core<112, sm90::PLAIN>(q, k, v, nullptr, out, B, H, Sq, Skv, bshd, dense, s);
    case 128: return launch_core<128, sm90::PLAIN>(q, k, v, nullptr, out, B, H, Sq, Skv, bshd, dense, s);
    case 256: return launch_split<256>(q, k, v, out, B, H, Sq, Skv, scale_log2, bshd, s);
    case 512: return launch_split<512>(q, k, v, out, B, H, Sq, Skv, scale_log2, bshd, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Block-sparse, D = 128: q (B, H, Sq, 128), k/v (B, H, Skv, 128) bf16, idx
// (B*H, nq, kk) int32 kv-block ids (nq = ceil(Sq / bq); bq, bkv multiples of
// 128) -> out (B, Sq, H*128) when bshd, else (B, H, Sq, 128).
extern "C" int nt_bs_online(const void* q, const void* k, const void* v, const void* idx, void* out, int B,
                            int H, int Sq, int Skv, int nq, int kk, int bq, int bkv, int bshd,
                            float scale_log2, void* stream) {
  if (bq % sm90::BQ || bkv % sm90::BKV || kk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Sparse sp{static_cast<const int*>(idx), nq, kk, bq, bkv, scale_log2};
  return launch_core<128, sm90::IDX>(q, k, v, nullptr, out, B, H, Sq, Skv, bshd, sp,
                                     static_cast<cudaStream_t>(stream));
}

// Token-major, D = 128: q (B, Sq, H, 128), k/v (B, Skv, H, 128) bf16 -> out
// (B, Sq, H, 128) bf16; scale_log2 = softmax scale * log2(e), as f32.
extern "C" int nt_flash_online_bshd(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
                                    int Skv, float scale_log2, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  return launch_core<128, sm90::TOK>(q, k, v, nullptr, out, B, H, Sq, Skv, 1, dense,
                                     static_cast<cudaStream_t>(stream));
}
