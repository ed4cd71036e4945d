// Online-softmax flash attention, non-causal, one head dim D per instantiation:
// 64 (SDXL's self- and cross-attention), 112 (SANA's cross-attention) and 128
// (FLUX / Qwen-Image under fixed_softmax = False, with its mask, block-sparse
// and token-major forms) on the Hopper attention core (flash_sm90.cuh, policy
// ONLINE); 256 and 512 (the VAE decoder's single-head mid-block attention) on
// the wide wgmma + TMA kernel below.
//
// Replaces nunchaku_tpu/ops/attention.py _flash_kernel (:607, launched by
// flash_attention :672 with fixed_softmax=False), with and without its kv
// mask (:610-613, :634-635), writing (B, H, Sq, D) or, as out_bshd=True,
// (B, Sq, H*D). Per kv tile of BKV columns (128 on the core, 64 on the wide
// kernel; JAX's tile is up to 1536), for each query row:
//   s = f32(q . k) * (scale * log2 e) [+ mask[b, col]];   kv columns >= Skv -> -1e30
//   m_new = max(m, rowmax(s));  p = bf16(exp2(bf16(s - m_new)))
//   alpha = exp2(m - m_new);  l = l * alpha + sum(f32(p))
//   acc = acc * alpha + p @ v (f32);  at the end out = bf16(acc / l), (B, H, Sq, D).
// p is ex2.approx.ftz.bf16x2 of the bf16-rounded argument, two at a time,
// and alpha ex2.approx.ftz. The wide kernel may split the kv range of a query
// block and merge the partial (m, l, acc) (see its note). The _rn intrinsics keep nvcc from
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
// The wide kernel (D 256 and 512: the VAE decoder's mid-block attention,
// one head of 512 over a tile's 4096 tokens or a whole image's 16384): a
// 64 x 512 f32 output is 256 registers a thread in one warpgroup, so a block
// owns BQ = 64 query rows and its two warpgroups split the head dim of O
// (64 x D/2 each: 128 registers at D 512). What bounds it on the H100 is the
// L2: a block reads all of k and v (2 KB a kv row at D 512) for 64 query
// rows, 64 FLOP a byte, and 989 TFLOP/s would need ~15 TB/s from L2; and the
// grid: 64 query blocks at S 4096 fill half of 132 SMs. Design:
//   - 256 threads, no producer warpgroup; each warpgroup's first thread
//     issues that warpgroup's TMA copies. q (64 rows, D/64 panels of 128-byte
//     rows, 128-byte swizzle) arrives once.
//   - kv tiles of WBKV = 64 columns. S = q . k^T is split by columns:
//     warpgroup w computes the logits of kv rows 32w .. 32w + 31 of the tile
//     over the whole head dim (wgmma m64n32k16, both operands K-major in
//     shared memory), so it reads only its 32 rows of each k tile; those
//     rows are its own copy (a 32-row box a panel) on its own full barrier.
//   - The softmax: each warpgroup's row maxima of its 32 columns meet in
//     shared memory (named barrier 1); both form the same new max (fmaxf is
//     exact), p = bf16(2^bf16(x - m)) two at a time (ex2.approx.ftz.bf16x2,
//     as the attention core), alpha = 2^(m_old - m), and each warpgroup
//     writes its 32 columns of p into one 64 x 64 bf16 tile in the 128-byte
//     swizzle (named barrier 2). Each keeps the row sums of its own columns;
//     the two meet at the end.
//   - O += P . V: warpgroup w multiplies the whole p tile (K-major, from
//     shared memory) by its half of v (D/2 columns, MN-major: wgmma
//     m64n256k16 at D 512, m64n128k16 at D 256, the panel stride in the
//     descriptor's leading offset), so it reads only its half of each v tile,
//     again its own copy on its own barrier. A warpgroup refills its k rows
//     once both have passed barrier 1 of the tile, its v half once its own
//     four warps have finished the tile's products.
//   - The ring holds one tile of k and v at D 512 (q 64 KB, k 64 KB, v 64 KB,
//     p 8 KB), two at D 256. (Slower on the card: pairing two query blocks
//     in a cluster to share each k / v copy by TMA multicast, a stage copied
//     again once both blocks' warpgroup had arrived on an empty barrier in
//     each: with one stage the pair runs in lockstep, 4x at S 4096.)
//   - Grid fill: when the query blocks fill at most half the card (B H
//     ceil(Sq / 64) <= 66), the kv tiles are split in two (or four, at <= 33)
//     contiguous ranges, one block each, and the blocks of one query block
//     form a thread-block cluster. After the loop each block publishes its
//     row maxima and sums in shared memory; every block forms M = max m_r,
//     a_r = 2^(m_r - M) and L = sum over r of l_r a_r (in rank order), scales
//     its O by its a_r and stores it (f32) in its own shared memory; block r
//     then sums rows [r 64 / ns, (r + 1) 64 / ns) of the ns partial O in rank
//     order (distributed shared memory), divides by L and stores bf16. The
//     plain twin splits and merges the same way (ops/attention.py
//     online_splits). One split stores straight from the registers.
//   - Rescales fall every 64 columns (attention.online_tile); the ragged last
//     tile masks columns past Skv to -1e30, TMA zero-fills rows past Sq / Skv.
#include "flash_sm90.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int WBQ = 64, WBKV = 64, WTHREADS = 2 * sm90::WG;
constexpr int MAX_SPLITS = 4, SPLIT_SMS = 132;  // the H100's SMs: the split rule (mirrored in ops/attention.py)

// kv splits of a call: 2 or 4 while the query blocks, so multiplied, fill at most the card
inline int wide_splits(int B, int H, int Sq, int Skv) {
  const long blocks = static_cast<long>(B) * H * ((Sq + WBQ - 1) / WBQ);
  const int nt = (Skv + WBKV - 1) / WBKV;
  int ns = 1;
  while (ns < MAX_SPLITS && blocks * ns * 2 <= SPLIT_SMS && nt >= ns * 2) ns *= 2;
  return ns;
}

template <int D>
struct Wide {
  static constexpr int P = D / 64;                      // 64-column panels of q, k and v
  static constexpr int ST = D >= 512 ? 1 : 2;            // k and v tiles in the ring
  static constexpr int PANEL = WBKV * 128;               // one panel of a k or v tile (and of q: WBQ = WBKV)
  static constexpr int TILE = P * PANEL;                 // bytes of one k or v tile
  static constexpr int OFF_K = P * PANEL, OFF_V = OFF_K + ST * TILE, OFF_P = OFF_V + ST * TILE;
  static constexpr int OFF_RED = OFF_P + WBQ * 128;      // row maxima [2][64], sums [2][64], m [64], L [64]
  static constexpr int OFF_BAR = OFF_RED + 6 * WBQ * 4;  // q full; k full [ST][2]; v full [ST][2]
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 4 * ST) + 1024;
  static constexpr int LDO = D + 8;  // f32 row stride of a block's partial O in the merge (over q, k, v)
  static_assert(BYTES <= 232448, "shared memory over the H100's 227 KB");
  static_assert(WBQ * LDO * 4 <= OFF_P, "the merge's partial O fits over q, k and v");
};

// d (64 x 32 f32) (+)= A (64 x 16, K-major in shared memory) . B (32 x 16, K-major)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// out: (B, H, Sq, D) or, bshd, (B, Sq, H*D). Grid: (ns * ceil(Sq / 64), B*H), clusters of ns along x.
template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int H, int Sq, int Skv,
                      int bshd, int ns, float scale_log2) {
  using namespace sm90;
  using W = Wide<D>;
  constexpr int P = W::P, ST = W::ST, PH = P / 2, DH = D / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* red = reinterpret_cast<float*>(sm + W::OFF_RED);
  float* mx = red;                // [2][64] this tile's row maxima, each warpgroup's 32 columns
  float* lsum = red + 2 * WBQ;    // [2][64] each warpgroup's row sums (at the end)
  float* mrow = red + 4 * WBQ;    // [64] the block's row maxima (at the end)
  float* lrow = red + 5 * WBQ;    // [64] the merged row sums L
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + W::OFF_BAR);
  uint64_t* kfull = qfull + 1;       // [ST][2]
  uint64_t* vfull = kfull + 2 * ST;  // [ST][2]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int rank = blockIdx.x % ns, q0 = blockIdx.x / ns * WBQ;
  const int nt = (Skv + WBKV - 1) / WBKV, t0 = rank * nt / ns, t1 = (rank + 1) * nt / ns;
  const int ct = threadIdx.x, w = ct / WG, warp = (ct % WG) / 32, lane = ct % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's two rows of the block
  const bool issuer = ct % WG == 0;

  if (ct == 0) {
    mbar_init(qfull, 1);
#pragma unroll
    for (int i = 0; i < 2 * ST; ++i) {
      mbar_init(kfull + i, 1);
      mbar_init(vfull + i, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // this warpgroup's 32 k rows of tile t (all panels) and its half of the v tile
  auto load_k = [&](int t, int s) {
    uint64_t* bar = kfull + 2 * s + w;
    mbar_expect_tx(bar, P * 32 * 128);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load(sm + W::OFF_K + s * W::TILE + p * W::PANEL + w * 32 * 128, &tk, bar, 64 * p, t * WBKV + 32 * w, h, b);
  };
  auto load_v = [&](int t, int s) {
    uint64_t* bar = vfull + 2 * s + w;
    mbar_expect_tx(bar, PH * W::PANEL);
#pragma unroll
    for (int p = w * PH; p < (w + 1) * PH; ++p)
      tma_load(sm + W::OFF_V + s * W::TILE + p * W::PANEL, &tv, bar, 64 * p, t * WBKV, h, b);
  };
  if (issuer) {
    if (w == 0) {
      mbar_expect_tx(qfull, P * W::PANEL);
#pragma unroll
      for (int p = 0; p < P; ++p) tma_load(sm + p * W::PANEL, &tq, qfull, 64 * p, q0, h, b);
    }
    for (int i = 0; i < ST && t0 + i < t1; ++i) {
      load_k(t0 + i, i);
      load_v(t0 + i, i);
    }
  }

  float o[DH / 2];  // output columns DH w + 8j + 2 t4 + (e & 1) of rows r0 (e < 2), r1: o[4j + e]
  float s[16];      // logits, then p: kv columns 32w + 8j + 2 t4 + (e & 1) of the tile
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  unsigned char* ptile = sm + W::OFF_P;

  mbar_wait(qfull, 0);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, st = i % ST, parity = (i / ST) & 1;
    const unsigned char* kt = sm + W::OFF_K + st * W::TILE + w * 32 * 128;
    const unsigned char* vt = sm + W::OFF_V + st * W::TILE + w * PH * W::PANEL;
    mbar_wait(kfull + 2 * st + w, parity);
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32(s, sw128_desc(sm + (kk / 4) * W::PANEL + (kk % 4) * 32),
                   sw128_desc(kt + (kk / 4) * W::PANEL + (kk % 4) * 32), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(s);

    const int kv0 = t * WBKV + 32 * w;
    float mx0 = NEG_INF, mx1 = NEG_INF;
    const bool ragged = t * WBKV + WBKV > Skv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * j + e], scale_log2);
        if (ragged && kv0 + 8 * j + 2 * t4 + (e & 1) >= Skv) x = NEG_INF;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (t4 == 0) {
      mx[w * WBQ + r0] = mx0;
      mx[w * WBQ + r1] = mx1;
    }
    named_sync(1);  // both halves' maxima are in; both warpgroups' q . k of this tile are done
    if (issuer && t + ST < t1) load_k(t + ST, st);
    const float mn0 = fmaxf(m0, fmaxf(mx[r0], mx[WBQ + r0])), mn1 = fmaxf(m1, fmaxf(mx[r1], mx[WBQ + r1]));
    const float al0 = ex2(__fsub_rn(m0, mn0)), al1 = ex2(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t p0 = ex2_bf16x2(__fsub_rn(s[4 * j], mn0), __fsub_rn(s[4 * j + 1], mn0));
      const uint32_t p1 = ex2_bf16x2(__fsub_rn(s[4 * j + 2], mn1), __fsub_rn(s[4 * j + 3], mn1));
      ls0 += bf16_lo(p0);
      ls0 += bf16_hi(p0);
      ls1 += bf16_lo(p1);
      ls1 += bf16_hi(p1);
      // column 32w + 8j + 2 t4 of rows r0, r1: 16-byte chunk 4w + j of the row, swizzled by the row
      const int c = 4 * w + j;
      *reinterpret_cast<uint32_t*>(ptile + r0 * 128 + ((c ^ (r0 & 7)) << 4) + 4 * t4) = p0;
      *reinterpret_cast<uint32_t*>(ptile + r1 * 128 + ((c ^ (r1 & 7)) << 4) + 4 * t4) = p1;
    }
    l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
    l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);
    fence_proxy_async();  // the p stores, visible to wgmma's reads
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) o[e] *= (e & 2) ? al1 : al0;
    named_sync(2);  // both halves of p are in the tile

    mbar_wait(vfull + 2 * st + w, parity);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int c = 0; c < WBKV / 16; ++c)
      gemm90::Bf16::mma<DH>(o, sw128_desc(ptile + c * 32), sw128_desc(vt + c * 16 * 128, W::PANEL / 16), 1);
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
    wg_sync(3 + w);  // this warpgroup's four warps are done with its v half
    if (issuer && t + ST < t1) load_v(t + ST, st);
  }

  // row sums: this thread's share, then the quad's, then both warpgroups'
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t4 == 0) {
    lsum[w * WBQ + r0] = l0;
    lsum[w * WBQ + r1] = l1;
    if (w == 0) {
      mrow[r0] = m0;
      mrow[r1] = m1;
    }
  }
  const size_t ld = bshd ? static_cast<size_t>(H) * D : D;
  bf16* base = out + (bshd ? (static_cast<size_t>(b) * Sq * H + h) * D : static_cast<size_t>(bh) * Sq * D);
  if (ns == 1) {
    __syncthreads();
    const float L0 = __fadd_rn(lsum[r0], lsum[WBQ + r0]), L1 = __fadd_rn(lsum[r1], lsum[WBQ + r1]);
    bf16* dst0 = base + (q0 + r0) * ld + DH * w + 2 * t4;
    bf16* dst1 = dst0 + 8 * ld;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (q0 + r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * j], L0), __fdiv_rn(o[4 * j + 1], L0));
      if (q0 + r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2], L1), __fdiv_rn(o[4 * j + 3], L1));
    }
    return;
  }

  // ---- the merge of the ns kv splits (this block: cluster rank `rank`) ----
  cluster_sync();  // every block's row maxima and sums are published
  float a0 = 0.f, a1 = 0.f;  // this block's factor 2^(m_r - M) of rows r0, r1
  {
    // every block's maxima and sums of rows r0, r1, loaded first (the remote loads in flight together)
    float mr[2][MAX_SPLITS], lr[2][MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < ns) {
        mr[0][r] = ld_cluster(cluster_addr(mrow + r0, r));
        mr[1][r] = ld_cluster(cluster_addr(mrow + r1, r));
        lr[0][r] = __fadd_rn(ld_cluster(cluster_addr(lsum + r0, r)), ld_cluster(cluster_addr(lsum + WBQ + r0, r)));
        lr[1][r] = __fadd_rn(ld_cluster(cluster_addr(lsum + r1, r)), ld_cluster(cluster_addr(lsum + WBQ + r1, r)));
      }
    }
    float M0 = NEG_INF, M1 = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < ns) {
        M0 = fmaxf(M0, mr[0][r]);
        M1 = fmaxf(M1, mr[1][r]);
      }
    }
    float L0 = 0.f, L1 = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < ns) {
        const float f0 = ex2(__fsub_rn(mr[0][r], M0)), f1 = ex2(__fsub_rn(mr[1][r], M1));
        L0 = __fadd_rn(L0, __fmul_rn(lr[0][r], f0));
        L1 = __fadd_rn(L1, __fmul_rn(lr[1][r], f1));
        if (r == rank) {
          a0 = f0;
          a1 = f1;
        }
      }
    }
    if (w == 0 && t4 == 0) {
      lrow[r0] = L0;
      lrow[r1] = L1;
    }
  }
  // this block's O, scaled by its factor, into its own shared memory (over q, k and v: all consumed)
  float* opart = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = DH * w + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(opart + r0 * W::LDO + col) =
        make_float2(__fmul_rn(o[4 * j], a0), __fmul_rn(o[4 * j + 1], a0));
    *reinterpret_cast<float2*>(opart + r1 * W::LDO + col) =
        make_float2(__fmul_rn(o[4 * j + 2], a1), __fmul_rn(o[4 * j + 3], a1));
  }
  cluster_sync();  // every block's scaled O is in
  // rows [rank 64 / ns, (rank + 1) 64 / ns): the ns partial O summed in rank order, over L
  const int rows = WBQ / ns, first = rank * rows, total = rows * (D / 4);
  for (int c0 = ct; c0 < total; c0 += 4 * WTHREADS) {
    float4 part[4][MAX_SPLITS];  // four float4 of each block, loaded first (the remote loads in flight together)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * WTHREADS, r = first + c / (D / 4), col = 4 * (c % (D / 4));
#pragma unroll
      for (int k = 0; k < MAX_SPLITS; ++k)
        if (c < total && k < ns) part[u][k] = ld_cluster4(cluster_addr(opart + r * W::LDO + col, k));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * WTHREADS, r = first + c / (D / 4), col = 4 * (c % (D / 4));
      if (c >= total || q0 + r >= Sq) continue;
      float4 acc = part[u][0];
#pragma unroll
      for (int k = 1; k < MAX_SPLITS; ++k) {
        if (k < ns) {
          acc.x = __fadd_rn(acc.x, part[u][k].x);
          acc.y = __fadd_rn(acc.y, part[u][k].y);
          acc.z = __fadd_rn(acc.z, part[u][k].z);
          acc.w = __fadd_rn(acc.w, part[u][k].w);
        }
      }
      const float L = lrow[r];
      bf16* dst = base + (q0 + r) * ld + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(__fdiv_rn(acc.x, L), __fdiv_rn(acc.y, L));
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(__fdiv_rn(acc.z, L), __fdiv_rn(acc.w, L));
    }
  }
  cluster_sync();  // the others' reads of this block's shared memory are done
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq, int Skv,
                float scale_log2, int bshd, cudaStream_t stream) {
  using W = Wide<D>;
  CUtensorMap tq, tk, tv;
  if (!sm90::head_map(&tq, q, D, Sq, H, B, false, WBQ) || !sm90::head_map(&tk, k, D, Skv, H, B, false, 32) ||
      !sm90::head_map(&tv, v, D, Skv, H, B, false, WBKV))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, W::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int ns = wide_splits(B, H, Sq, Skv);
  const dim3 grid(ns * ((Sq + WBQ - 1) / WBQ), B * H);
  cudaError_t e = sm90::launch_cluster(flash_wide_kernel<D>, grid, WTHREADS, W::BYTES, ns, stream, tq, tk, tv,
                                       static_cast<bf16*>(out), H, Sq, Skv, bshd, ns, scale_log2);
  if (e != cudaSuccess) return static_cast<int>(e);
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
    case 256: return launch_wide<256>(q, k, v, out, B, H, Sq, Skv, scale_log2, bshd, s);
    case 512: return launch_wide<512>(q, k, v, out, B, H, Sq, Skv, scale_log2, bshd, s);
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
