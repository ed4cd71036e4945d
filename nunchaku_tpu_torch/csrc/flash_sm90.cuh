// The Hopper attention core under flash_fixed.cu and flash_online.cu: one
// sm_90a main loop (TMA copies, wgmma products, a warp-specialised block),
// templated on the softmax policy (FIXED: the fixed shift, no running max;
// ONLINE: the running max with a rescale per kv tile), the head dim (64, 112
// or 128) and the form (PLAIN, MASK, IDX, DENOM, U2, TOK). Each entry point of
// the two files is one instantiation; the forms' notes are in those files.
//
// Bound on the H100: operations (4 * Sq * Skv * D bf16 flop a head; at FLUX's
// S 4608 the work per byte is ~S/2, far above the bf16 ridge), and at D 64 the
// exponentials as well (Sq * Skv of them a head at ~16 ex2 a clock an SM, as
// long as the products). What held the mma.sync kernels back was shared-memory
// traffic: eight warps of 16 rows each read every k and v tile with ldmatrix,
// 256 KB a 64-column step against ~1,000 clocks of tensor work. Design:
//   - A block owns BQ = 128 query rows of one (batch, head) and runs three
//     warpgroups. Warpgroup 0 is the producer: its registers lowered to 24
//     (setmaxnreg), one thread issues every TMA copy. Warpgroups 1 and 2 are
//     consumers of 64 rows each (setmaxnreg raises them to 240).
//   - q arrives once; k and v stream through a ring of ST stages (2 at D 128
//     and 112, 4 at D 64) of BKV = 128 rows, with a full barrier for k, one
//     for v and an empty barrier per stage (mbarrier; the eight consumer warps
//     arrive on the empty one). Every tile is 64-column panels of 128-byte
//     rows in the 128-byte swizzle, which the wgmma descriptors name.
//   - The tensor maps are 4-D views (D, S, H, B) of (B, H, S, D) tensors, or
//     (D, H, S, B) of token-major (B, S, H, D) ones, built by the host per call
//     (cuTensorMapEncodeTiled from cudaGetDriverEntryPoint*, so the library
//     needs no -lcuda) and passed as __grid_constant__ parameters. TMA fills
//     rows past S with zeros, and at D 112 the columns 112-127 of the second
//     panel: D 112 runs as D 128 whose last 16 columns are zero (q . k takes
//     seven k16 steps; p . v's last 16 output columns are not stored).
//   - S = q . k^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); O += P . V is wgmma m64n64k16 per 64-column panel of v with P
//     in registers: the S accumulators, packed to bf16 pairs, are exactly the
//     A-fragment layout, and v is read MN-major (the transposed B operand).
//   - Each consumer warpgroup takes one kv tile at a time: q . k, the
//     softmax on the accumulators, p . v. The two consumer warpgroups of a
//     block run independently, so one's softmax runs under the other's
//     products. (Issuing the next tile's q . k before this tile's softmax
//     needs the logits of two tiles, p and o live at once, ~200 registers a
//     thread: ptxas allocates the consumers within the launch's 168, not the
//     240 setmaxnreg grants, and then serializes every wgmma and spills; the
//     one-tile order fits in 168 with neither.)
//   - Exponentials: ex2.approx.ftz. The online policy forms bf16(2^bf16(x -
//     m)) two at a time with ex2.approx.ftz.bf16x2, whose packed result is the
//     A fragment of p . v as it stands; the fixed shift's f32 p is packed after.
//   - Ragged edges: only a tile that reaches past Skv masks its columns past
//     Skv to -1e30, on a tile-level branch; rows past Sq are not stored.
//   - A barrier wait that spins for seconds (a lost arrival) traps instead of
//     hanging the card.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime (no -lcuda)

#include "mma.cuh"
#include "sparse_walk.cuh"

namespace {
namespace sm90 {

constexpr int BQ = 128, BKV = 128, WG = 128, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65,536
constexpr float NEG_INF = -1e30f, SHIFT = 16.f, CAP = 116.f;

enum Policy { FIXED = 0, ONLINE = 1 };
// The forms, one at a time: the kv-mask bias, the block-sparse walk, the row
// sums written beside o, the two-tile form's entry point (the dense loop with
// the logit factor), the token-major layout.
enum Form { PLAIN = 0, MASK = 1, IDX = 2, DENOM = 3, U2 = 4, TOK = 5 };

template <int D>
struct Layout {
  static constexpr int P = (D + 63) / 64;     // 64-column panels (128-byte rows)
  static constexpr int ST = D <= 64 ? 4 : 2;  // k / v stages
  static constexpr int KS = (D + 15) / 16;    // k16 steps of q . k
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BKV * 128;
  static constexpr int KV = P * KV_PANEL;  // bytes of one k (or v) tile
  static constexpr int OFF_K = P * Q_PANEL, OFF_V = OFF_K + ST * KV, OFF_MASK = OFF_V + ST * KV;
  static constexpr int MASK_TILE = BKV * 4;  // a kv tile's f32 bias (MASK)
  static constexpr int OFF_BAR = OFF_MASK + ST * MASK_TILE;
  // q full, then k full, v full and empty per stage; + 1024 to align the base
  static constexpr int BYTES = OFF_BAR + 8 * (1 + 3 * ST) + 1024;
  static_assert(BYTES <= 232448, "shared memory over the H100's 227 KB");
};

// ---------------------------------------------------------------------------
// barriers, copies, products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// One box of a 4-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle: start
// address, 1024 bytes (eight rows) between 8-row groups, swizzle mode 1. The
// leading offset is unused by these shapes (a K-major operand; an MN-major one
// 64 columns wide).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers an asynchronous
// product owns across the fence or wait next to it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers of the two consumer warpgroups (ids 1 and 2, 256 threads):
// a warpgroup waits for its turn before it issues products and hands the
// turn to the other after.
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (64 x 128 f32, accumulator layout) (+)= A (64 x 16, K-major in shared memory) . B (128 x 16, K-major)^T;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers: four packed pairs a thread, the accumulator layout's)
// . B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// the two softmax policies on one tile's logits, in place
// ---------------------------------------------------------------------------
// s[4j + e]: row g (e < 2) or g + 8 (e >= 2) of the thread's warp, column
// kv0 + 8j + 2 t4 + (e & 1) of the tile (the wgmma accumulator layout).

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float bf16_exp2(float x) {  // bf16(exp2(bf16(x))), the split kernel's
  return bf2f(__float2bfloat16_rn(exp2f(bf2f(__float2bfloat16_rn(x)))));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, subnormal results flushed to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16(2^bf16(lo)), bf16(2^bf16(hi)) as one packed pair (lo in the low half)
__device__ __forceinline__ uint32_t ex2_bf16x2(float lo, float hi) {
  const uint32_t x = pack_bf16(lo, hi);
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// A logit before the softmax: the factor (every form but the fixed plain and
// masked ones), the kv-mask bias of tile column c (tb: the tile's bias in
// shared memory), the -1e30 of a column past Skv.
template <int POLICY, int FORM, bool RAGGED>
__device__ __forceinline__ float logit(float s, int kv0, int c, int Skv, const float* tb, float scale) {
  constexpr bool SCALED = POLICY == ONLINE || FORM == IDX || FORM == DENOM || FORM == U2;
  float x = SCALED ? __fmul_rn(s, scale) : s;
  if (FORM == MASK) x = __fadd_rn(x, tb[c]);
  return RAGGED && kv0 + c >= Skv ? NEG_INF : x;
}

// The p of one tile goes straight into the A fragments of p . v: the pair
// (s[4j + 2h], s[4j + 2h + 1]) is pa[j / 2][2 (j % 2) + h].

// p = 2^(min(x, 116) - 16) in f32, packed to bf16 for p . v; the f32 p summed
// into the thread's row shares, each 64-column half apart, then added.
template <int FORM, bool RAGGED>
__device__ __forceinline__ void fixed_tile(const float (&s)[64], uint32_t (&pa)[BKV / 16][4], float& l0, float& l1,
                                           int kv0, int Skv, int t4, const float* tb, float scale) {
  float h0[2] = {0.f, 0.f}, h1[2] = {0.f, 0.f};  // the sums of each 64-column half
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = logit<FIXED, FORM, RAGGED>(s[4 * j + e], kv0, 8 * j + 2 * t4 + (e & 1), Skv, tb, scale);
      p[e] = ex2(fminf(x, CAP) - SHIFT);
      if (e < 2) h0[j / 8] += p[e]; else h1[j / 8] += p[e];
    }
    pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
  }
  // the tile's sum (sum p1 + sum p2, as JAX's two-tile step adds it), then the
  // running one: a long row's sum keeps its f32 accuracy
  l0 += h0[0] + h0[1];
  l1 += h1[0] + h1[1];
}

// m_new = max(m, rowmax x); p = bf16(2^bf16(x - m_new)), two at a time
// (ex2.approx.ftz.bf16x2), packed as they come; alpha = 2^(m - m_new);
// l = l * alpha + sum p (the thread's share). O's rescale by alpha is the caller's.
template <int FORM, bool RAGGED>
__device__ __forceinline__ void online_tile(float (&s)[64], uint32_t (&pa)[BKV / 16][4], float& m0, float& m1,
                                            float& l0, float& l1, float& al0, float& al1, int kv0, int Skv, int t4,
                                            const float* tb, float scale) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = logit<ONLINE, FORM, RAGGED>(s[4 * j + e], kv0, 8 * j + 2 * t4 + (e & 1), Skv, tb, scale);
      s[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  al0 = ex2(__fsub_rn(m0, mn0));
  al1 = ex2(__fsub_rn(m1, mn1));
  m0 = mn0;
  m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    const uint32_t r0 = ex2_bf16x2(__fsub_rn(s[4 * j], mn0), __fsub_rn(s[4 * j + 1], mn0));
    const uint32_t r1 = ex2_bf16x2(__fsub_rn(s[4 * j + 2], mn1), __fsub_rn(s[4 * j + 3], mn1));
    ls0 += bf16_lo(r0);
    ls0 += bf16_hi(r0);
    ls1 += bf16_lo(r1);
    ls1 += bf16_hi(r1);
    pa[j / 2][2 * (j % 2)] = r0;
    pa[j / 2][2 * (j % 2) + 1] = r1;
  }
  l0 = __fadd_rn(__fmul_rn(l0, al0), ls0);
  l1 = __fadd_rn(__fmul_rn(l1, al1), ls1);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// out: (B, Sq, H*D) when bshd (TOK: (B, Sq, H, D), the same rows), else (B, H,
// Sq, D); lsum (DENOM): (B, H, Sq); mask (MASK): (B, mask_ld) f32 log2-domain
// bias, each row padded with -1e30 to mask_ld = Skv rounded up to BKV.
template <int POLICY, int D, int FORM>
__global__ void __launch_bounds__(THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask, bf16* __restrict__ out,
                      float* __restrict__ lsum, int H, int Sq, int Skv, int bshd, Sparse sp) {
  using L = Layout<D>;
  constexpr int ST = L::ST, P = L::P;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::OFF_BAR);
  uint64_t* kfull = bar + 1;
  uint64_t* vfull = bar + 1 + ST;
  uint64_t* empty = bar + 1 + 2 * ST;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const KvWalk<FORM == IDX, BKV> walk(sp, bh, q0, Skv);
  const int nt = walk.nt;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform by construction (a shuffle from lane 0), so the compiler sees the
  // two roles as whole warpgroups and budgets each branch's registers by its setmaxnreg
  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (role == 0) {
    // ---- producer: one thread issues every copy ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // (D, S, H, B) coordinates, or (D, H, S, B) token-major
      auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* full, int row) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (FORM == TOK)
            tma_load(dst + p * BKV * 128, map, full, 64 * p, h, row, b);
          else
            tma_load(dst + p * BKV * 128, map, full, 64 * p, row, h, b);
        }
      };
      const int mask_ld = (Skv + BKV - 1) / BKV * BKV;
      mbar_expect_tx(bar, P * L::Q_PANEL);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (FORM == TOK)
          tma_load(sm + p * L::Q_PANEL, &tq, bar, 64 * p, h, q0, b);
        else
          tma_load(sm + p * L::Q_PANEL, &tq, bar, 64 * p, q0, h, b);
      }
      for (int t = 0; t < nt; ++t) {
        const int s = t % ST;
        mbar_wait(empty + s, ((t / ST) & 1) ^ 1);
        const int kv0 = walk.start(t);
        mbar_expect_tx(kfull + s, L::KV + (FORM == MASK ? L::MASK_TILE : 0));
        load(sm + L::OFF_K + s * L::KV, &tk, kfull + s, kv0);
        if (FORM == MASK)  // rows of the bias are padded to whole tiles
          bulk_load(sm + L::OFF_MASK + s * L::MASK_TILE, mask + static_cast<size_t>(b) * mask_ld + kv0, L::MASK_TILE,
                    kfull + s);
        mbar_expect_tx(vfull + s, L::KV);
        load(sm + L::OFF_V + s * L::KV, &tv, vfull + s, kv0);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    reg_alloc<CONSUMER_REGS>();
    const int ct = threadIdx.x - WG, cw = ct / WG, warp = (ct % WG) / 32, lane = ct % 32;
    const int t4 = lane & 3;
    const unsigned char* qs = sm + cw * 64 * 128;  // this warpgroup's rows of each q panel
    const float scale = sp.scale_log2;

    float s[64];         // logits, then p
    float o[P][32];      // output columns 64p + 8j + 2 t4 + (e & 1) of rows g, g + 8
    uint32_t pa[BKV / 16][4];  // p in bf16: the A fragments of p . v
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
    float l0 = 0.f, l1 = 0.f, m0 = NEG_INF, m1 = NEG_INF, al0 = 1.f, al1 = 1.f;

    auto issue_s = [&](int st) {
      const unsigned char* kt = sm + L::OFF_K + st * L::KV;
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk)
        wgmma_ss_n128(s, sw128_desc(qs + (kk / 4) * L::Q_PANEL + (kk % 4) * 32),
                      sw128_desc(kt + (kk / 4) * L::KV_PANEL + (kk % 4) * 32), kk > 0);
    };
    auto issue_pv = [&](int st) {
      const unsigned char* vt = sm + L::OFF_V + st * L::KV;
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c)
#pragma unroll
        for (int p = 0; p < P; ++p) wgmma_rs_n64(o[p], pa[c], sw128_desc(vt + p * L::KV_PANEL + c * 16 * 128));
    };
    auto softmax = [&](int t, int st) {
      const int kv0 = walk.start(t);
      const float* tb = reinterpret_cast<const float*>(sm + L::OFF_MASK + st * L::MASK_TILE);
      if (kv0 + BKV > Skv) {
        if (POLICY == FIXED) fixed_tile<FORM, true>(s, pa, l0, l1, kv0, Skv, t4, tb, scale);
        else online_tile<FORM, true>(s, pa, m0, m1, l0, l1, al0, al1, kv0, Skv, t4, tb, scale);
      } else {
        if (POLICY == FIXED) fixed_tile<FORM, false>(s, pa, l0, l1, kv0, Skv, t4, tb, scale);
        else online_tile<FORM, false>(s, pa, m0, m1, l0, l1, al0, al1, kv0, Skv, t4, tb, scale);
      }
    };

    // One tile at a time in each warpgroup: q . k, the softmax, p . v. The two
    // warpgroups take turns to issue products (q . k of one, then of the
    // other, then p . v of one, ...), so one's softmax runs under the other's
    // products.
    mbar_wait(bar, 0);
    const int mine = 1 + cw, other = 2 - cw;
    if (cw == 1) named_arrive(other);  // warpgroup 0 takes the first turn
    for (int t = 0; t < nt; ++t) {
      const int st = t % ST, parity = (t / ST) & 1;
      mbar_wait(kfull + st, parity);
      reg_fence(s);
      named_sync(mine);
      wg_fence();
      issue_s(st);
      wg_commit();
      named_arrive(other);
      wg_wait<0>();
      reg_fence(s);
      softmax(t, st);
      if (POLICY == ONLINE) {
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[p][i] *= (i & 2) ? al1 : al0;
      }
      mbar_wait(vfull + st, parity);
      reg_fence(pa);
#pragma unroll
      for (int p = 0; p < P; ++p) reg_fence(o[p]);
      named_sync(mine);
      wg_fence();
      issue_pv(st);
      wg_commit();
      named_arrive(other);
      wg_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) reg_fence(o[p]);
      if (lane == 0) mbar_arrive(empty + st);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int row0 = q0 + cw * 64 + warp * 16 + (lane >> 2), row1 = row0 + 8;
    if (FORM == DENOM && t4 == 0) {
      if (row0 < Sq) lsum[static_cast<size_t>(bh) * Sq + row0] = l0;
      if (row1 < Sq) lsum[static_cast<size_t>(bh) * Sq + row1] = l1;
    }
    // (B, Sq, H*D): row stride H*D from (b, 0, h); (B, H, Sq, D): stride D from (b, h, 0)
    const size_t ld = bshd ? static_cast<size_t>(H) * D : D;
    bf16* base = out + (bshd ? (static_cast<size_t>(b) * Sq * H + h) * D : static_cast<size_t>(bh) * Sq * D);
    bf16* dst0 = base + row0 * ld;
    bf16* dst1 = dst0 + 8 * ld;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * p + 8 * j + 2 * t4;
        if (64 * p + 8 * j >= D) continue;  // D 112: the zero columns
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(dst0 + d) =
              __floats2bfloat162_rn(__fdiv_rn(o[p][4 * j], l0), __fdiv_rn(o[p][4 * j + 1], l0));
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(dst1 + d) =
              __floats2bfloat162_rn(__fdiv_rn(o[p][4 * j + 2], l1), __fdiv_rn(o[p][4 * j + 3], l1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one operand, boxes of 64 columns by `rows` token rows:
// a (B, H, S, D) tensor as the 4-D (D, S, H, B), a token-major (B, S, H, D)
// one as (D, H, S, B); every stride rising, in bytes.
inline bool head_map(CUtensorMap* map, const void* base, int D, int S, int H, int B, bool tok, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t d = D, s = S, h = H, nb = B;
  const cuuint64_t dims_bhsd[4] = {d, s, h, nb}, dims_tok[4] = {d, h, s, nb};
  const cuuint64_t st_bhsd[3] = {2 * d, 2 * d * s, 2 * d * s * h}, st_tok[3] = {2 * d, 2 * d * h, 2 * d * h * s};
  const cuuint32_t box_bhsd[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t box_tok[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), tok ? dims_tok : dims_bhsd,
                tok ? st_tok : st_bhsd, tok ? box_tok : box_bhsd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q (Sq rows), k and v (Skv rows) bf16, 16-byte aligned; one block per 128
// query rows of each (batch, head).
template <int POLICY, int D, int FORM>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, float* lsum, int B, int H,
           int Sq, int Skv, int bshd, const Sparse& sp, cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  const bool tok = FORM == TOK;
  if (!head_map(&tq, q, D, Sq, H, B, tok, BQ) || !head_map(&tk, k, D, Skv, H, B, tok, BKV) ||
      !head_map(&tv, v, D, Skv, H, B, tok, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_sm90_kernel<POLICY, D, FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_sm90_kernel<POLICY, D, FORM><<<grid, THREADS, L::BYTES, stream>>>(
      tq, tk, tv, static_cast<const float*>(mask), static_cast<bf16*>(out), lsum, H, Sq, Skv, bshd, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace
