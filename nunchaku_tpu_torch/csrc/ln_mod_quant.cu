// LayerNorm + AdaLN modulate + per-token int8 quantize, with the next
// layer's low-rank down-projection (the bf16-stream producer in front of
// every qkv projection and fc1).
//
// Replaces nunchaku_tpu/ops/quantize.py _ln_mod_quant_kernel (:149,
// launched by ln_mod_quant_int8 :179):
//   y = (x - mean) * rsqrt(var + 1e-6) [* (1 + scale[b]) + shift[b]]   (f32)
//   lora_act = bf16(y) @ proj_down;  h = y * rsmooth
//   scale = max|h| * f32(1/127);  q = clip(round_half_even(h * rcp(scale)), +-127)
// (XLA compiles the JAX kernel's `absmax / 127.0` as a multiply by the f32
// reciprocal of 127; so does this kernel.)
//
// Bound on the H100: bytes. Per token it reads K bf16 and writes K int8 plus
// R + 1 floats (3 bytes per element at R = 32, K = 3072); the rank-R product
// is 2*K*R operations per token, below the tensor cores' ridge.
// Design (one block of 256 threads a tile of 8 to 64 tokens of one batch
// row, the tiles sized so one wave fills the SMs):
//   - the block stages (1 + scale[b], shift[b]) pairs and 1 / smooth once,
//     f32 in shared memory, in lane-major orders both passes read with
//     16-byte loads free of bank conflicts;
//   - pass 1, the row pass: each of the eight warps keeps a token's row in
//     registers (K / 256 16-byte vectors a lane, the next row's loads in
//     flight under this row's arithmetic), takes mean, rstd (each sum a tree
//     of a vector's 8 values, then the vectors, then the lanes), h, its
//     absmax, the scale and the codes, and writes them; mean and rstd go to
//     shared memory. No y tile is kept;
//   - pass 2, the low-rank product on register-A wgmma (m64nWk16, W 32 or
//     64): x's tile in 128-k chunks (two TMA boxes, 128-byte swizzle) and
//     proj_down's (K, R) rows in MN-major panels of W columns (TMA; 64-byte
//     swizzle at W 32, 128-byte at 64; columns past R read as zeros) arrive
//     in a ring a warpgroup, its first slots loading from the kernel's start
//     (under pass 1), each slot refilled by the warpgroup's first thread once
//     released; each consumer thread recomputes bf16(y) of its rows straight
//     into its A fragments with pass 1's float operations. The two
//     warpgroups take the two halves of K, each its even and its odd k steps
//     in two accumulator chains, and lora_act = (E0 + O0) + (E1 + O1)
//     (warpgroup 1's sum through lora_act itself): each element is the same
//     sum in the same order at any rank, width or tile. Rows are spread over
//     the four warps (a quarter of the tile's rows each, in wgmma's rows g
//     and, above 32 rows, g + 8); each proj_down byte serves every row of the
//     tile. Ranks above 64 take rounds of 64 columns, each a sweep over K.
//
// Dual mode (DUAL = true): replaces _ln_mod_quant2_kernel (:265, launched by
// ln_mod_quant_int8_dual :292), FLUX's single block, where one modulated
// norm feeds both the qkv and the fc1 projection, each with its own smooth
// factor and proj_down. One read of x and one LayerNorm (the modulation is
// required, as in JAX); then each head's epilogue is the single mode's: h =
// y * rsmooth, its absmax, scale and codes; the heads' low-rank products are
// rounds of the same sweeps, at the width the larger rank takes. Every output
// of a head is bit for bit a single-mode launch with that head's operands.
// Bound: bytes, one K-wide bf16 read against two int8 writes (4 bytes per
// element), where two single launches read x twice (6).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int NV_MAX = 12;                 // K <= 3072: K / 256 16-byte vectors a lane
constexpr int ROW_WARPS = 8;               // the row pass's warps: the product's two warpgroups
constexpr int THREADS = ROW_WARPS * 32;    // (no copy warp: 288 threads would cap ptxas at 168 registers)
constexpr int MAX_ROWS = 64, MIN_ROWS = 8;     // rows of a tile (wgmma's 64 at most)
constexpr int KC = 128;                    // k of a ring stage: two x boxes of 64 (128-byte rows)
constexpr int QSTRIDE = 4 * 33;            // float4 of one 256-k vector group of the staged modulation pairs
constexpr int RSTRIDE = 264;               // floats of one 256-k vector group of the staged 1 / smooth
constexpr int MAX_STAGES = 6;
constexpr int MAX_SMEM = 232448;           // the H100's 227 KB a block
constexpr float EPS = 1e-6f;
constexpr float ROUND = 12582912.f;        // 1.5 * 2^23: x + ROUND - ROUND is rint(x) for |x| < 2^22

// bytes of a stage's proj_down panel at width W: KC rows of W bf16 columns
__host__ __device__ constexpr int panel_bytes(int w) { return KC * 2 * w; }

struct Params {
  CUtensorMap xmap, pmap[2];  // x (M, K) in 64-k boxes of `rows` rows; proj_down (K, R) in KC x W boxes
  const bf16* x;
  const float* sc;            // mod scale / shift rows, ld floats apart | null (LayerNorm only)
  const float* sh;
  const bf16* smooth[2];      // (K,) | null
  int8_t* q[2];               // (M, K)
  float* asc[2];              // (M,)
  float* la[2];               // (M, R[h])
  int R[2];
  int ld, M, S, K, nv;
  int rows, tpb;              // rows of a tile, tiles of a batch row
  int stages, stage, xbytes;  // ring depth, bytes of a stage, bytes of one x box (1024-aligned)
};

// Dynamic shared memory: two rings (stages x stage), the staged modulation pairs and each head's 1 / smooth,
// mean and rstd of the tile's rows, the ring barriers.
__host__ __device__ constexpr int smem_bytes(int nv, int stages, int stage, int heads) {
  return 1024 + 2 * stages * stage + nv * (16 * QSTRIDE + 4 * RSTRIDE * heads) + 2 * 4 * MAX_ROWS +
         2 * 2 * 8 * stages;
}

// Staged float4 of the pair k = 2 p, 2 p + 1 (p = 4 (l + 32 j) + q: lane l's vector j, its pair q), holding
// (1 + scale[k], 1 + scale[k + 1], shift[k], shift[k + 1]): the 32 lanes' float4 side by side for each (j, q),
// the four q 33 float4 apart (pass 2's four lanes t4 = q then read four bank groups).
__device__ __forceinline__ int pair_at(int p) { return (p >> 7) * QSTRIDE + (p & 3) * 33 + ((p >> 2) & 31); }

// Staged position of 1 / smooth[k], k = 256 j + 8 l + 4 half + i (lane l's vector j): a lane's halves are
// 16-byte words with the 32 lanes' words side by side.
__device__ __forceinline__ int rs_at(int k) {
  return (k >> 8) * RSTRIDE + ((k >> 2) & 1) * (RSTRIDE / 2) + ((k >> 3) & 31) * 4 + (k & 3);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared-memory loads at a shared-space address (LDS, whatever the compiler infers of a pointer)
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ float4 lds4f(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n" : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// the code of h * rc: clip to +-127, then round half to even by adding 1.5 * 2^23 (the low byte of its bits)
__device__ __forceinline__ uint32_t code(float h, float rc) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(__fmul_rn(h, rc), -127.f), 127.f), ROUND));
}

// codes of one 8-element vector of h = y * r (r null: y is h)
__device__ __forceinline__ uint2 quant8(const float (&y)[8], const float* r, float rc) {
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = code(r == nullptr ? y[i] : __fmul_rn(y[i], r[i]), rc);
  return make_uint2(__byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(c[4], c[5], 0x0040), __byte_perm(c[6], c[7], 0x0040), 0x5410));
}

// the sum of 8 values as a tree (short dependency chains)
__device__ __forceinline__ float sum8(const float (&t)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3])),
                   __fadd_rn(__fadd_rn(t[4], t[5]), __fadd_rn(t[6], t[7])));
}

// max |t| of 8 values as a tree
__device__ __forceinline__ float amax8(const float (&t)[8]) {
  return fmaxf(fmaxf(fmaxf(fabsf(t[0]), fabsf(t[1])), fmaxf(fabsf(t[2]), fabsf(t[3]))),
               fmaxf(fmaxf(fabsf(t[4]), fabsf(t[5])), fmaxf(fabsf(t[6]), fabsf(t[7]))));
}

// d (64 x W f32) += A (registers: 64 x 16 a warpgroup, the mma.sync m16n8k16 A layout, warp w rows 16 w ..) . B
// (16 k rows of an MN-major proj_down panel)
template <int W>
struct RegA;

template <>
struct RegA<32> {
  __device__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct RegA<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
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
};

// The wgmma descriptor of k step s (16 rows) of a stage's MN-major proj_down panel (rows of k, W columns) at a
// shared-space address: W 32 the 64-byte swizzle (64-byte rows, 512 bytes between 8-row groups); W 64
// sw128_desc's (128-byte rows, 1024 bytes between 8-row groups).
template <int W>
__device__ __forceinline__ uint64_t pd_desc(uint32_t a, int s) {
  if constexpr (W == 32)
    return static_cast<uint64_t>(((a + s * 16 * 64) & 0x3FFFF) >> 4) | (32ull << 32) | (2ull << 62);
  return static_cast<uint64_t>(((a + s * 16 * 128) & 0x3FFFF) >> 4) | (64ull << 32) | (1ull << 62);
}

// The shared-memory views of one block.
struct Smem {
  unsigned char* ring;  // [2][stages][stage]: warpgroup h's ring at ring + h * stages * stage
  float4* mp;           // [nv * QSTRIDE] (1 + scale[b], shift[b]) pairs
  float* rs;            // [heads][nv * RSTRIDE] 1 / smooth
  float* mu;            // [MAX_ROWS]
  float* rstd;
  uint64_t* full;       // [2][stages]
  uint64_t* empty;

  __device__ Smem(unsigned char* sm, const Params& p, int heads) {
    ring = sm;
    mp = reinterpret_cast<float4*>(sm + 2 * p.stages * p.stage);
    rs = reinterpret_cast<float*>(mp + p.nv * QSTRIDE);
    mu = rs + heads * p.nv * RSTRIDE;
    rstd = mu + MAX_ROWS;
    full = reinterpret_cast<uint64_t*>(rstd + MAX_ROWS);
    empty = full + 2 * p.stages;
  }
};

// n / d for the ring's small counts (n < 2^16, d <= MAX_STAGES): magic = 0xFFFFFFFF / d + 1
__device__ __forceinline__ int div_small(int n, uint32_t magic) { return static_cast<int>(__umulhi(n, magic)); }

// The low-rank rounds of a launch, in order: each head's columns in rounds of W (past R: zeros).
template <bool DUAL, int W, typename F>
__device__ __forceinline__ void for_rounds(const Params& p, F&& f) {
#pragma unroll 1
  for (int head = 0; head < (DUAL ? 2 : 1); ++head)
#pragma unroll 1
    for (int c0 = 0; c0 < p.R[head]; c0 += W) f(head, c0);
}

// Ring slot n of warpgroup h (one thread): round n / ch (ch = K / 256 chunks a half), chunk i = n % ch of K half
// h (k = 128 (h ch + i)): the tile's two x boxes and proj_down's panel, once the stage's previous slot is
// released.
template <int W>
__device__ __forceinline__ void load_slot(const Params& p, const Smem& s, int h, int n, int row0, uint32_t magic) {
  const int ch = p.K / 256, r0 = (p.R[0] + W - 1) / W, turn = div_small(n, magic), st = n - turn * p.stages;
  int r = 0, i = n;
  while (i >= ch) i -= ch, ++r;
  const int head = r < r0 ? 0 : 1, c0 = (r < r0 ? r : r - r0) * W;
  uint64_t* full = s.full + h * p.stages + st;
  unsigned char* dst = s.ring + (h * p.stages + st) * p.stage;
  const int k = (h * ch + i) * KC;
  mbar_wait(s.empty + h * p.stages + st, (turn & 1) ^ 1);
  mbar_expect_tx(full, 2 * p.rows * 128 + panel_bytes(W));
  tma_load_2d(dst, &p.xmap, full, k, row0);
  tma_load_2d(dst + p.xbytes, &p.xmap, full, k + 64, row0);
  tma_load_2d(dst + 2 * p.xbytes, &p.pmap[head], full, c0, k);
}

// lane's K / 256 16-byte vectors of row lr of the tile (NV: their count, 0 for p.nv's)
template <int NV>
__device__ __forceinline__ void load_row(uint4 (&d)[NV_MAX], const Params& p, int row0, int lr, int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(row0 + lr) * p.K) + lane;
#pragma unroll
  for (int j = 0; j < (NV ? NV : NV_MAX); ++j)
    if (NV || j < p.nv) d[j] = __ldg(src + 32 * j);
}

// lane's eight staged 1 / smooth of vector j
__device__ __forceinline__ void rs8(float (&d)[8], uint32_t base, int j, int lane) {
  const uint32_t a = base + 4 * (j * RSTRIDE + lane * 4);
  const float4 lo = lds4f(a), hi = lds4f(a + 4 * (RSTRIDE / 2));
  d[0] = lo.x, d[1] = lo.y, d[2] = lo.z, d[3] = lo.w, d[4] = hi.x, d[5] = hi.y, d[6] = hi.z, d[7] = hi.w;
}

// lane's eight staged (1 + scale) and shift of vector j
__device__ __forceinline__ void mod8(float (&a)[8], float (&c)[8], uint32_t base, int j, int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = lds4f(base + 16 * (j * QSTRIDE + q * 33 + lane));
    a[2 * q] = v.x, a[2 * q + 1] = v.y, c[2 * q] = v.z, c[2 * q + 1] = v.w;
  }
}

// Pass 1: rows lr = warp, warp + 8, ... of the tile (row0 its first; nxt holds the first one's vectors), each
// kept in registers; codes, scales, and mean / rstd for pass 2. Each sum is a tree of a vector's 8 values, then
// the vectors in order, then the lanes.
template <int NV, bool DUAL>
__device__ __forceinline__ void row_pass(const Params& p, const Smem& s, uint4 (&nxt)[NV_MAX], int row0, int nrows,
                                         int warp, int lane) {
  constexpr int NVC = NV ? NV : NV_MAX;  // vectors the loops unroll (NV 0: p.nv of them run)
  const int nv = NV ? NV : p.nv;
  const float kf = static_cast<float>(p.K);
  const uint32_t mp = smem_u32(s.mp), rs = smem_u32(s.rs), rs_b = rs + 4 * nv * RSTRIDE;
#pragma unroll 1
  for (int lr = warp; lr < nrows; lr += ROW_WARPS) {
    const int row = row0 + lr;
    float v[NV_MAX][8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NVC; ++j) {
      if (NV == 0 && j >= nv) continue;
      const uint32_t w[4] = {nxt[j].x, nxt[j].y, nxt[j].z, nxt[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[j][2 * i] = __uint_as_float(w[i] << 16);
        v[j][2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
      sum = __fadd_rn(sum, sum8(v[j]));
    }
    if (lr + ROW_WARPS < nrows) load_row<NV>(nxt, p, row0, lr + ROW_WARPS, lane);  // under this row's arithmetic
    const float mu = __fdiv_rn(warp_sum(sum), kf);
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NVC; ++j) {
      if (NV == 0 && j >= nv) continue;
      float sq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[j][i] = __fsub_rn(v[j][i], mu);
        sq[i] = __fmul_rn(v[j][i], v[j][i]);
      }
      s2 = __fadd_rn(s2, sum8(sq));
    }
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(s2), kf), EPS));
    if (lane == 0) {
      s.mu[lr] = mu;
      s.rstd[lr] = rstd;
    }
    float amax = 0.f, amax_b = 0.f;
#pragma unroll
    for (int j = 0; j < NVC; ++j) {
      if (NV == 0 && j >= nv) continue;
      float a[8], c[8], r[8];
      mod8(a, c, mp, j, lane);
      rs8(r, rs, j, lane);
      if constexpr (DUAL) {
        float rb[8], ha[8], hb[8];
        rs8(rb, rs_b, j, lane);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float y = __fmaf_rn(__fmul_rn(v[j][i], rstd), a[i], c[i]);
          v[j][i] = y;  // y itself: each head's h is y * rsmooth, recomputed below
          ha[i] = __fmul_rn(y, r[i]);
          hb[i] = __fmul_rn(y, rb[i]);
        }
        amax = fmaxf(amax, amax8(ha));
        amax_b = fmaxf(amax_b, amax8(hb));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[j][i] = __fmul_rn(__fmaf_rn(__fmul_rn(v[j][i], rstd), a[i], c[i]), r[i]);
        amax = fmaxf(amax, amax8(v[j]));  // of h
      }
    }
    const float scale = __fmul_rn(warp_max(amax), 1.0f / 127.0f);
    const float rc = scale == 0.f ? 0.f : __fdiv_rn(1.f, scale);
    float scale_b = 0.f, rc_b = 0.f;
    if constexpr (DUAL) {
      scale_b = __fmul_rn(warp_max(amax_b), 1.0f / 127.0f);
      rc_b = scale_b == 0.f ? 0.f : __fdiv_rn(1.f, scale_b);
    }
#pragma unroll
    for (int j = 0; j < NVC; ++j) {
      if (NV == 0 && j >= nv) continue;
      const size_t off = static_cast<size_t>(row) * p.K + (lane + 32 * j) * 8;
      if constexpr (DUAL) {
        float r[8];
        rs8(r, rs, j, lane);
        *reinterpret_cast<uint2*>(p.q[0] + off) = quant8(v[j], r, rc);
        rs8(r, rs_b, j, lane);
        *reinterpret_cast<uint2*>(p.q[1] + off) = quant8(v[j], r, rc_b);
      } else {
        *reinterpret_cast<uint2*>(p.q[0] + off) = quant8(v[j], nullptr, rc);
      }
    }
    if (lane == 0) {
      p.asc[0][row] = scale;
      if constexpr (DUAL) p.asc[1][row] = scale_b;
    }
  }
}

// A consumer thread of pass 2: warpgroup h (K half h), warp wq of it, lane (g, t4). Its rows are the tile's lr0
// = rpw wq + g (wgmma row 16 wq + g) and lr1 = lr0 + 8 (row + 8), rpw = ceil(rows / 4). The warpgroup's first
// thread (the leader) refills each slot its warps release with slot n + stages.
struct Consumer {
  const Params* p;
  const Smem* s;
  uint32_t ring, mp;      // shared-space addresses: this warpgroup's ring, the staged modulation pairs
  uint64_t* full;
  uint64_t* empty;
  int stages, stage, xbytes, ch, h, t4, lane, row0, total;
  uint32_t magic;         // div_small's for stages
  bool leader, any1;      // any1: a row of this warp in wgmma's rows g + 8
  uint32_t x0, x1;        // byte offsets of rows lr0 / lr1 in an x box (clamped into it), + 4 t4
  int sw0, sw1;           // their swizzle (row & 7)
  uint32_t m0, m1;        // all ones where the row is one of the tile's, else 0
  float mu0, rs0, mu1, rs1;

  __device__ __forceinline__ int stage_of(int n) const { return n - div_small(n, magic) * stages; }
  __device__ __forceinline__ uint32_t at(int n) const { return ring + stage_of(n) * stage; }

  // bf16(y) of two elements as pass 1 computes y: ((x - mean) * rstd) * (1 + scale) + shift
  __device__ __forceinline__ static uint32_t y2(uint32_t x, float mu, float rstd, float4 m) {
    const float lo = __fmaf_rn(__fmul_rn(__fsub_rn(__uint_as_float(x << 16), mu), rstd), m.x, m.z);
    const float hi = __fmaf_rn(__fmul_rn(__fsub_rn(__uint_as_float(x & 0xffff0000u), mu), rstd), m.y, m.w);
    return pack_bf16(lo, hi);
  }

  // k steps 4 e .. 4 e + 3 of ring slot n (chunk i of this warpgroup's half; x box e) -> their A fragments:
  // bf16(y) of rows lr0 (a0, a2) and lr1 (a1, a3) at k = 128 (h ch + i) + 16 s + 2 t4 (+ 1) and + 8. Every
  // load first.
  template <bool TWO>
  __device__ __forceinline__ void frags4(uint32_t (&fa)[8][4], uint32_t xs, int i, int e) const {
    // the pair of k at step 4 e: p0; at step 4 e + j, p0 + 8 j, staged 2 j float4 further (lane + 2 j; k + 8: + 1)
    const uint32_t m = mp + 16 * pair_at((h * ch + i) * (KC / 2) + 32 * e + t4);
    const uint32_t box = xs + e * xbytes;
    float4 ma[4], mb[4];
    uint32_t xa[4], xb[4], xc[4], xd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xa[j] = lds32(box + x0 + (((2 * j) ^ sw0) << 4));
      xb[j] = lds32(box + x0 + (((2 * j + 1) ^ sw0) << 4));
      if (TWO) {
        xc[j] = lds32(box + x1 + (((2 * j) ^ sw1) << 4));
        xd[j] = lds32(box + x1 + (((2 * j + 1) ^ sw1) << 4));
      }
      ma[j] = lds4f(m + 32 * j);
      mb[j] = lds4f(m + 32 * j + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t(&f)[4] = fa[4 * e + j];
      f[0] = y2(xa[j], mu0, rs0, ma[j]) & m0;
      f[2] = y2(xb[j], mu0, rs0, mb[j]) & m0;
      f[1] = TWO ? y2(xc[j], mu1, rs1, ma[j]) & m1 : 0u;
      f[3] = TWO ? y2(xd[j], mu1, rs1, mb[j]) & m1 : 0u;
    }
  }

  __device__ __forceinline__ void frags(uint32_t (&fa)[8][4], int n, int i) const {
    const int turn = div_small(n, magic), st = n - turn * stages;
    mbar_wait(full + st, turn & 1);
    const uint32_t xs = ring + st * stage;
    if (any1) {
      frags4<true>(fa, xs, i, 0);
      frags4<true>(fa, xs, i, 1);
    } else {
      frags4<false>(fa, xs, i, 0);
      frags4<false>(fa, xs, i, 1);
    }
  }

  // slot n's eight k steps against its proj_down panel, committed as one group: even steps into acc[0], odd ones
  // into acc[1] (two dependent chains of wgmma)
  template <int W>
  __device__ __forceinline__ void products(float (&acc)[2][W / 2], uint32_t (&fa)[8][4], int n) const {
    const uint32_t pd = at(n) + 2 * xbytes;
    reg_fence(fa);
    reg_fence(acc[0]);
    reg_fence(acc[1]);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) RegA<W>::mma(acc[j & 1], fa[j], pd_desc<W>(pd, j));
    wg_commit();
  }

  template <int W>
  __device__ __forceinline__ void release(int n) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage_of(n));
    if (leader && n + stages < total) load_slot<W>(*p, *s, h, n + stages, row0, magic);
  }

  // slot n's products; once slot n - 1's are done (its stage is refilled, its fragments are free), slot n + 1's
  // fragments under them
  template <int W>
  __device__ __forceinline__ void step(float (&acc)[2][W / 2], uint32_t (&cur)[8][4], uint32_t (&nxt)[8][4], int n,
                                       int i, bool first) const {
    products<W>(acc, cur, n);
    wg_wait<1>();
    if (!first) release<W>(n - 1);
    frags(nxt, n + 1, i + 1);
  }

  // one round: this warpgroup's half of K (ch chunks) from ring slot n on: its even and its odd k steps' sums,
  // then their sum in acc[0]
  template <int W>
  __device__ __forceinline__ void sweep(float (&acc)[2][W / 2], int n) const {
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[0][e] = acc[1][e] = 0.f;
    uint32_t fa0[8][4], fa1[8][4];
    frags(fa0, n, 0);
    int i = 0;
#pragma unroll 1
    for (; i + 2 < ch; i += 2) {
      step<W>(acc, fa0, fa1, n + i, i, i == 0);
      step<W>(acc, fa1, fa0, n + i + 1, i + 1, false);
    }
    if (ch - i == 2) {
      step<W>(acc, fa0, fa1, n + i, i, i == 0);
      products<W>(acc, fa1, n + i + 1);
      wg_wait<0>();
      release<W>(n + i);
      release<W>(n + i + 1);
    } else {
      products<W>(acc, fa0, n + i);
      wg_wait<0>();
      if (i > 0) release<W>(n + i - 1);
      release<W>(n + i);
    }
    reg_fence(acc[0]);
    reg_fence(acc[1]);
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[0][e] = __fadd_rn(acc[0][e], acc[1][e]);
  }
};

template <int NV, bool DUAL, int W>
__global__ void __launch_bounds__(THREADS, 1) ln_mod_quant_kernel(const __grid_constant__ Params p) {
  constexpr int HEADS = DUAL ? 2 : 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const Smem s(sm, p, HEADS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / p.tpb, t = blockIdx.x % p.tpb;
  const int row0 = b * p.S + t * p.rows, nrows = min(p.rows, p.S - t * p.rows);

  const int ch = p.K / 256;
  const int total = ch * ((p.R[0] + W - 1) / W + (DUAL ? (p.R[1] + W - 1) / W : 0));  // ring slots of a launch
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * p.stages; ++i) {
      mbar_init(s.full + i, 1);
      mbar_init(s.empty + i, 4);  // a warpgroup's four warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  uint4 nxt[NV_MAX];  // the first row's vectors, loading under the staging
  if (warp < nrows) load_row<NV>(nxt, p, row0, warp, lane);
  const uint32_t magic = 0xFFFFFFFFu / p.stages + 1;
  if (threadIdx.x % WG == 0)  // each ring's first slots, loading under pass 1
    for (int n = 0; n < p.stages && n < total; ++n) load_slot<W>(p, s, threadIdx.x / WG, n, row0, magic);

  // the batch row's modulation (LayerNorm only: 1 + 0 and 0, which leave y as it is) and the heads' 1 / smooth,
  // once a block, every load first: pairs pr = t + 256 u, k = t + 256 u
  {
    const float* sc = p.sc == nullptr ? nullptr : p.sc + static_cast<size_t>(b) * p.ld;
    const float* sh = p.sh == nullptr ? nullptr : p.sh + static_cast<size_t>(b) * p.ld;
    float a[NV_MAX / 2][2], c[NV_MAX / 2][2], r[HEADS][NV_MAX];
#pragma unroll
    for (int u = 0; u < NV_MAX / 2; ++u) {
      const int pr = threadIdx.x + THREADS * u;
      if (pr >= p.K / 2) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        a[u][e] = sc == nullptr ? 0.f : sc[2 * pr + e];
        c[u][e] = sh == nullptr ? 0.f : sh[2 * pr + e];
      }
    }
#pragma unroll
    for (int u = 0; u < NV_MAX; ++u) {
      if (u >= p.nv) continue;
#pragma unroll
      for (int hd = 0; hd < HEADS; ++hd)
        r[hd][u] = p.smooth[hd] == nullptr ? 1.f : bf2f(p.smooth[hd][threadIdx.x + THREADS * u]);
    }
#pragma unroll
    for (int u = 0; u < NV_MAX / 2; ++u) {
      const int pr = threadIdx.x + THREADS * u;
      if (pr >= p.K / 2) continue;
      s.mp[pair_at(pr)] = make_float4(__fadd_rn(1.f, a[u][0]), __fadd_rn(1.f, a[u][1]), c[u][0], c[u][1]);
    }
#pragma unroll
    for (int u = 0; u < NV_MAX; ++u) {
      if (u >= p.nv) continue;
      const int k = threadIdx.x + THREADS * u;
#pragma unroll
      for (int hd = 0; hd < HEADS; ++hd)
        s.rs[hd * p.nv * RSTRIDE + rs_at(k)] = r[hd][u] == 0.f ? 1.f : __fdiv_rn(1.f, r[hd][u]);
    }
  }
  named_sync(1);

  row_pass<NV, DUAL>(p, s, nxt, row0, nrows, warp, lane);
  named_sync(2);  // mean and rstd of every row

  // pass 2: warpgroup h sweeps K half h of every round; lora_act = P0 + P1
  const int h = threadIdx.x / WG, wq = (threadIdx.x % WG) / 32, g = lane >> 2, t4 = lane & 3;
  const int rpw = (p.rows + 3) / 4;
  const int lr0 = rpw * wq + g, lr1 = lr0 + 8;
  Consumer c;
  c.p = &p;
  c.s = &s;
  c.row0 = row0;
  c.total = total;
  c.leader = threadIdx.x % WG == 0;
  c.ring = smem_u32(s.ring) + h * p.stages * p.stage;
  c.mp = smem_u32(s.mp);
  c.full = s.full + h * p.stages;
  c.empty = s.empty + h * p.stages;
  c.stages = p.stages;
  c.magic = magic;
  c.stage = p.stage;
  c.xbytes = p.xbytes;
  c.ch = ch;
  c.h = h;
  c.lane = lane;
  c.t4 = t4;
  const bool ok0 = g < rpw && lr0 < nrows, ok1 = g + 8 < rpw && lr1 < nrows;
  c.m0 = ok0 ? ~0u : 0u;
  c.m1 = ok1 ? ~0u : 0u;
  c.any1 = rpw > 8 && rpw * wq + 8 < nrows;
  const int cl0 = min(lr0, p.rows - 1), cl1 = min(lr1, p.rows - 1);
  c.x0 = cl0 * 128 + 4 * t4;
  c.x1 = cl1 * 128 + 4 * t4;
  c.sw0 = cl0 & 7;
  c.sw1 = cl1 & 7;
  c.mu0 = ok0 ? s.mu[lr0] : 0.f;
  c.rs0 = ok0 ? s.rstd[lr0] : 0.f;
  c.mu1 = ok1 ? s.mu[lr1] : 0.f;
  c.rs1 = ok1 ? s.rstd[lr1] : 0.f;

  int n = 0;
  for_rounds<DUAL, W>(p, [&](int head, int c0) {
    float acc2[2][W / 2];
    c.sweep<W>(acc2, n);
    n += c.ch;
    const float(&acc)[W / 2] = acc2[0];
    const int ld = p.R[head], rc = min(W, ld - c0);
    float* la0 = p.la[head] + static_cast<size_t>(row0 + lr0) * ld + c0 + 2 * t4;
    float* la1 = la0 + static_cast<size_t>(8) * ld;
    if (h == 1) {  // the upper half's sums, to be added by warpgroup 0
#pragma unroll
      for (int jn = 0; jn < W / 8; ++jn) {
        if (8 * jn >= rc) continue;
        if (ok0) *reinterpret_cast<float2*>(la0 + 8 * jn) = make_float2(acc[4 * jn], acc[4 * jn + 1]);
        if (ok1) *reinterpret_cast<float2*>(la1 + 8 * jn) = make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
      }
    }
    named_sync(3);
    if (h == 0) {
#pragma unroll
      for (int jn = 0; jn < W / 8; ++jn) {
        if (8 * jn >= rc) continue;
        if (ok0) {
          const float2 u = *reinterpret_cast<const float2*>(la0 + 8 * jn);
          *reinterpret_cast<float2*>(la0 + 8 * jn) =
              make_float2(__fadd_rn(acc[4 * jn], u.x), __fadd_rn(acc[4 * jn + 1], u.y));
        }
        if (ok1) {
          const float2 u = *reinterpret_cast<const float2*>(la1 + 8 * jn);
          *reinterpret_cast<float2*>(la1 + 8 * jn) =
              make_float2(__fadd_rn(acc[4 * jn + 2], u.x), __fadd_rn(acc[4 * jn + 3], u.y));
        }
      }
    }
  });
}

template <int NV, bool DUAL, int W>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(ln_mod_quant_kernel<NV, DUAL, W>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ln_mod_quant_kernel<NV, DUAL, W><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// K 3072 (FLUX.1-dev's, Qwen-Image's width) with its vector count fixed at compile time; other K at run time
template <bool DUAL, int W>
int launch_k(const Params& p, int grid, int smem, cudaStream_t stream) {
  return p.nv == NV_MAX ? launch<NV_MAX, DUAL, W>(p, grid, smem, stream) : launch<0, DUAL, W>(p, grid, smem, stream);
}

// The tile (about one a SM, 8 to 64 rows of one batch row), the ring, the tensor maps; then the launch at the
// width the larger rank takes (32, or rounds of 64).
template <bool DUAL>
int run(Params& p, const void* pd0, const void* pd1, cudaStream_t stream) {
  if (p.M == 0) return 0;
  const int heads = DUAL ? 2 : 1, batches = p.M / p.S;
  int rows = (p.M + sm_count() - 1) / sm_count();
  rows = rows < MIN_ROWS ? MIN_ROWS : (rows > MAX_ROWS ? MAX_ROWS : rows);
  p.rows = rows < p.S ? rows : p.S;
  p.tpb = (p.S + p.rows - 1) / p.rows;
  const int rmax = DUAL && p.R[1] > p.R[0] ? p.R[1] : p.R[0];
  const int w = rmax <= 32 ? 32 : 64;
  p.xbytes = (p.rows * 128 + 1023) / 1024 * 1024;
  p.stage = 2 * p.xbytes + panel_bytes(w);
  p.stages = MAX_STAGES;
  while (p.stages > 2 && smem_bytes(p.nv, p.stages, p.stage, heads) > MAX_SMEM) --p.stages;
  const int smem = smem_bytes(p.nv, p.stages, p.stage, heads);
  const auto B16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(p.K), static_cast<cuuint64_t>(p.M)};
  const cuuint64_t x_str[1] = {2 * static_cast<cuuint64_t>(p.K)};
  const cuuint32_t x_box[2] = {64, static_cast<cuuint32_t>(p.rows)};
  bool ok = tensor_map(&p.xmap, B16, 2, p.x, x_dims, x_str, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const void* pd[2] = {pd0, pd1};
  for (int hd = 0; hd < heads && ok; ++hd) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.R[hd]), static_cast<cuuint64_t>(p.K)};
    const cuuint64_t str[1] = {2 * static_cast<cuuint64_t>(p.R[hd])};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(w), KC};
    ok = tensor_map(&p.pmap[hd], B16, 2, pd[hd], dims, str, box,
                    w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok || smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = batches * p.tpb;
  return w == 32 ? launch_k<DUAL, 32>(p, grid, smem, stream) : launch_k<DUAL, 64>(p, grid, smem, stream);
}

// The rank step of the low-rank product: R a multiple of 16.
bool rank_ok(int R) { return R >= 16 && R % 16 == 0; }

}  // namespace

// x (M, K) bf16 (M = B*S rows of a (B, S, K) stream), mod scale / shift:
// rows of ld floats, row b = batch b, or both null (LayerNorm only),
// smooth (K,) bf16 | null, proj_down (K, R) bf16
// -> q (M, K) int8, ascales (M,) f32, lora_act (M, R) f32.
// Needs K % 256 == 0, K <= 3072, R a multiple of 16, M a multiple of S,
// x and proj_down 16-byte aligned.
extern "C" int nt_ln_mod_quant(const void* x, const void* mod_scale, const void* mod_shift, int ld,
                               const void* smooth, const void* proj_down, void* q, void* ascales,
                               void* lora_act, int M, int S, int K, int R, void* stream) {
  if (K % 256 != 0 || K / 256 > NV_MAX || !rank_ok(R) || S <= 0 || M % S != 0 || !aligned16(x) ||
      !aligned16(proj_down))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.sc = static_cast<const float*>(mod_scale);
  p.sh = static_cast<const float*>(mod_shift);
  p.smooth[0] = static_cast<const bf16*>(smooth);
  p.q[0] = static_cast<int8_t*>(q);
  p.asc[0] = static_cast<float*>(ascales);
  p.la[0] = static_cast<float*>(lora_act);
  p.R[0] = R;
  p.ld = ld;
  p.M = M;
  p.S = S;
  p.K = K;
  p.nv = K / 256;
  return run<false>(p, proj_down, nullptr, static_cast<cudaStream_t>(stream));
}

// The dual mode: x and the modulation as above (both required), then two
// heads, each smooth (K,) bf16 | null and proj_down (K, R) bf16 -> q (M, K)
// int8, ascales (M,) f32, lora_act (M, R) f32. Needs K % 256 == 0, K <= 3072,
// each R a multiple of 16.
extern "C" int nt_ln_mod_quant_dual(const void* x, const void* mod_scale, const void* mod_shift, int ld,
                                    const void* smooth_a, const void* proj_down_a, void* q_a, void* ascales_a,
                                    void* lora_a, const void* smooth_b, const void* proj_down_b, void* q_b,
                                    void* ascales_b, void* lora_b, int M, int S, int K, int Ra, int Rb,
                                    void* stream) {
  if (K % 256 != 0 || K / 256 > NV_MAX || !rank_ok(Ra) || !rank_ok(Rb) || mod_scale == nullptr ||
      mod_shift == nullptr || S <= 0 || M % S != 0 || !aligned16(x) || !aligned16(proj_down_a) ||
      !aligned16(proj_down_b))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = static_cast<const bf16*>(x);
  p.sc = static_cast<const float*>(mod_scale);
  p.sh = static_cast<const float*>(mod_shift);
  p.smooth[0] = static_cast<const bf16*>(smooth_a);
  p.smooth[1] = static_cast<const bf16*>(smooth_b);
  p.q[0] = static_cast<int8_t*>(q_a);
  p.q[1] = static_cast<int8_t*>(q_b);
  p.asc[0] = static_cast<float*>(ascales_a);
  p.asc[1] = static_cast<float*>(ascales_b);
  p.la[0] = static_cast<float*>(lora_a);
  p.la[1] = static_cast<float*>(lora_b);
  p.R[0] = Ra;
  p.R[1] = Rb;
  p.ld = ld;
  p.M = M;
  p.S = S;
  p.K = K;
  p.nv = K / 256;
  return run<true>(p, proj_down_a, proj_down_b, static_cast<cudaStream_t>(stream));
}
