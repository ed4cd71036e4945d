// The fc1 GEMM with the GELU -> requantize epilogue, pipelined: each 128-column
// tile's epilogue runs while the next tile's products run.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w8a8_gelu_quant_pipe_kernel (:790,
// launched by _gelu_quant_pipelined :1602, which svdq_gemm_w8a8_gelu_quant
// takes for pipelined=True when K is its whole int8 K tile and the weight is
// not stacked, :1365-1378). The TPU kernel runs the N-tile grid axis one
// step long: cell j issues tile j's MXU product into acc[j % 2] and, in the
// same body, tile j - 1's VPU epilogue out of acc[(j - 1) % 2], so the VLIW
// scheduler may overlap them. Its outputs are the plain chain kernel's bit
// for bit, and so are this kernel's: those of gemm_w8a8_gelu_quant.cu (row
// 2) on the same inputs.
//   out = i32(qact @ w) * ascale[m] * wscale[n] + bf16(lora_act) @ proj_up + bias
//   g = tanh-GELU(out);  lora_next = sum over 128-column tiles, in ascending
//   order, of bf16(g tile) @ proj_down_next rows;  h = (g [+ 0.171875]) *
//   rsmooth_next;  one int8 scale per (token, bn-column group):
//   scale = max|h| * f32(1/127), q = clip(round_half_even(h * rcp(scale)), +-127)
//
// Bound on the H100: operations (2*M*N*K int8; at FLUX fc1, M 4608, K 3072,
// N 12288, 348 GOP on 57 MB of operands, far above the int8 ridge).
//
// Design: a handover between two teams of one block, the Hopper form of the
// lagged acc[2]; then row 2's requantize kernel (gelu_requant.cuh).
//   - Tiles: the (M / 128) x (N / 128) output tiles, row-block-major, cut
//     into one equal contiguous share a block, one block an SM (persistent):
//     a block's tiles may start or end inside a scale group, as kernel B
//     takes each group's max from the per-tile maxima. (One block a group,
//     288 of them at FLUX fc1, ran 2.18 waves as 3.)
//   - Products: warpgroups 0 and 1 run row 2's s8 main loop (gemm_sm90.cuh:
//     TmaS8 brings the A and W K tiles into a 3-stage ring, wgmma m64n128k32
//     s8 into 64 s32 accumulators a thread, 64 rows a warpgroup); the first
//     thread issues the copies, ST K tiles ahead, across tile boundaries. At
//     a tile's end they store the accumulators into one shared s32 tile and
//     start the next tile at once.
//   - Epilogue: warpgroups 2 and 3 run row 2's epilogue operations in its
//     order on that tile (GeluEpi in gemm_w8a8_gelu_quant.cu): the scales,
//     the rank-R sums (an FMA chain over the ranks in order for each output,
//     bf16(lora_act) and proj_up staged 32 ranks at a time into
//     int8_gemm.cuh's low-rank tiles, the first while the products run), the
//     bias, the GELU, the tile's row maxima, g to the device workspace and
//     bf16(g) to a shared tile, and the tile's rank-R2 partial bf16(g) @
//     proj_down on the tensor cores (WMMA, 16 rows a warp, 32 proj_down
//     columns at a time). A thread takes row 2's 4 x 16 block of a tile, one
//     8-column half at a time (both halves at once spilled at 128 registers).
//   - Two named barriers hand the tile over (FULL: the products are stored;
//     EMPTY: the epilogue has read them), so tile t's epilogue runs under
//     tile t + 1's products.
//   - The team is read through a warp shuffle: wgmma under a branch ptxas
//     takes for divergent is serialized (C7518).
// So every output is row 2's bit for bit: the same kernel B on the same
// workspace, written by the same operations in the same order.
// Registers: 512 threads cap ptxas at 128 a thread. Shared memory: the ring
// 96 KB, the handed tile 66 KB, the low-rank tiles 18 KB, the g tile 34 KB,
// the proj_down columns 10 KB (225 KB at every rank); the ring is a stage
// shorter than row 2's, as the handed tile has to live beside it.
// Measured (PERF.md row 14): no faster than row 2's serial epilogue. Alone,
// the epilogue team takes longer a tile than the products (it is half the
// block's threads at 128 registers), and the two teams share the SM.
#include "gelu_requant.cuh"
#include "gemm_sm90.cuh"
#include "int8_gemm.cuh"

namespace {

using namespace sm90;

constexpr int BM = gemm90::BM, BN = 128, ST = 3;
constexpr int MMA_THREADS = 2 * WG, EPI_THREADS = 2 * WG, THREADS = MMA_THREADS + EPI_THREADS;
constexpr int STAGE = gemm90::Tiles<BN>::BYTES;  // an A tile and a W tile of one K tile
constexpr int LDA = BN + 4;                      // int row stride of the handed tile
constexpr int LDG = BN + 8;                      // bf16 row stride of the g tile
constexpr int RC = 32;                           // ranks of lora_act and proj_up staged at a time
constexpr int PC = 32;                           // proj_down columns staged at a time
constexpr int LDP = PC + 8;                      // bf16 row stride of the proj_down tile
// named barriers (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 2, BAR_EPI = 3;
using Src = gemm90::TmaS8<BN>;

// Dynamic shared memory, from the 1024-byte aligned base: ring | handed tile [BM][LDA] s32 | the low-rank tiles
// of RC ranks (int8_gemm.cuh LoraRows) | g tile [BM][LDG] bf16 | proj_down tile [BN][LDP] bf16 | the ring's full
// and empty barriers
struct Layout {
  static constexpr int AT = ST * STAGE;
  static constexpr int LORA = AT + BM * LDA * 4;
  static constexpr int G = LORA + static_cast<int>(i8gemm::lora_rows_bytes(RC));
  static constexpr int PD = G + BM * LDG * 2;
  static constexpr int BARS = PD + BN * LDP * 2;
  static constexpr int SMEM = BARS + 16 * ST + 1024;
};
static_assert(Layout::SMEM <= gemm90::MAX_SMEM, "the H100's 227 KB a block");

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
  int M, N, K, R, R2;
  float shift;
};

__host__ __device__ constexpr int round16(int r) { return (r + 15) / 16 * 16; }

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// s[8 q + i] = fmaf(bf16(lora_act[r0 + q, j]), proj_up[j, c + i], s[8 q + i]) over the staged chunk's ranks j
// in order: int8_gemm.cuh lora_sums_4x16 (row 2's rank sums) for one 4 x 8 half of its block
__device__ __forceinline__ void lora_sums_4x8(const i8gemm::LoraRows& lr, float (&s)[32], int r0, int c) {
  auto rank = [&](int j, const float (&a)[4]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(lr.pu + j * BN + c);
    const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[8 * q + i] = fmaf(a[q], bf2f(p[i]), s[8 * q + i]);
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

// proj_down_next rows n0 .. n0 + 127, columns p0 .. p0 + PC - 1 (zeros past R2) into the tile, by the epilogue
// threads: 16-byte copies when a row's R2 bf16 are 16-byte aligned
__device__ __forceinline__ void stage_pd(const Params& e, bf16* pdt, int p0, int n0, int et) {
  const int R2 = e.R2;
  if (R2 % 8 == 0) {
    for (int i = et; i < BN * (PC / 8); i += EPI_THREADS) {
      const int c = i / (PC / 8), q = i % (PC / 8);
      cp_async16(pdt + c * LDP + 8 * q, e.pd + static_cast<size_t>(n0 + c) * R2 + p0 + 8 * q, p0 + 8 * q < R2);
    }
  } else {
    for (int i = et; i < BN * PC; i += EPI_THREADS) {
      const int c = i / PC, r = i % PC;
      pdt[c * LDP + r] = p0 + r < R2 ? e.pd[static_cast<size_t>(n0 + c) * R2 + p0 + r] : __float2bfloat16(0.f);
    }
  }
  cp_async_commit();
}

// The epilogue team (warpgroups 2 and 3): row 2's thread tile, rows r0 .. r0 + 3 and columns c0 .. c0 + 7 and
// c0 + 64 .. c0 + 71 of each of the block's tiles g_begin .. g_end - 1 (row-block-major).
__device__ __forceinline__ void epilogue_team(const Params& e, unsigned char* sm, int g_begin, int g_end) {
  const int* at = reinterpret_cast<const int*>(sm + Layout::AT);
  const i8gemm::LoraRows lora = i8gemm::lora_rows(sm + Layout::LORA, RC);
  bf16* gt = reinterpret_cast<bf16*>(sm + Layout::G);
  bf16* pdt = reinterpret_cast<bf16*>(sm + Layout::PD);
  const int et = threadIdx.x - MMA_THREADS, ewarp = et / 32;
  const int M = e.M, N = e.N, R = e.R, R2p = round16(e.R2), NT = N / BN;
  const int r0 = (et >> 5) * 16 + ((et >> 3) & 3) * 4, c0 = (et & 7) * 8;
  auto epi_sync = [] { bar_sync(BAR_EPI, EPI_THREADS); };
  // ranks j0 .. j0 + RC - 1 of bf16(lora_act) rows m0.. and proj_up columns n0.. into the low-rank tiles
  auto stage_lora = [&](int j0, int m0, int n0) {
    i8gemm::LoraRows lr = lora;
    lr.R = R - j0 < RC ? R - j0 : RC;
    i8gemm::stage_lora_rows(lr, e.la + j0, R, e.pu + static_cast<size_t>(j0) * N, m0, n0, N, M, et, EPI_THREADS);
  };
  for (int gi = g_begin; gi < g_end; ++gi) {
    const int m0 = gi / NT * BM, tile = gi % NT, n0 = tile * BN;
    // the first ranks and proj_down columns, while the products run
    if (R > 0) stage_lora(0, m0, n0);
    stage_pd(e, pdt, 0, n0, et);
    cp_async_wait<0>();
    epi_sync();
    bar_sync(BAR_FULL, THREADS);  // the tile is in the handed tile
    float hm[4] = {0.f, 0.f, 0.f, 0.f};  // max|h| over the thread's columns of each row
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int nl = c0 + 64 * h, n = n0 + nl;
      float s[32];  // the half's rank-R sums, s[8 q + k], over every rank in order
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      for (int j0 = 0; j0 < R; j0 += RC) {
        if (j0 > 0 || (h > 0 && R > RC)) {  // the next ranks (the second half from the first again)
          epi_sync();  // every thread has read the previous ones
          stage_lora(j0, m0, n0);
          cp_async_wait<0>();
          epi_sync();
        }
        i8gemm::LoraRows lr = lora;
        lr.R = R - j0 < RC ? R - j0 : RC;
        lora_sums_4x8(lr, s, r0, nl);
      }
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
        const float a = __ldg(e.as + m);
#pragma unroll
        for (int k = 0; k < 8; ++k) out[k] = __fmul_rn(__fmul_rn(static_cast<float>(v[k]), a), w[k]);
        if (R > 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) out[k] = __fadd_rn(out[k], s[8 * q + k]);
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
    if (gi + 1 < g_end) bar_arrive(BAR_EMPTY, THREADS);  // the products may store the next tile
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // max|h| over the row's 128 columns: the eight column blocks of its threads
#pragma unroll
      for (int d = 1; d < 8; d <<= 1) hm[q] = fmaxf(hm[q], __shfl_xor_sync(0xffffffffu, hm[q], d));
      if ((et & 7) == 0) e.amax_part[static_cast<size_t>(tile) * M + m0 + r0 + q] = hm[q];
    }
    epi_sync();  // the g tile is complete

    // the tile's low-rank partial, row 2's product: bf16(g)[16 rows of this warp, 128] @ pd[128, R2p], 32
    // columns (two accumulators) at a time, each partial column its own sum
    namespace wmma = nvcuda::wmma;
    float* dst = e.lora_part + (static_cast<size_t>(tile) * M + m0 + ewarp * 16) * R2p;
    for (int j0 = 0; j0 < R2p; j0 += PC) {
      if (j0 > 0) {  // the next columns of proj_down through the same tile
        epi_sync();  // every warp has read the previous columns
        stage_pd(e, pdt, j0, n0, et);
        cp_async_wait<0>();
        epi_sync();
      }
      const int nf = R2p - j0 >= 32 ? 2 : 1;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> lp[2];
      wmma::fill_fragment(lp[0], 0.f);
      wmma::fill_fragment(lp[1], 0.f);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
        wmma::load_matrix_sync(ga, &gt[(ewarp * 16) * LDG + kk * 16], LDG);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j < nf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> pb;
            wmma::load_matrix_sync(pb, &pdt[(kk * 16) * LDP + j * 16], LDP);
            wmma::mma_sync(lp[j], ga, pb, lp[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nf) wmma::store_matrix_sync(dst + j0 + j * 16, lp[j], R2p, wmma::mem_row_major);
    }
    epi_sync();  // the tiles may be written again

  }
}

__global__ void __launch_bounds__(THREADS, 1)
    gemm_gelu_pipe_kernel(const __grid_constant__ Src::Params p, const __grid_constant__ Params e) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Layout::BARS);
  uint64_t* empty = full + ST;
  int* at = reinterpret_cast<int*>(sm + Layout::AT);
  // this block's tiles: an equal share of the (M / 128) x (N / 128) tiles, row-block-major
  const int NT = e.N / BN, all = e.M / BM * NT;
  const int g_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * all / gridDim.x);
  const int g_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * all / gridDim.x), tiles = g_end - g_begin;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the product team's eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the team, uniform across each warp as the compiler sees it (wgmma issued under a branch the compiler takes
  // for divergent is serialized: ptxas C7518)
  const int team = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / MMA_THREADS, 0);
  if (team == 1) {
    epilogue_team(e, sm, g_begin, g_end);
    return;
  }

  // ---- the product team: 64 rows a warpgroup; its first thread copies ----
  const int cw = threadIdx.x / WG, warp = (threadIdx.x % WG) / 32;
  const int tpg = Src::group_tiles(p, e.K), T = tiles * tpg;  // K tiles of a tile, of the block
  auto load = [&](int c) {  // the block's K tile c: K tile c % tpg of its tile c / tpg
    const int s = c % ST, gi = g_begin + c / tpg;
    Src::load(p, sm + s * STAGE, full + s, gi / NT * BM, gi % NT * BN, c % tpg);
  };
  auto release = [&](int c) {  // K tile c's products are done: its stage takes K tile c + ST
    if (lane == 0) mbar_arrive(empty + c % ST);
    if (threadIdx.x == 0 && c + ST < T) {
      mbar_wait(empty + c % ST, (c / ST) & 1);
      load(c + ST);
    }
  };
  if (threadIdx.x == 0) {
    for (int c = 0; c < ST && c < T; ++c) load(c);
  }
  const int r = cw * 64 + warp * 16 + (lane >> 2), cc = 2 * (lane & 3);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int c = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int i = 0; i < tpg; ++i, ++c) {
      const int s = c % ST;
      mbar_wait(full + s, (c / ST) & 1);
      const unsigned char* a = sm + s * STAGE + cw * 64 * 128;
      const unsigned char* w = sm + s * STAGE + gemm90::A_TILE;
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < gemm90::S8::BK / gemm90::S8::K_STEP; ++kk)  // a tile's first k step overwrites
        gemm90::S8::mma<BN>(acc, sw128_desc(a + kk * 32), gemm90::S8::w_desc(w, kk), i > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();  // K tile c - 1's products are done
      if (i > 0) release(c - 1);
    }
    wg_wait<0>();
    reg_fence(acc);
    release(c - 1);
    if (t > 0) bar_sync(BAR_EMPTY, THREADS);  // the epilogue has read tile t - 1
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {  // rows r and r + 8, columns 8 j + cc (+1)
      *reinterpret_cast<int2*>(at + r * LDA + 8 * j + cc) = make_int2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<int2*>(at + (r + 8) * LDA + 8 * j + cc) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    bar_arrive(BAR_FULL, THREADS);  // tile t is in the handed tile
  }
}

}  // namespace

// qact (M, K) int8, ascales (M,) f32, wt (N, K) int8 (the (K, N) weight
// K-contiguous), wscales (N,) f32, lora_act (M, R) f32 | null, proj_up (R, N)
// bf16 | null, bias (N,) bf16 | null, rsmooth_next (N,) f32, proj_down_next
// (N, R2) bf16; workspaces gbuf (M, N) f32, lora_part (N/128, M, R2p) f32 with
// R2p = R2 rounded up to 16, amax_part (N/128, M) f32
// -> qout (M, N) int8, qscales (N/bn, M) f32, lora_next (M, R2) f32.
// Needs M % 128 == 0, bn % 128 == 0, bn <= 1536, N % bn == 0, K % 64 == 0, R2 >= 1 (any R, R2).
extern "C" int nt_gemm_w8a8_gelu_quant_pipe(const void* qact, const void* ascales, const void* wt,
                                            const void* wscales, const void* lora_act, const void* proj_up,
                                            const void* bias, const void* rsmooth, const void* proj_down,
                                            void* gbuf, void* amax_part, void* lora_part, void* qout, void* qscales,
                                            void* lora_next, int M, int N, int K, int R, int R2, int bn,
                                            float shift, void* stream) {
  if (M % BM || bn % BN || bn < BN || bn > 1536 || N % bn || N / bn > MAX_GROUPS || K % 64 || K <= 0 || R < 0 ||
      R2 < 1 || (R > 0 && (lora_act == nullptr || proj_up == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Src::Params p;
  if (!Src::maps(p, qact, wt, M, N, K, 1, nullptr, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Params e{static_cast<const float*>(ascales), static_cast<const float*>(wscales),
                 static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
                 static_cast<const bf16*>(bias), static_cast<const float*>(rsmooth),
                 static_cast<const bf16*>(proj_down), static_cast<float*>(gbuf), static_cast<float*>(amax_part),
                 static_cast<float*>(lora_part), M, N, K, lora_act == nullptr ? 0 : R, R2, shift};
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(gemm_gelu_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int all = M / BM * (N / BN), grid = all < sm_count() ? all : sm_count();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gemm_gelu_pipe_kernel<<<grid, THREADS, Layout::SMEM, s>>>(p, e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return requant(gbuf, rsmooth, amax_part, lora_part, qout, qscales, lora_next, M, N, R2, bn, shift, s);
}
