// The fc1 GEMM with the GELU -> requantize epilogue, software-pipelined:
// one N tile's tensor-core product overlaps the previous tile's epilogue.
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
// Design: warp specialisation, the Hopper form of the lagged acc[2]. A block
// owns 128 rows and one bn-wide scale group (grid: N / bn x M / 128) and
// walks the group's 128-column tiles in order. Its first eight warps run the
// main loop of int8_gemm.cuh (WMMA s8, the two-stage cp.async ring, synced by
// a named barrier of their own) into registers; the accumulators of a tile
// pass through one shared int32 tile to four epilogue warps. While those run
// tile t - 1's epilogue (scales, the rank-R up-projection, bias, GELU, the
// row max, bf16(g) into shared memory and the tile's rank-R2 partial on the
// tensor cores), the main-loop warps already compute tile t in their
// registers: the registers are the second accumulator set, so one shared
// tile suffices. Two named barriers hand the tile over (FULL: the main-loop
// warps have stored it; EMPTY: the epilogue warps have read it).
//
// What stays as in row 2, and why. The group's scale needs max|h| over bn =
// 1536 columns before any of them is quantized. The block's f32 g of one
// group is 128 x 1536 x 4 B = 768 KB, more than an SM's 227 KB; holding it
// in shared memory would take 32-row blocks (192 KB), each weight stripe
// read again M / 32 times (5.4 GB from L2 at FLUX fc1, against 1.4 GB at 128
// rows) and a 32-row WMMA tile. So g goes to a device-memory workspace as in
// row 2, and the epilogue warps quantize the group at its end, each lane
// reading back exactly the values it wrote (no fence needed); row 2's second
// kernel is gone. The low-rank partials of every tile go to a workspace as in
// row 2; the last block of a row block to finish (an atomic count per row
// block) sums them over all N / 128 tiles in ascending order, row 2's order.
// The shared memory holds the main loop's ring, the handed-over tile, the
// bf16(g) tile, the proj_down tile and bf16(lora_act) of the block's rows
// side by side: 151 KB at R = R2 = 32, 199 KB at 128 and above (a wider rank
// runs in chunks of 128 through the same tiles: the lora_act rows of each
// chunk restaged by the warp that reads them, proj_down's columns by the
// epilogue warps), one block a SM. The
// grid is then N / bn x M / 128 equal blocks: at FLUX fc1 288 of them, 2.18
// waves of 132 run as 3, which costs more than the overlap gains there; at
// whole waves (M 4224, 8448) the kernel is within 10% of row 2 (PERF.md). A
// three-stage ring measured the same as this two-stage one.
//
// The rank-R up-projection keeps row 2's arithmetic, a chain of FMAs over j
// in order for each output (not a tensor-core product, whose sums would
// round otherwise), so it is CUDA-core work of 2 R operations an element.
// A lane forms it for 8 rows at a time: each 16-byte row of bf16(lora_act)
// (8 rows at one j, staged once per block) and each 8-byte proj_up load (4
// columns at one j, from the cache) feed 32 FMAs. The first version read
// both per element and per j from the cache, and its epilogue, not the main
// loop, set the pace (PERF.md, row 14).
#include "int8_gemm.cuh"

namespace {

using namespace i8gemm;

constexpr int MMA_THREADS = THREADS;  // the main loop's eight warps (int8_gemm.cuh's 128 x 128 tile)
constexpr int EPI_WARPS = 4, EPI_THREADS = EPI_WARPS * 32;
constexpr int PIPE_THREADS = MMA_THREADS + EPI_THREADS;
constexpr int EPI_ROWS = BM / EPI_WARPS;  // rows of the tile each epilogue warp owns
constexpr int ROW_CHUNK = 8;              // rows whose low-rank terms an epilogue lane forms together
constexpr int MAX_TILES = 1536 / BN;      // 128-column tiles of the widest scale group (chain_tile_n)
constexpr int LDACC = BN + 4;             // int32 row stride of the handed-over tile
constexpr int LDG = BN + 8;               // bf16 row stride of the g tile
// named barriers (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 2, BAR_MMA = 3, BAR_EPI = 4;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

struct MmaSync {  // the main loop's barrier: its eight warps only
  __device__ __forceinline__ void operator()() const { bar_sync(BAR_MMA, MMA_THREADS); }
};

__host__ __device__ constexpr int round16(int r) { return (r + 15) / 16 * 16; }

// Dynamic shared memory: ring | acc [BM][LDACC] int | g tile [BM][LDG] bf16 |
// pd tile [BN][R2p + 8] bf16 | bf16(lora_act) [R][BM] | row max [BM] f32 |
// last-block flag
struct PipeLayout {
  size_t acc, g, pd, la, rmax, flag, total;
};

// the proj_down tile's columns and the lora_act tile's ranks: one chunk of at most RANK_CHUNK
__host__ __device__ constexpr int pd_cols(int R2) { return lora_chunk(round16(R2)); }

__host__ __device__ inline PipeLayout pipe_layout(int R, int R2) {
  PipeLayout l{};
  l.acc = align128(2 * sizeof(Stage));
  l.g = l.acc + align128(static_cast<size_t>(BM) * LDACC * sizeof(int));
  l.pd = l.g + align128(static_cast<size_t>(BM) * LDG * sizeof(bf16));
  l.la = l.pd + align128(static_cast<size_t>(BN) * (pd_cols(R2) + 8) * sizeof(bf16));
  l.rmax = l.la + align128(static_cast<size_t>(lora_chunk(R)) * BM * sizeof(bf16));
  l.flag = l.rmax + align128(BM * sizeof(float));
  l.total = l.flag + 128;
  return l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load4(float (&d)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

__global__ void __launch_bounds__(PIPE_THREADS, 1)
    gemm_gelu_pipe_kernel(const int8_t* __restrict__ qa, const float* __restrict__ as, WeightI8 w,
                          const float* __restrict__ ws, const float* __restrict__ la,
                          const bf16* __restrict__ pu, const bf16* __restrict__ bias,
                          const float* __restrict__ rsm, const bf16* __restrict__ pd, float* __restrict__ g,
                          float* __restrict__ lora_part, int* __restrict__ done, int8_t* __restrict__ qout,
                          float* __restrict__ qscales, float* __restrict__ lora_next, int M, int N, int K, int R,
                          int R2, int bn, float shift) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const PipeLayout L = pipe_layout(R, R2);
  const int R2p = round16(R2), PC = pd_cols(R2), LDP = PC + 8;
  int* acc_s = reinterpret_cast<int*>(smem_raw + L.acc);
  const int m0 = blockIdx.y * BM, group = blockIdx.x, n_first = group * bn, tiles = bn / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp < MMA_THREADS / 32) {  // the main-loop warps: tile t's product, then hand it over
    auto* ring = reinterpret_cast<Stage*>(smem_raw);
    const int wm = warp / 4, wn = warp % 4;
    for (int t = 0; t < tiles; ++t) {
      AccFrag acc[FM][FN];
      zero(acc);
      mainloop(ring, acc, qa, w, m0, n_first + t * BN, 0, K, K, MmaSync{});
      if (t > 0) bar_sync(BAR_EMPTY, PIPE_THREADS);  // the epilogue warps have read tile t - 1
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
          wmma::store_matrix_sync(acc_s + (wm * WM + fm * 16) * LDACC + wn * WN + fn * 16, acc[fm][fn], LDACC,
                                  wmma::mem_row_major);
      bar_arrive(BAR_FULL, PIPE_THREADS);
    }
    return;
  }

  // the epilogue warps: warp ew owns rows ew * 32 .. + 31 of the block, lane the 4 columns lane * 4 of a tile
  bf16* gt = reinterpret_cast<bf16*>(smem_raw + L.g);    // [BM][LDG]: bf16(g) of the tile
  bf16* pdt = reinterpret_cast<bf16*>(smem_raw + L.pd);  // [BN][LDP]: proj_down_next rows of the tile
  bf16* la_s = reinterpret_cast<bf16*>(smem_raw + L.la);  // [RC][BM]: bf16(lora_act) of the block's rows
  float* rmax = reinterpret_cast<float*>(smem_raw + L.rmax);
  int* last = reinterpret_cast<int*>(smem_raw + L.flag);
  const int ew = warp - MMA_THREADS / 32, et = threadIdx.x - MMA_THREADS;
  const int row_first = ew * EPI_ROWS, c0 = lane * 4;
  rmax[row_first + lane] = 0.f;
  if (R <= RANK_CHUNK) {
    for (int i = et; i < R * BM; i += EPI_THREADS)  // the same rows for every tile: staged once
      la_s[i] = __float2bfloat16(la[static_cast<size_t>(m0 + i % BM) * R + i / BM]);
  }
  bar_sync(BAR_EPI, EPI_THREADS);
  for (int t = 0; t < tiles; ++t) {
    const int n0 = n_first + t * BN, n = n0 + c0;
    for (int i = et; i < BN * PC; i += EPI_THREADS) {  // the first PC columns
      const int c = i / PC, r = i % PC;
      pdt[c * LDP + r] = r < R2 ? pd[static_cast<size_t>(n0 + c) * R2 + r] : __float2bfloat16(0.f);
    }
    float wsv[4], rsv[4], bv[4] = {0.f, 0.f, 0.f, 0.f};
    load4(wsv, ws + n);
    load4(rsv, rsm + n);
    if (bias != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = bf2f(bias[n + i]);
    }
    bar_sync(BAR_FULL, PIPE_THREADS);  // tile t's accumulators are in acc_s
    for (int r0 = 0; r0 < EPI_ROWS; r0 += ROW_CHUNK) {
      // bf16(lora_act[m]) . proj_up[:, n..n+3] for ROW_CHUNK rows: row 2's chain of FMAs over j in order,
      // each proj_up load and each 16-byte row of lora_act shared by 32 FMAs. Above RANK_CHUNK ranks the
      // chunks run one after another, the warp restaging its ROW_CHUNK rows of each through the same tile.
      float lo[ROW_CHUNK][4] = {};
      for (int j0 = 0; j0 < R; j0 += RANK_CHUNK) {
        const int rc = lora_chunk(R - j0);
        if (R > RANK_CHUNK) {
          __syncwarp();  // the previous chunk is read
          for (int i = lane; i < rc * ROW_CHUNK; i += 32) {
            const int j = i / ROW_CHUNK, ml = row_first + r0 + i % ROW_CHUNK;
            la_s[j * BM + ml] = __float2bfloat16(la[static_cast<size_t>(m0 + ml) * R + j0 + j]);
          }
          __syncwarp();
        }
#pragma unroll 4
        for (int j = 0; j < rc; ++j) {
          const uint4 araw = *reinterpret_cast<const uint4*>(la_s + j * BM + row_first + r0);
          const uint2 praw = __ldg(reinterpret_cast<const uint2*>(pu + static_cast<size_t>(j0 + j) * N + n));
          const bf16* av = reinterpret_cast<const bf16*>(&araw);
          const bf16* pv = reinterpret_cast<const bf16*>(&praw);
#pragma unroll
          for (int rr = 0; rr < ROW_CHUNK; ++rr)
#pragma unroll
            for (int i = 0; i < 4; ++i) lo[rr][i] = fmaf(bf2f(av[rr]), bf2f(pv[i]), lo[rr][i]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < ROW_CHUNK; ++rr) {
        const int ml = row_first + r0 + rr, m = m0 + ml;
        const int4 v = *reinterpret_cast<const int4*>(acc_s + ml * LDACC + c0);
        const float a = as[m];
        const int vi[4] = {v.x, v.y, v.z, v.w};
        float out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          out[i] = __fmul_rn(__fmul_rn(static_cast<float>(vi[i]), a), wsv[i]);
          if (R > 0) out[i] = __fadd_rn(out[i], lo[rr][i]);
          if (bias != nullptr) out[i] = __fadd_rn(out[i], bv[i]);
        }
        float gv[4], hm = 0.f;
        uint2 gb;
        bf16* gbp = reinterpret_cast<bf16*>(&gb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i] = tanh_gelu(out[i]);
          hm = fmaxf(hm, fabsf(__fmul_rn(__fadd_rn(gv[i], shift), rsv[i])));
          gbp[i] = __float2bfloat16(gv[i]);
        }
        *reinterpret_cast<float4*>(g + static_cast<size_t>(m) * N + n) = make_float4(gv[0], gv[1], gv[2], gv[3]);
        *reinterpret_cast<uint2*>(&gt[ml * LDG + c0]) = gb;
        hm = warp_max(hm);
        if (lane == 0) rmax[ml] = fmaxf(rmax[ml], hm);
      }
    }
    if (t + 1 < tiles) bar_arrive(BAR_EMPTY, PIPE_THREADS);  // the main-loop warps may store tile t + 1
    bar_sync(BAR_EPI, EPI_THREADS);                          // the g and proj_down tiles are complete

    // the tile's low-rank partial, row 2's product: per 16-row slab bf16(g)[16, 128] @ pd[128, R2p], 32
    // columns (two accumulators) at a time; this warp's two slabs; the proj_down tile's PC columns at a time
    float* part = lora_part + (static_cast<size_t>(n0 / BN) * M + m0) * R2p;
    for (int p0 = 0; p0 < R2p; p0 += PC) {
      const int pc = lora_chunk(R2p - p0);
      if (p0 > 0) {  // the next columns of proj_down through the same tile
        bar_sync(BAR_EPI, EPI_THREADS);  // every warp has read the previous columns
        for (int i = et; i < BN * pc; i += EPI_THREADS) {
          const int c = i / pc, r = i % pc;
          pdt[c * LDP + r] = p0 + r < R2 ? pd[static_cast<size_t>(n0 + c) * R2 + p0 + r] : __float2bfloat16(0.f);
        }
        bar_sync(BAR_EPI, EPI_THREADS);
      }
      for (int slab = 2 * ew; slab < 2 * ew + 2; ++slab) {
        for (int j0 = 0; j0 < pc; j0 += 32) {
          const int nf = pc - j0 >= 32 ? 2 : 1;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> lp[2];
          wmma::fill_fragment(lp[0], 0.f);
          wmma::fill_fragment(lp[1], 0.f);
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ga;
            wmma::load_matrix_sync(ga, &gt[(slab * 16) * LDG + kk * 16], LDG);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j < nf) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> pb;
                wmma::load_matrix_sync(pb, &pdt[(kk * 16) * LDP + j0 + j * 16], LDP);
                wmma::mma_sync(lp[j], ga, pb, lp[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (j < nf)
              wmma::store_matrix_sync(part + static_cast<size_t>(slab * 16) * R2p + p0 + j0 + j * 16, lp[j], R2p,
                                      wmma::mem_row_major);
        }
      }
    }
    bar_sync(BAR_EPI, EPI_THREADS);  // the g and proj_down tiles may be overwritten
  }

  // the group's codes: each lane reads back the g values it wrote, a row's whole group in flight at once
  __syncwarp();
  for (int rr = 0; rr < EPI_ROWS; ++rr) {
    const int ml = row_first + rr, m = m0 + ml;
    // max|h| / 127 as XLA compiles it: a multiply by the f32 reciprocal of 127
    const float scale = __fmul_rn(rmax[ml], 1.0f / 127.0f);
    const float rc = scale == 0.f ? 0.f : __fdiv_rn(1.0f, scale);
    if (lane == 0) qscales[static_cast<size_t>(group) * M + m] = scale;
    float4 gg[MAX_TILES];
#pragma unroll
    for (int t = 0; t < MAX_TILES; ++t)
      if (t < tiles) gg[t] = *reinterpret_cast<const float4*>(g + static_cast<size_t>(m) * N + n_first + t * BN + c0);
#pragma unroll
    for (int t = 0; t < MAX_TILES; ++t) {
      if (t >= tiles) break;
      const int n = n_first + t * BN + c0;
      float rr4[4];
      load4(rr4, rsm + n);
      const float gv[4] = {gg[t].x, gg[t].y, gg[t].z, gg[t].w};
      signed char q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = __fmul_rn(__fadd_rn(gv[i], shift), rr4[i]);
        q[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(h, rc)), -127.f), 127.f));
      }
      *reinterpret_cast<char4*>(qout + static_cast<size_t>(m) * N + n) = make_char4(q[0], q[1], q[2], q[3]);
    }
  }

  // the last block of this row block to finish sums every tile's partial in ascending tile order
  __threadfence();
  bar_sync(BAR_EPI, EPI_THREADS);
  if (et == 0) *last = atomicAdd(done + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  bar_sync(BAR_EPI, EPI_THREADS);
  if (*last) {
    __threadfence();
    const int ntiles = N / BN;
    for (int i = et; i < BM * R2; i += EPI_THREADS) {
      const int r = i / R2, c = i % R2;
      float s = 0.f;
      for (int t = 0; t < ntiles; ++t)
        s = __fadd_rn(s, __ldcg(lora_part + (static_cast<size_t>(t) * M + m0 + r) * R2p + c));
      lora_next[static_cast<size_t>(m0 + r) * R2 + c] = s;
    }
  }
}

}  // namespace

// qact (M, K) int8, ascales (M,) f32, wt (N, K) int8 (the (K, N) weight
// K-contiguous), wscales (N,) f32, lora_act (M, R) f32 | null, proj_up (R, N)
// bf16 | null, bias (N,) bf16 | null, rsmooth_next (N,) f32, proj_down_next
// (N, R2) bf16; workspaces gbuf (M, N) f32, lora_part (N/128, M, R2p) f32 with
// R2p = R2 rounded up to 16, done (M/128,) int32 zeroed
// -> qout (M, N) int8, qscales (N/bn, M) f32, lora_next (M, R2) f32.
// Needs M % 128 == 0, bn % 128 == 0, bn <= 1536, N % bn == 0, K % 64 == 0, R2 >= 1 (any R, R2).
extern "C" int nt_gemm_w8a8_gelu_quant_pipe(const void* qact, const void* ascales, const void* wt,
                                            const void* wscales, const void* lora_act, const void* proj_up,
                                            const void* bias, const void* rsmooth, const void* proj_down,
                                            void* gbuf, void* lora_part, void* done, void* qout, void* qscales,
                                            void* lora_next, int M, int N, int K, int R, int R2, int bn,
                                            float shift, void* stream) {
  if (M % BM || bn % BN || bn < BN || bn > MAX_TILES * BN || N % bn || K % BK || R < 0 || R2 < 1 ||
      (R > 0 && (lora_act == nullptr || proj_up == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {  // room for the widest chunks once; each launch asks for its own size
    cudaError_t e = cudaFuncSetAttribute(gemm_gelu_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pipe_layout(RANK_CHUNK, RANK_CHUNK).total));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(N / bn, M / BM);
  gemm_gelu_pipe_kernel<<<grid, PIPE_THREADS, static_cast<int>(pipe_layout(R, R2).total),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qact), static_cast<const float*>(ascales), WeightI8{static_cast<const int8_t*>(wt)},
      static_cast<const float*>(wscales), static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
      static_cast<const bf16*>(bias), static_cast<const float*>(rsmooth), static_cast<const bf16*>(proj_down),
      static_cast<float*>(gbuf), static_cast<float*>(lora_part), static_cast<int*>(done),
      static_cast<int8_t*>(qout), static_cast<float*>(qscales), static_cast<float*>(lora_next), M, N, K, R, R2,
      bn, shift);
  return static_cast<int>(cudaGetLastError());
}
