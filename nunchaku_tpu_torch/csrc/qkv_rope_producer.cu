// Fused attention prologue of the bf16-stream configuration: split the
// fused-QKV GEMM output by head, add the projection's low-rank term, RMSNorm
// q and k, rotate them with the half-split RoPE, prescale q, and write q, k,
// v in flash's (B, H, S, D) layout -- at a row offset of caller-given
// buffers, so a dual block's txt and img streams share one joint buffer.
//
// Replaces nunchaku_tpu/ops/attention.py _qkv_rope_producer_kernel (:158,
// launched by qkv_rope_producer :212). Per (token, head), D = 128:
//   a = x [+ bf16(lora_act) @ proj_up[:, head slice]]             (f32)
//   q, k: a = a * rsqrt(mean(a^2) + 1e-6) * w;  o = a*cos + roll(a, 64)*sin
//         (sin's first half negated), q: o *= q_scale;  v: o = a
//
// Bound on the H100: bytes (read the (S, 3*H*D) bf16 GEMM output once,
// write q, k, v once; about 15 operations per element; the rank-R product
// is 2 R operations an element, far below the tensor cores' ridge).
// Design (one persistent block an SM, 384 threads):
//   - the work is cut into units (token tile of 64 rows of one batch row,
//     section q / k / v, head), token-tile-major: a block takes a contiguous
//     range of units, so it walks the heads of a tile as the JAX grid does
//     (heads innermost) and stages the tile's operands that every head
//     shares once: cos / sin (f32, rows XOR-swizzled so the epilogue's 8-byte
//     reads are free of bank conflicts) and bf16(lora_act) in wgmma's K-major
//     128-byte-swizzled panels;
//   - warpgroup 0 is the producer (setmaxnreg lowers it): one thread copies
//     each unit's x tile (two 64 x 64 TMA boxes of qkv viewed as (B, S, 3HD),
//     128-byte swizzle; rows past S read as zeros) into a ring of x slots and,
//     with a low-rank term, the unit's proj_up panel (R x 128 bf16, MN-major,
//     two 64-column boxes of up to 128 ranks) into a ring of its own, as far
//     ahead as the slots allow. An x slot is held through the epilogue, so
//     the x ring takes what the staged operands leave, up to 8 slots (8 at R
//     0 and R 32, 4 above); a proj_up slot is held only for the product, so
//     one a warpgroup lets the next unit's chunk load under this unit's
//     epilogue. Each ring is cut in two halves, one a consumer warpgroup, so
//     a slot's barrier phases are waited for by one warpgroup in order (a
//     slot shared by both would let one warpgroup take the other's earlier
//     phase of the same parity for its own);
//   - warpgroups 1 and 2 take the units in turn: the low-rank product is
//     wgmma m64n128k16 (A: the staged bf16(lora_act), B: the proj_up panel),
//     in k steps of 16 ranks in order from rank 0 in one accumulator chain (R
//     <= 32: 2 steps, else chunks of 8 steps = 128 ranks, past R zeros), so a
//     rank zero-padded to R gives the unpadded launch's bits; the epilogue
//     works in the accumulator layout (a thread holds rows g and g + 8 of its
//     warp's 16, columns 8 j + 2 t4 (+1): columns c and c + 64 in the same
//     thread, so roll(a, 64) is free and mean(a^2) two quad shuffles): x from
//     the slot, a = x + acc, RMSNorm, RoPE, q_scale; bf16 back into the slot,
//     then 16-byte coalesced stores of the tile's valid rows (a ragged tile
//     or a shared buffer is never written past its rows);
//   - R 0 (and the prepare form) skips the product; its v units are copies.
// Ranks above 256 keep no tile-wide bf16(lora_act): each warpgroup stages
// its unit's 128-rank chunk itself (slower; no model runs it).
//
// Prepare mode: replaces _qkv_prepare_kernel (:51, launched by qkv_prepare
// :87), the producer without the low-rank term: the same kernel as R 0 (q,
// k, v written whole, S_out = S, row offset 0) with the RMSNorm's eps an
// argument, so the two give the same outputs bit for bit.
#include "gemm_sm90.cuh"  // the bf16 wgmma (MN-major B) of the GEMM main loop

namespace {

using namespace sm90;

constexpr int D = 128, TS = 64, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128 * 40 + 256 * 232 <= 65,536
constexpr int BOX = TS * 128;                           // one 64 x 64 bf16 box (128-byte rows)
constexpr int X_BYTES = 2 * BOX;                        // a unit's x tile
constexpr int LA_PANEL = TS * 128;                      // 64 ranks of the tile's bf16(lora_act)
constexpr int LA_RESIDENT = 256;                        // ranks kept for the whole tile
constexpr int CS_BYTES = 2 * TS * D * 4;                // the tile's cos and sin (f32)
constexpr int NW_BYTES = 2 * D * 4;                     // norm_q, norm_k (f32)
constexpr int MAX_STAGES = 8;  // x slots (10 at R 0 measured no faster)
constexpr int MAX_SMEM = 232448;  // the H100's 227 KB a block
constexpr int CONSUMER_BAR = 1;   // named barrier of both consumer warpgroups; 2 + h: warpgroup h's own

struct Params {
  CUtensorMap xmap;  // qkv (B, S, 3HD) in 64 x 64 boxes
  CUtensorMap pmap;  // proj_up (R, 3HD) in boxes of 64 columns x a chunk's ranks
  const float* cos;  // (S, D)
  const float* sin;
  const bf16* nq;
  const bf16* nk;
  const float* la;   // (B*S, R) | null
  bf16* out[3];      // q, k, v: (B, H, S_out, D)
  int S, H, T, S_out, off, R;
  int units, nch;    // units of the launch, rank chunks a unit
  int la_res, la_panels, sx, sp;  // bf16(lora_act) kept a tile / its 64-rank panels; ring depths
  float q_scale, eps;
};

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ float2 lds2f(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

// Float offset of the f32 pair (c, c + 1), c = 2 p, of row r of the staged cos / sin: pair p XOR 4 (r & 3), so a
// warp's 8-byte reads of rows g and columns 8 j + 2 t4 hit every bank once a half-warp.
__device__ __forceinline__ int cs_at(int r, int p) { return r * D + 2 * (p ^ ((r & 3) << 2)); }

// Byte offset of the 16-byte chunk q (of 16) of row r of a 64-row tile in two 128-byte-swizzled 64-column boxes.
__device__ __forceinline__ uint32_t sw_at(int r, int q) { return (q >> 3) * BOX + r * 128 + (((q & 7) ^ (r & 7)) << 4); }

// A unit: token tile bt (batch b, rows s0 ..) of the launch, section sec, head h; its columns col .. col + 127 of
// qkv and proj_up.
struct Unit {
  int b, s0, sec, h, col;
  __device__ Unit(const Params& p, int u) {
    const int bt = u / (3 * p.H), rem = u - bt * 3 * p.H;
    sec = rem / p.H;
    h = rem - sec * p.H;
    b = bt / p.T;
    s0 = (bt - b * p.T) * TS;
    col = sec * p.H * D + h * D;
  }
};

// bf16(lora_act) of rows s0 .. s0 + 63 of batch row b, ranks k0 .. k0 + 8 n8 (past S or R: zeros), into 64-rank
// K-major 128-byte-swizzled panels at dst; by `threads` threads, this one `tid`.
__device__ __forceinline__ void stage_la(const Params& p, int b, int s0, int k0, int n8, unsigned char* dst, int tid,
                                         int threads) {
  const int rows = min(TS, p.S - s0);
#pragma unroll 4
  for (int i = tid; i < TS * n8; i += threads) {
    const int r = i / n8, k = 8 * (i - r * n8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && k0 + k < p.R) {
      const float4* src = reinterpret_cast<const float4*>(p.la + (static_cast<size_t>(b) * p.S + s0 + r) * p.R + k0 + k);
      const float4 lo = __ldg(src), hi = __ldg(src + 1);
      v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(dst + (k >> 6) * LA_PANEL + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4)) = v;
  }
}

// The tile's cos / sin rows (and, kept a tile, its bf16(lora_act)) by the 256 consumer threads; every load first.
template <int STEPS>
__device__ __forceinline__ void stage_tile(const Params& p, const Unit& t, float* cs, unsigned char* la, int ct) {
  const int rows = min(TS, p.S - t.s0);
  float4 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {  // 2 tables x 64 rows x 32 float4
    const int i = ct + 256 * k, r = (i >> 5) & 63, q = i & 31;
    const float* src = (i >> 11) ? p.sin : p.cos;
    v[k] = r < rows ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(t.s0 + r) * D) + q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int i = ct + 256 * k, r = (i >> 5) & 63, q = i & 31;
    *reinterpret_cast<float4*>(cs + (i >> 11) * TS * D + cs_at(r, 2 * q)) = v[k];
  }
  if constexpr (STEPS > 0)
    if (p.la_res) stage_la(p, t.b, t.s0, 0, p.nch * 2 * STEPS, la, ct, 2 * WG);
}

template <int STEPS>
__global__ void __launch_bounds__(THREADS, 1) qkv_rope_kernel(const __grid_constant__ Params p) {
  constexpr int CW = 16 * STEPS, P_BYTES = 2 * CW * 128;  // ranks of a chunk; bytes of its proj_up panel
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* xr = sm;                      // [sx] x tiles
  unsigned char* pr = xr + p.sx * X_BYTES;     // [sp] proj_up panels
  unsigned char* lr = pr + p.sp * P_BYTES;     // [la_panels] bf16(lora_act)
  float* cs = reinterpret_cast<float*>(lr + p.la_panels * LA_PANEL);  // cos [TS][D], sin [TS][D]
  float* nw = cs + 2 * TS * D;                                        // norm_q [D], norm_k [D]
  uint64_t* full_x = reinterpret_cast<uint64_t*>(nw + 2 * D);
  uint64_t* empty_x = full_x + p.sx;
  uint64_t* full_p = empty_x + p.sx;
  uint64_t* empty_p = full_p + p.sp;
  const int u0 = static_cast<int>(static_cast<long long>(blockIdx.x) * p.units / gridDim.x);
  const int u1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.units / gridDim.x);
  // each warpgroup's own half of both rings: a slot's phases are waited for by one warpgroup, in order
  const int sxh = p.sx / 2, sph = p.sp / 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.sx; ++i) {
      mbar_init(full_x + i, 1);
      mbar_init(empty_x + i, 4);  // the consuming warpgroup's four warps
    }
    for (int i = 0; i < p.sp; ++i) {
      mbar_init(full_p + i, 1);
      mbar_init(empty_p + i, 4);
    }
    mbar_init_fence();
  }
  if (threadIdx.x < 2 * D) nw[threadIdx.x] = bf2f(threadIdx.x < D ? p.nq[threadIdx.x] : p.nk[threadIdx.x - D]);
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (role == 0) {
    // ---- producer: unit i's x tile, then its rank chunks, each once its slot is free ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < u1 - u0; ++i) {
        const Unit un(p, u0 + i);
        const int h = i & 1, n = i >> 1, s = h * sxh + n % sxh;  // warpgroup h's n-th unit
        mbar_wait(empty_x + s, ((n / sxh) & 1) ^ 1);
        mbar_expect_tx(full_x + s, X_BYTES);
        tma_load_3d(xr + s * X_BYTES, &p.xmap, full_x + s, un.col, un.s0, un.b);
        tma_load_3d(xr + s * X_BYTES + BOX, &p.xmap, full_x + s, un.col + 64, un.s0, un.b);
        if constexpr (STEPS > 0) {
          for (int c = 0; c < p.nch; ++c) {
            const int m = n * p.nch + c, q = h * sph + m % sph;  // warpgroup h's m-th chunk
            mbar_wait(empty_p + q, ((m / sph) & 1) ^ 1);
            mbar_expect_tx(full_p + q, P_BYTES);
            tma_load_2d(pr + q * P_BYTES, &p.pmap, full_p + q, un.col, c * CW);
            tma_load_2d(pr + q * P_BYTES + CW * 128, &p.pmap, full_p + q, un.col + 64, c * CW);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup h takes the block's units u0 + h, u0 + h + 2, ... ----
  reg_alloc<CONSUMER_REGS>();
  const int ct = threadIdx.x - WG, h = ct / WG, tid = ct % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3, g3 = g & 3;
  const uint32_t cs_s = smem_u32(cs), nw_s = smem_u32(nw);
  float acc[64];
  for (int u = u0; u < u1;) {
    const Unit tile(p, u);
    const int tile_end = min(u1, (u / (3 * p.H) + 1) * 3 * p.H);
    named_sync(CONSUMER_BAR);  // both warpgroups are done with the previous tile's staged operands
    stage_tile<STEPS>(p, tile, cs, lr, ct);
    fence_proxy_async();       // bf16(lora_act) is read by wgmma
    named_sync(CONSUMER_BAR);
    for (int v = u + (((u - u0) & 1) != h); v < tile_end; v += 2) {
      const Unit un(p, v);
      const int n = (v - u0) >> 1, xs = h * sxh + n % sxh;  // this warpgroup's n-th unit
      unsigned char* xt = xr + xs * X_BYTES;
      const uint32_t xt_s = smem_u32(xt);
      mbar_wait(full_x + xs, (n / sxh) & 1);
      const bool copy = STEPS == 0 && un.sec == 2;  // v without a low-rank term: the tile as it is
      if constexpr (STEPS > 0) {
        for (int c = 0; c < p.nch; ++c) {  // acc = bf16(lora_act) @ proj_up, chunk after chunk
          const int m = n * p.nch + c, q = h * sph + m % sph;
          const unsigned char* la = lr + c * 2 * LA_PANEL;
          if (!p.la_res) {  // this warpgroup's own chunk buffer
            la = lr + h * 2 * LA_PANEL;
            stage_la(p, un.b, un.s0, c * CW, CW / 8, lr + h * 2 * LA_PANEL, tid, WG);
            fence_proxy_async();
            wg_sync(2 + h);
          }
          mbar_wait(full_p + q, (m / sph) & 1);
          const unsigned char* pt = pr + q * P_BYTES;
          reg_fence(acc);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < STEPS; ++kk)
            gemm90::Bf16::mma<128>(acc, sw128_desc(la + (kk >> 2) * LA_PANEL + (kk & 3) * 32),
                                   sw128_desc(pt + kk * 16 * 128, CW * 128 / 16), c > 0 || kk > 0);
          wg_commit();
          wg_wait<0>();
          reg_fence(acc);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_p + q);
          if (!p.la_res) wg_sync(2 + h);  // every warp's products read the chunk buffer
        }
      }
      if (!copy) {
        // rows r0 = 16 warp + g and r0 + 8; accumulator 4 j + e: row r0 (e < 2) or r0 + 8, column 8 j + 2 t4 + e % 2
        const uint32_t x0 = xt_s + (16 * warp + g) * 128 + 4 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t o = (j >> 3) * BOX + (((j & 7) ^ g) << 4);
          const uint32_t w0 = lds32(x0 + o), w1 = lds32(x0 + 8 * 128 + o);
          const float e[4] = {__uint_as_float(w0 << 16), __uint_as_float(w0 & 0xffff0000u),
                              __uint_as_float(w1 << 16), __uint_as_float(w1 & 0xffff0000u)};
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[4 * j + k] = STEPS > 0 ? __fadd_rn(e[k], acc[4 * j + k]) : e[k];
        }
        if (un.sec < 2) {
          float s0a = 0.f, s0b = 0.f, s1a = 0.f, s1b = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            s0a = __fmaf_rn(acc[4 * j], acc[4 * j], s0a);
            s0b = __fmaf_rn(acc[4 * j + 1], acc[4 * j + 1], s0b);
            s1a = __fmaf_rn(acc[4 * j + 2], acc[4 * j + 2], s1a);
            s1b = __fmaf_rn(acc[4 * j + 3], acc[4 * j + 3], s1b);
          }
          float ss[2] = {__fadd_rn(s0a, s0b), __fadd_rn(s1a, s1b)};
          float rs[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            ss[e] = __fadd_rn(ss[e], __shfl_xor_sync(0xffffffffu, ss[e], 1));
            ss[e] = __fadd_rn(ss[e], __shfl_xor_sync(0xffffffffu, ss[e], 2));
            rs[e] = __frsqrt_rn(__fadd_rn(__fmul_rn(ss[e], 1.0f / D), p.eps));
          }
          const float qs = un.sec == 0 ? p.q_scale : 1.f;
          const uint32_t wq = nw_s + 4 * (un.sec * D + 2 * t4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // columns c = 8 j + 2 t4 (+1) and c + 64 (+1)
            const float2 wl = lds2f(wq + 32 * j), wh = lds2f(wq + 32 * (j + 8));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 16 * warp + g + 8 * e;
              const uint32_t cl = cs_s + 4 * (r * D + 8 * (j ^ g3) + 2 * t4), ch = cl + 4 * 64;
              const float2 col = lds2f(cl), coh = lds2f(ch), sil = lds2f(cl + 4 * TS * D), sih = lds2f(ch + 4 * TS * D);
              const float a0 = __fmul_rn(__fmul_rn(acc[4 * j + 2 * e], rs[e]), wl.x);
              const float a1 = __fmul_rn(__fmul_rn(acc[4 * j + 2 * e + 1], rs[e]), wl.y);
              const float b0 = __fmul_rn(__fmul_rn(acc[4 * (j + 8) + 2 * e], rs[e]), wh.x);
              const float b1 = __fmul_rn(__fmul_rn(acc[4 * (j + 8) + 2 * e + 1], rs[e]), wh.y);
              acc[4 * j + 2 * e] = __fmul_rn(__fmaf_rn(a0, col.x, __fmul_rn(b0, sil.x)), qs);
              acc[4 * j + 2 * e + 1] = __fmul_rn(__fmaf_rn(a1, col.y, __fmul_rn(b1, sil.y)), qs);
              acc[4 * (j + 8) + 2 * e] = __fmul_rn(__fmaf_rn(b0, coh.x, __fmul_rn(a0, sih.x)), qs);
              acc[4 * (j + 8) + 2 * e + 1] = __fmul_rn(__fmaf_rn(b1, coh.y, __fmul_rn(a1, sih.y)), qs);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t o = (j >> 3) * BOX + (((j & 7) ^ g) << 4);
          sts32(x0 + o, pack_bf16(acc[4 * j], acc[4 * j + 1]));
          sts32(x0 + 8 * 128 + o, pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
        }
        wg_sync(2 + h);  // the whole tile is written
      }
      // the tile's valid rows out, 16 bytes a thread, two threads' 32 bytes a row apart by 256 (coalesced)
      bf16* dst = p.out[un.sec] + ((static_cast<size_t>(un.b) * p.H + un.h) * p.S_out + p.off + un.s0) * D;
      const int rows = min(TS, p.S - un.s0);
      uint4 w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int idx = tid + WG * k, r = idx >> 4, q = idx & 15;
        w[k] = lds128(xt_s + sw_at(r, q));
      }
      fence_proxy_async();  // the slot's next TMA write comes after these reads
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_x + xs);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int idx = tid + WG * k, r = idx >> 4, q = idx & 15;
        if (r < rows) *reinterpret_cast<uint4*>(dst + r * D + q * 8) = w[k];
      }
    }
    u = tile_end;
  }
}

template <int STEPS>
int launch(const Params& p, int smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(qkv_rope_kernel<STEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int grid = p.units < sm_count() ? p.units : sm_count();
  qkv_rope_kernel<STEPS><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The rings (each warpgroup its half: x slots in what the staged operands leave, one proj_up slot), the tensor
// maps, and the launch at the product's k steps (0; 2: R <= 32; 8: chunks of 128 ranks).
int run(Params& p, int B, const void* qkv, const void* pu, cudaStream_t stream) {
  if (B == 0 || p.S == 0 || p.H == 0) return 0;
  if (!aligned16(qkv) || (p.R > 0 && (!aligned16(pu) || !aligned16(p.la))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = p.R == 0 ? 0 : (p.R <= 32 ? 2 : 8), cw = 16 * steps, pbytes = 2 * cw * 128;
  p.T = (p.S + TS - 1) / TS;
  p.units = B * p.T * 3 * p.H;
  p.nch = steps ? (p.R + cw - 1) / cw : 0;
  p.la_res = p.nch * cw <= LA_RESIDENT;
  p.la_panels = steps == 0 ? 0 : (p.la_res ? (p.nch * cw + 63) / 64 : 4);
  const int fixed = 1024 + p.la_panels * LA_PANEL + CS_BYTES + NW_BYTES;
  p.sp = steps ? 2 : 0;
  p.sx = (MAX_SMEM - fixed - p.sp * (pbytes + 16)) / (2 * (X_BYTES + 16)) * 2;
  p.sx = p.sx < MAX_STAGES ? p.sx : MAX_STAGES;
  const int smem = fixed + p.sx * X_BYTES + p.sp * pbytes + 16 * (p.sx + p.sp);
  const auto B16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t n3 = 3 * static_cast<cuuint64_t>(p.H) * D;
  const cuuint64_t x_dims[3] = {n3, static_cast<cuuint64_t>(p.S), static_cast<cuuint64_t>(B)};
  const cuuint64_t x_str[2] = {2 * n3, 2 * n3 * p.S};
  const cuuint32_t x_box[3] = {64, TS, 1};
  bool ok = p.sx >= 2 && smem <= MAX_SMEM &&
            tensor_map(&p.xmap, B16, 3, qkv, x_dims, x_str, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && steps > 0) {
    const cuuint64_t dims[2] = {n3, static_cast<cuuint64_t>(p.R)};
    const cuuint64_t str[1] = {2 * n3};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(cw)};
    ok = tensor_map(&p.pmap, B16, 2, pu, dims, str, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return steps == 0 ? launch<0>(p, smem, stream) : steps == 2 ? launch<2>(p, smem, stream) : launch<8>(p, smem, stream);
}

Params params(const void* cos, const void* sin, const void* norm_q, const void* norm_k, void* q, void* k, void* v,
              int S, int H, int S_out, int off, int R, float q_scale, float eps) {
  Params p{};
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.nq = static_cast<const bf16*>(norm_q);
  p.nk = static_cast<const bf16*>(norm_k);
  p.out[0] = static_cast<bf16*>(q);
  p.out[1] = static_cast<bf16*>(k);
  p.out[2] = static_cast<bf16*>(v);
  p.S = S;
  p.H = H;
  p.S_out = S_out;
  p.off = off;
  p.R = R;
  p.q_scale = q_scale;
  p.eps = eps;
  return p;
}

}  // namespace

// qkv (B, S, 3*H*128) bf16, cos / sin (S, 128) f32, norm_q / norm_k (128,)
// bf16, lora_act (B*S, R) f32 | null, proj_up (R, 3*H*128) bf16 | null
// -> rows [off, off + S) of q, k, v, each (B, H, S_out, 128) bf16.
// Needs R a multiple of 16 (0: no low-rank term), qkv, lora_act and proj_up
// 16-byte aligned.
extern "C" int nt_qkv_rope_producer(const void* qkv, const void* cos, const void* sin, const void* norm_q,
                                    const void* norm_k, const void* lora_act, const void* proj_up, void* q,
                                    void* k, void* v, int B, int S, int H, int S_out, int off, int R,
                                    float q_scale, void* stream) {
  if (R % 16 != 0 || R < 0 || (R > 0 && (lora_act == nullptr || proj_up == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = params(cos, sin, norm_q, norm_k, q, k, v, S, H, S_out, off, R, q_scale, 1e-6f);
  p.la = static_cast<const float*>(lora_act);
  return run(p, B, qkv, proj_up, static_cast<cudaStream_t>(stream));
}

// The prepare mode: qkv (B, S, 3*H*128) bf16, cos / sin (S, 128) f32,
// norm_q / norm_k (128,) bf16 -> q, k, v, each (B, H, S, 128) bf16.
extern "C" int nt_qkv_prepare(const void* qkv, const void* cos, const void* sin, const void* norm_q,
                              const void* norm_k, void* q, void* k, void* v, int B, int S, int H, float q_scale,
                              float eps, void* stream) {
  Params p = params(cos, sin, norm_q, norm_k, q, k, v, S, H, S, 0, 0, q_scale, eps);
  return run(p, B, qkv, nullptr, static_cast<cudaStream_t>(stream));
}
