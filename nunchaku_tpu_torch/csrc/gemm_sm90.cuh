// A warp-specialised Hopper GEMM main loop: out (M, N) = A (M, K) . W (K, N)
// with TMA (or bulk) copies into a ring of shared-memory stages and wgmma
// products, the counterpart for the GEMMs of what flash_sm90.cuh is for
// attention. Templated on:
//   - the operand type (Op): its wgmma k step, accumulator type and products.
//     Bf16 (k16, f32 accumulators, W read MN-major) is the one built here; an
//     s8 operand (k32, s32 accumulators) would read W K-major, as 8-bit wgmma
//     requires, from a K-contiguous weight (the int8 chain GEMMs' layout);
//   - the block's N tile BN (wgmma m64nBNk16; 128 or 256) and ring depth ST;
//   - the source (Src): how a K tile reaches shared memory and becomes the
//     two tiles wgmma reads. Either TMA writes them as they are (bf16
//     operands), or it brings the stored bytes into a raw stage that the
//     consumers decode into swizzled bf16 tiles (gemm_probe_bf16.cu's coded
//     operands).
//
// Design (one block a BM x BN output tile, 384 threads):
//   - warpgroup 0 is the producer: registers lowered by setmaxnreg, one
//     thread waits for a free stage and issues its copies (Src::load), which
//     complete on the stage's full barrier (mbarrier, transaction bytes);
//   - warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg raises
//     them); each K tile of 64 is BK / K_STEP wgmma m64nBNk16 products on A
//     (K-major, one 128-byte-swizzled panel of 64 columns, this warpgroup's
//     64 rows) and W (BN / 64 panels of 64 K rows, N-contiguous: MN-major,
//     the descriptor's leading offset the panel stride), committed as one
//     group; the next tile's products are issued before the previous group
//     is waited for (wgmma.wait_group 1), so the tensor cores never wait on
//     the issue. A stage returns to the producer (its empty barrier, one
//     arrival a consumer warp) when the products that read it are done, or,
//     for a decoded source, as soon as it is decoded;
//   - a decoding source writes three rotating tile buffers: the decode of
//     tile t + 1 runs under the products of tile t, and a buffer is written
//     again only after both consumers passed the barrier that follows their
//     wait for its last products;
//   - the epilogue rounds the f32 accumulators to bf16 and stores them (row
//     g and g + 8 of each warp, two columns a thread);
//   - the blocks walk the output in bands of GROUP_M row tiles, each band
//     column tile by column tile with its row tiles fastest: the blocks in
//     flight share one band of A and a few column panels of W, so each is
//     read from device memory about once (in row-major block order every
//     row of blocks would read all of W again).
// The shared-memory tiles are 1024-byte aligned, as the swizzle needs.
#pragma once

#include "sm90.cuh"

namespace {
namespace gemm90 {
using namespace sm90;

constexpr int BM = 128, BK = 64, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65,536
constexpr int A_TILE = BM * 128;                        // bytes of the A tile (BM rows of 64 bf16)
constexpr int PANEL = BK * 128;                         // bytes of one 64-column W panel (BK rows)
constexpr int DEC_BUFFERS = 3;                          // rotating decoded tiles
constexpr int GROUP_M = 16;                             // row tiles of a band of the raster

template <int BN>
struct Tiles {
  static_assert(BN == 128 || BN == 256, "wgmma m64nBNk16 is built at N 128 and 256");
  static constexpr int W_TILE = (BN / 64) * PANEL;
  static constexpr int BYTES = A_TILE + W_TILE;  // the two tiles wgmma reads, A then W
};

// bf16 operands, f32 accumulators; W MN-major (N-contiguous)
struct Bf16 {
  using Acc = float;
  static constexpr int K_STEP = 16;  // elements of one wgmma k step (32 bytes of A's row)
  template <int N>
  __device__ static void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
  // the W operand of k step kk: 16 K rows (2048 bytes) further; panels PANEL apart
  __device__ static uint64_t w_desc(const unsigned char* w, int kk) {
    return sw128_desc(w + kk * K_STEP * 128, PANEL / 16);
  }
};

// d (64 x 128 f32) (+)= A (64 x 16, K-major) . B (16 x 128, MN-major), both in shared memory; scale_d 0
// overwrites d
template <>
__device__ __forceinline__ void Bf16::mma<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// d (64 x 256 f32) (+)= A (64 x 16, K-major) . B (16 x 256, MN-major), both in shared memory; scale_d 0
// overwrites d
template <>
__device__ __forceinline__ void Bf16::mma<256>(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Src (the source of a K tile) provides:
//   Params                         kernel parameters (tensor maps, pointers), passed __grid_constant__
//   STAGE, EXTRA                   bytes of a ring stage and of its own shared memory after the ring
//   DECODES                        whether the consumers turn a stage into the tiles themselves
//   load(p, stage, full, m0, n0, t)      one producer thread: the copies of K tile t, completing on full
//   tiles(p, stage, extra, t, ct)        the consumers (ct 0-255): -> the tiles wgmma reads (A, then W)
// Epilogue: the accumulators of this thread's rows g and g + 8 (acc[4j + e]: row g + 8 (e >= 2), column 8j + 2 t4
// + (e & 1) of the warpgroup's 64 x BN tile) -> out (M, N) bf16, ld N.
template <class Op, int BN, int ST, class Src>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ typename Src::Params p, bf16* __restrict__ out, int M, int N, int K) {
  constexpr int OFF_EXTRA = ST * Src::STAGE, OFF_BAR = OFF_EXTRA + Src::EXTRA;
  static_assert(Src::STAGE % 1024 == 0 && Src::EXTRA % 1024 == 0, "tiles 1024-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + OFF_BAR);
  uint64_t* empty = full + ST;
  // this block's tile in the banded raster (one block index over M / BM x ceil(N / BN) tiles)
  const int nn = (N + BN - 1) / BN, band = blockIdx.x / (GROUP_M * nn);
  const int first = band * GROUP_M, rows = min(GROUP_M, M / BM - first), in_band = blockIdx.x - band * GROUP_M * nn;
  const int m0 = (first + in_band % rows) * BM, n0 = in_band / rows * BN, nk = K / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // the consumers' eight warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
  if (role == 0) {
    // ---- producer ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % ST;
        mbar_wait(empty + s, ((t / ST) & 1) ^ 1);
        Src::load(p, sm + s * Src::STAGE, full + s, m0, n0, t);
      }
    }
    return;
  }
  // ---- consumers: 64 rows a warpgroup ----
  reg_alloc<CONSUMER_REGS>();
  const int ct = threadIdx.x - WG, cw = ct / WG, warp = (ct % WG) / 32, lane = ct % 32;
  typename Op::Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int t = 0; t < nk; ++t) {
    const int s = t % ST;
    mbar_wait(full + s, (t / ST) & 1);
    const unsigned char* tiles = Src::tiles(p, sm + s * Src::STAGE, sm + OFF_EXTRA, t, ct);
    if (Src::DECODES) {
      if (lane == 0) mbar_arrive(empty + s);  // the raw stage is decoded
      named_sync(1);                          // both consumers' decodes are in the tiles
    }
    const unsigned char* a = tiles + cw * 64 * 128;
    const unsigned char* w = tiles + A_TILE;
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / Op::K_STEP; ++kk)  // 32 bytes of each A row a k step
      Op::template mma<BN>(acc, sw128_desc(a + kk * 32), Op::w_desc(w, kk), 1);
    wg_commit();
    wg_wait<1>();  // tile t - 1's products are done
    if (!Src::DECODES && t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % ST);
  }
  wg_wait<0>();
  reg_fence(acc);

  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = m0 + cw * 64 + warp * 16 + g;
  bf16* dst0 = out + static_cast<size_t>(row0) * N + n0 + 2 * t4;
  bf16* dst1 = dst0 + static_cast<size_t>(8) * N;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (n0 + 8 * j >= N) break;  // a BN 256 tile past an N that 128 divides
    *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Shared memory of one instantiation: the ring, the source's own, the barriers, 1024 to align the base.
template <int ST, class Src>
constexpr int smem_bytes() {
  return ST * Src::STAGE + Src::EXTRA + 16 * ST + 1024;
}

template <class Op, int BN, int ST, class Src>
int launch(const typename Src::Params& p, bf16* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<ST, Src>();
  static_assert(bytes <= 232448, "shared memory over the H100's 227 KB");
  static bool configured = false;
  if (!configured) {
    cudaError_t e =
        cudaFuncSetAttribute(gemm_sm90_kernel<Op, BN, ST, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int grid = (N + BN - 1) / BN * (M / BM);
  gemm_sm90_kernel<Op, BN, ST, Src><<<grid, THREADS, bytes, stream>>>(p, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm90
}  // namespace
