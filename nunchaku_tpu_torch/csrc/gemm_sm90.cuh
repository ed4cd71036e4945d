// A warp-specialised Hopper GEMM main loop: out (M, N) = A (M, K) . W (K, N)
// with TMA (or bulk) copies into a ring of shared-memory stages and wgmma
// products, the counterpart for the GEMMs of what flash_sm90.cuh is for
// attention. Templated on:
//   - the operand type (Op): its wgmma k step, K tile, accumulator type and
//     products. Bf16: k16, K tiles of 64, f32 accumulators, W read MN-major.
//     S8: k32, K tiles of 128, s32 accumulators, W read K-major, as 8-bit
//     wgmma requires, from the K-contiguous (N, K) storage of the int8 chain
//     GEMMs' weights. Either way a K tile of A is one 128-byte-swizzled panel
//     of 128-byte rows (64 bf16 or 128 int8) and a K step 32 bytes of it;
//   - the block's N tile BN (wgmma m64nBNk16 / k32; 128 or 256) and ring
//     depth ST;
//   - the source (Src): how a K tile reaches shared memory and becomes the
//     two tiles wgmma reads. Either TMA writes them as they are (bf16 and
//     int8 operands), or it brings the stored bytes into a raw stage that the
//     consumers decode into swizzled bf16 tiles (gemm_probe_bf16.cu's coded
//     operands). The source also walks the K tiles: in K groups of
//     group_tiles each (the int8 chain consumer's scale groups; one group of
//     every tile otherwise);
//   - the epilogue (Epi): what the consumers do with the accumulators. With
//     FOLDS, each K group's products start from zero (wgmma scale_d 0) and
//     at the group's last tile, once they are done (wgmma.wait_group 0), the
//     epilogue folds them into registers of its own (the grouped consumer's
//     f32 running sum); then, after the last tile, it writes the output
//     (gemm_w8a8_gelu_quant.cu, gemm_w8a8_grouped.cu; the bf16 store below
//     for the probe).
//
// Design (one block a BM x BN output tile, 384 threads):
//   - warpgroup 0 is the producer: registers lowered by setmaxnreg, one
//     thread waits for a free stage and issues its copies (Src::load), which
//     complete on the stage's full barrier (mbarrier, transaction bytes);
//   - warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg raises
//     them); each K tile is 128 / 32 = 4 wgmma products on A (K-major, one
//     128-byte-swizzled panel, this warpgroup's 64 rows) and W (bf16: BN / 64
//     panels of 64 K rows, N-contiguous: MN-major, the descriptor's leading
//     offset the panel stride; int8: BN rows of 128 bytes, K-major, one
//     panel), committed as one group; the next tile's products are issued
//     before the previous group is waited for (wgmma.wait_group 1), so the
//     tensor cores never wait on the issue. A stage returns to the producer
//     (its empty barrier, one arrival a consumer warp) when the products that
//     read it are done, or, for a decoded source, as soon as it is decoded;
//   - a decoding source writes three rotating tile buffers: the decode of
//     tile t + 1 runs under the products of tile t, and a buffer is written
//     again only after both consumers passed the barrier that follows their
//     wait for its last products;
//   - the epilogue may use the ring's shared memory once both consumers
//     have passed a barrier after their last products (Epi::smem bytes from
//     the base; the barriers sit past both);
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

constexpr int BM = 128, BK = 64, THREADS = 3 * WG;    // BK: the bf16 K tile (Bf16::BK)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128 * 24 + 256 * 240 <= 65,536
constexpr int A_TILE = BM * 128;                        // bytes of the A tile (BM rows of 128 bytes)
constexpr int PANEL = BK * 128;                         // bytes of one 64-column bf16 W panel (BK rows)
constexpr int DEC_BUFFERS = 3;                          // rotating decoded tiles
constexpr int GROUP_M = 16;                             // row tiles of a band of the raster
constexpr int EPI_BAR = 3;                              // the consumers' named barrier of the epilogue

template <int BN>
struct Tiles {
  static_assert(BN == 128 || BN == 256, "wgmma m64nBNk16 is built at N 128 and 256");
  static constexpr int W_TILE = BN * 128;        // bf16: BN / 64 panels of BK rows; int8: BN rows of 128 bytes
  static constexpr int BYTES = A_TILE + W_TILE;  // the two tiles wgmma reads, A then W
};

// bf16 operands, f32 accumulators; W MN-major (N-contiguous)
struct Bf16 {
  using Acc = float;
  static constexpr int K_STEP = 16, BK = 64;  // elements of one wgmma k step (32 bytes of A's row), of a K tile
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

// int8 operands, s32 accumulators; W K-major (the (N, K) K-contiguous storage): BN rows of 128 bytes
struct S8 {
  using Acc = int;
  static constexpr int K_STEP = 32, BK = 128;  // elements of one wgmma k step (32 bytes of a row), of a K tile
  template <int N>
  __device__ static void mma(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
  // the W operand of k step kk: 32 bytes further along each 128-byte row
  __device__ static uint64_t w_desc(const unsigned char* w, int kk) { return sw128_desc(w + kk * 32); }
};

// d (64 x 128 s32, the f32 accumulator layout) (+)= A (64 x 32 s8, K-major) . B (128 x 32 s8, K-major)^T, both
// in shared memory; scale_d 0 overwrites d
template <>
__device__ __forceinline__ void S8::mma<128>(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Src (the source of a K tile) provides:
//   Params                         kernel parameters (tensor maps, pointers), passed __grid_constant__
//   STAGE, EXTRA                   bytes of a ring stage and of its own shared memory after the ring
//   DECODES                        whether the consumers turn a stage into the tiles themselves
//   groups(p), group_tiles(p, K)   the K groups and the K tiles of each (K tile t: group t / group_tiles)
//   load(p, stage, full, m0, n0, t)      one producer thread: the copies of K tile t, completing on full
//   tiles(p, stage, extra, t, ct)        the consumers (ct 0-255): -> the tiles wgmma reads (A, then W)
// Epi (the epilogue) provides:
//   Params                         its kernel parameters, passed __grid_constant__
//   FOLDS                          whether each K group's products are folded into its State at the group's end
//   State<BN>                      registers of a consumer thread carried over the K groups
//   smem(e)                        bytes of shared memory its finish uses from the base (over the ring)
//   begin_group(e, st, g, row0, M) before K group g's first tile (row0: the thread's first row; the other + 8)
//   fold(e, st, acc, g, row0)      after K group g's products are done (FOLDS)
//   finish(e, st, acc, sm, m0, n0, row0, ct, M, N)   after the last tile, once both consumers have reached it
// The accumulators: this thread's rows row0 and row0 + 8 (acc[4j + e]: row row0 + 8 (e >= 2), column 8j + 2 t4
// + (e & 1) of the warpgroup's 64 x BN tile, t4 = lane % 4).

// int8 operands by TMA: A (M, K) and the weight's (N, K) K-contiguous storage, each K tile a 128-byte-swizzled
// panel of 128 bytes a row straight from TMA (A BM rows, W BN rows). Both are read as 4-D views (k in group,
// group, row, layer): the K groups of group_k columns (the consumer's scale groups; one group of K otherwise)
// are walked in K tiles of 128 that never straddle two groups, and a group's last tile, when group_k % 128 is
// 64, reads zeros past the group's end. The weight may be layer `*layer_idx` of a stack of L (N, K) weights: the
// producer reads the index on the card (clamped to [0, L)), so one tensor map serves every layer.
template <int BN>
struct TmaS8 {
  struct Params {
    CUtensorMap a, w;
    const int* layer_idx;  // null: not a stack
    int L, G, group_k;
  };
  static constexpr int STAGE = Tiles<BN>::BYTES, EXTRA = 0;
  static constexpr bool DECODES = false;
  __device__ static int groups(const Params& p) { return p.G; }
  __device__ static int group_tiles(const Params& p, int) { return (p.group_k + S8::BK - 1) / S8::BK; }
  __device__ static void load(const Params& p, unsigned char* st, uint64_t* full, int m0, int n0, int t) {
    const int tpg = group_tiles(p, 0), g = t / tpg, k0 = (t - g * tpg) * S8::BK;
    int layer = 0;
    if (p.layer_idx != nullptr) {
      layer = __ldg(p.layer_idx);
      layer = layer < 0 ? 0 : (layer >= p.L ? p.L - 1 : layer);
    }
    mbar_expect_tx(full, STAGE);
    tma_load(st, &p.a, full, k0, g, m0, 0);
    tma_load(st + A_TILE, &p.w, full, k0, g, n0, layer);
  }
  __device__ static const unsigned char* tiles(const Params&, const unsigned char* st, unsigned char*, int, int) {
    return st;
  }
  // The tensor maps of a (M, K) int8 and of the (N, K) int8 weight (L of them back to back when a stack) in K
  // groups of K / G; false if the encoder refuses them.
  static bool maps(Params& p, const void* a, const void* w, int M, int N, int K, int G, const int* layer_idx,
                   int L) {
    const cuuint64_t gk = static_cast<cuuint64_t>(K / G), k = static_cast<cuuint64_t>(K);
    const cuuint64_t a_dims[4] = {gk, static_cast<cuuint64_t>(G), static_cast<cuuint64_t>(M), 1};
    const cuuint64_t a_strides[3] = {gk, k, k * M};
    const cuuint64_t w_dims[4] = {gk, static_cast<cuuint64_t>(G), static_cast<cuuint64_t>(N),
                                  static_cast<cuuint64_t>(layer_idx != nullptr ? L : 1)};
    const cuuint64_t w_strides[3] = {gk, k, k * N};
    const cuuint32_t a_box[4] = {S8::BK, 1, BM, 1}, w_box[4] = {S8::BK, 1, BN, 1};
    p.layer_idx = layer_idx;
    p.L = layer_idx != nullptr ? L : 1;
    p.G = G;
    p.group_k = K / G;
    return byte_map_4d(&p.a, a, a_dims, a_strides, a_box) && byte_map_4d(&p.w, w, w_dims, w_strides, w_box);
  }
};

// Bytes from the base of the ring (and of the epilogue's shared memory) to the barriers.
template <int ST, class Src, class Epi>
__host__ __device__ inline int bar_offset(const typename Epi::Params& e) {
  const int ring = ST * Src::STAGE + Src::EXTRA, epi = (Epi::smem(e) + 7) / 8 * 8;
  return ring > epi ? ring : epi;
}

// This block's output tile (m0, n0) in the banded raster over mt row tiles of BM and nt column tiles of bn (one
// block index over mt x nt tiles; a band's last row tile may be a partial one).
__device__ __forceinline__ void band_tile(int mt, int nt, int bn, int& m0, int& n0) {
  const int band = blockIdx.x / (GROUP_M * nt), first = band * GROUP_M, rows = min(GROUP_M, mt - first);
  const int in_band = blockIdx.x - band * GROUP_M * nt;
  m0 = (first + in_band % rows) * BM;
  n0 = in_band / rows * bn;
}

template <class Op, int BN, int ST, class Src, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ typename Src::Params p, const __grid_constant__ typename Epi::Params e,
                     int M, int N, int K) {
  constexpr int OFF_EXTRA = ST * Src::STAGE;
  static_assert(Src::STAGE % 1024 == 0 && Src::EXTRA % 1024 == 0, "tiles 1024-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + bar_offset<ST, Src, Epi>(e));
  uint64_t* empty = full + ST;
  int m0, n0;  // this block's tile in the banded raster over M / BM x ceil(N / BN) tiles
  band_tile(M / BM, (N + BN - 1) / BN, BN, m0, n0);
  const int groups = Src::groups(p), tpg = Src::group_tiles(p, K);

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
      for (int t = 0; t < groups * tpg; ++t) {
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
  const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
  typename Op::Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  typename Epi::template State<BN> st;
  int t = 0;
  for (int g = 0; g < groups; ++g) {
    Epi::begin_group(e, st, g, row0, M);
    for (int i = 0; i < tpg; ++i, ++t) {
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
      for (int kk = 0; kk < Op::BK / Op::K_STEP; ++kk)  // 32 bytes of each A row a k step
        Op::template mma<BN>(acc, sw128_desc(a + kk * 32), Op::w_desc(w, kk), Epi::FOLDS ? (i > 0 || kk > 0) : 1);
      wg_commit();
      wg_wait<1>();  // tile t - 1's products are done
      if (!Src::DECODES && t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % ST);
    }
    wg_wait<0>();
    reg_fence(acc);
    if constexpr (Epi::FOLDS) Epi::fold(e, st, acc, g, row0);
  }
  named_sync(EPI_BAR);  // both consumers' products are done: the ring is free for the epilogue
  Epi::finish(e, st, acc, sm, m0, n0, row0, ct, M, N);
}

// The bf16 store: the accumulators rounded to bf16 -> out (M, N), ld N (the probe's epilogue).
struct StoreBf16 {
  struct Params {
    bf16* out;
  };
  static constexpr bool FOLDS = false;
  template <int BN>
  struct State {};
  __host__ __device__ static int smem(const Params&) { return 0; }
  template <int BN>
  __device__ static void begin_group(const Params&, State<BN>&, int, int, int) {}
  template <int BN>
  __device__ static void finish(const Params& e, State<BN>&, const float (&acc)[BN / 2], unsigned char*, int,
                                int n0, int row0, int ct, int, int N) {
    const int t4 = ct & 3;
    bf16* dst0 = e.out + static_cast<size_t>(row0) * N + n0 + 2 * t4;
    bf16* dst1 = dst0 + static_cast<size_t>(8) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (n0 + 8 * j >= N) break;  // a BN 256 tile past an N that 128 divides
      *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// Shared memory of one launch: the ring, the source's own (or the epilogue's, if larger), the barriers, 1024 to
// align the base.
template <int ST, class Src, class Epi>
int smem_bytes(const typename Epi::Params& e) {
  return bar_offset<ST, Src, Epi>(e) + 16 * ST + 1024;
}

constexpr int MAX_SMEM = 232448;  // the H100's 227 KB a block

template <class Op, int BN, int ST, class Src, class Epi>
int launch(const typename Src::Params& p, const typename Epi::Params& e, int M, int N, int K, cudaStream_t stream) {
  const int bytes = smem_bytes<ST, Src, Epi>(e);
  if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {  // the most any launch may ask; each asks for its own
    cudaError_t err = cudaFuncSetAttribute(gemm_sm90_kernel<Op, BN, ST, Src, Epi>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int grid = (N + BN - 1) / BN * (M / BM);
  gemm_sm90_kernel<Op, BN, ST, Src, Epi><<<grid, THREADS, bytes, stream>>>(p, e, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm90
}  // namespace
