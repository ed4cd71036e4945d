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
//     for the bf16 probe, gemm_probe_i8.cu's ProbeEpi for the int8 one).
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
//
// The warpgroup-0 decoding form (gemm_w4_kernel, the packed-int4 w4a8 GEMMs:
// gemm_w4a8.cu and the W4 form of gemm_w8a8_gelu_quant.cu) is the s8 loop
// with the same consumers and epilogues, fed by W4Src: packed int4 codes
// decoded to int8 on warpgroup 0's four warps, which also copy (its first
// thread), ahead of the products. See W4Src below.
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

// d (64 x 256 s32, the f32 accumulator layout) (+)= A (64 x 32 s8, K-major) . B (256 x 32 s8, K-major)^T, both
// in shared memory; scale_d 0 overwrites d
template <>
__device__ __forceinline__ void S8::mma<256>(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
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

// Output tile v's (m0, n0) in the banded raster over mt row tiles of BM and nt column tiles of bn (one index over
// mt x nt tiles; a band's last row tile may be a partial one).
__device__ __forceinline__ void band_tile(int v, int mt, int nt, int bn, int& m0, int& n0) {
  const int band = v / (GROUP_M * nt), first = band * GROUP_M, rows = min(GROUP_M, mt - first);
  const int in_band = v - band * GROUP_M * nt;
  m0 = (first + in_band % rows) * BM;
  n0 = in_band / rows * bn;
}

// This block's output tile: tile blockIdx.x of the banded raster.
__device__ __forceinline__ void band_tile(int mt, int nt, int bn, int& m0, int& n0) {
  band_tile(static_cast<int>(blockIdx.x), mt, nt, bn, m0, n0);
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

// The bf16 store: the accumulators rounded to bf16 -> out (M, N), ld N (the bf16 probe's epilogue).
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

// ---------------------------------------------------------------------------
// The warpgroup-0 decoding form: packed int4 weights decoded to int8 tiles by warpgroup 0
// ---------------------------------------------------------------------------
//
// W4Src feeds gemm_w4_kernel's s8 products from the packed w4a8 weight: codes (K/2, N) int8, N-contiguous, in
// the block-split-half layout (packed row 128 b + j holds k = 256 b + j in its low nibble and 256 b + 128 + j in
// its high one), with bf16 rescales (K/64, N); code c of row k, column n is the int8
// clip(round_half_even(f32(c) * f32(rescale[k / 64, n])), +-127), the value the dequant kernel writes.
//   - A (M, K) int8 reaches a 5-stage ring by TMA as TmaS8's A does (4-D view: K groups of group_k, a group's
//     last tile zero past its end, rows past M zero).
//   - W reaches a 3-stage ring of raw boxes by TMA, a box per 256 k: the 128 packed rows of pack block b (BN
//     columns, both nibble planes) and their 4 rescale rows; the stack's layer is the box's third coordinate,
//     read on the card. A byte is read from device memory once a row tile (the WMMA loop read it twice).
//   - Warpgroup 0's four warps decode: warp w takes quarter w of each box (plane w / 2, packed rows 64 (w % 2)
//     .. + 63, i.e. the 64 consecutive k of rescale row 4 b + w) into its place in a W tile: K-major int8, BN
//     rows of 128 bytes, 128-byte swizzled, the tile TmaS8's W is, in four rotating buffers, so decoding runs
//     up to three K tiles ahead of the products. K tiles follow the consumers' walk: tile t covers k 128 i of K
//     group g (t = g tpg + i), its two 64-k halves come from one box (or, when group_k % 128 == 64, from two,
//     and a group's last tile has one half: A is zero past the group, so its other half is left as it is).
//   - A lane decodes four columns: per column one 16-entry int8 table of its rescale group (the 16 values a
//     code can take, 16 multiplies for 64 codes), looked up by byte permutes; two rows of codes are one
//     selector byte (A / B below), four rows one 16-bit selector, so a column's 4 k are one 32-bit word. A lane
//     starts its 16-row steps at (lane / 2) % 4: the 16-byte stores of eight lanes then hit eight different
//     chunks of the swizzle (no bank conflict); its 32-bit loads of a packed row read 128 contiguous bytes.
//   - A lane loads all of its 64 words of a quarter first, then decodes and stores (the compiler cannot move a
//     load above a store to shared memory it does not know is elsewhere: loads interleaved with the stores
//     measured 1.26x slower).
//   - The decoders move through the boxes together (a barrier of warpgroup 0 a box): at a box's start every
//     quarter of the previous box is decoded, so its first thread refills that stage. The A tiles are copied
//     by the first consumer thread, ST_A - 1 tiles ahead, as soon as both consumers are past a stage's tile:
//     copied by the decoders' thread at box starts they made the decoders wait on the consumers, measured
//     1.25x slower; copied by each consumer warpgroup for its own 64 rows, 2-4% slower than one copy.
// Registers: the decoders keep the launch's 168 (no setmaxnreg): PRODUCER_REGS' 24 serve a copy-only producer,
// and 128 x 168 + 256 x 168 = 64,512 of the 65,536 is the most the decoders can have beside consumers at
// ptxas's 168, which is what the s8 consumers are built for.
struct W4Src {
  static constexpr int BN = 128, ST_A = 5, ST_W = 3, DEC = 4;
  static constexpr int CODES = 128 * BN;                     // a box's packed rows
  static constexpr int RAW = CODES + 4 * BN * 2;             // + its 4 rescale rows (bf16): 17,408 bytes
  static constexpr int W_TILE = BN * 128;                    // a decoded K tile
  static constexpr int OFF_RAW = ST_A * A_TILE, OFF_DEC = OFF_RAW + ST_W * RAW, RING = OFF_DEC + DEC * W_TILE;
  static constexpr int BARS = 2 * ST_A + ST_W + 2 * DEC;     // afull, aempty, rfull, wfull, wempty
  static constexpr int DEC_BAR = 4;                          // warpgroup 0's named barrier
  static_assert(RAW % 1024 == 0 && OFF_DEC % 1024 == 0, "tiles 1024-byte aligned");
  struct Params {
    CUtensorMap a, w, rs;
    const int* layer_idx;  // null: not a stack
    int L, G, group_k;
  };
  // The tensor maps of qact (M, K) int8 in K groups of K / G, the packed codes (K/2, N) (L of them back to back
  // when a stack) and the rescales (K/64, N) bf16; false if the encoder refuses one.
  static bool maps(Params& p, const void* a, const void* qw, const void* rs, int M, int N, int K, int G,
                   const int* layer_idx, int L) {
    const cuuint64_t gk = static_cast<cuuint64_t>(K / G), k = static_cast<cuuint64_t>(K), n = N;
    const cuuint64_t a_dims[4] = {gk, static_cast<cuuint64_t>(G), static_cast<cuuint64_t>(M), 1};
    const cuuint64_t a_strides[3] = {gk, k, k * M};
    const cuuint32_t a_box[4] = {S8::BK, 1, BM, 1};
    p.layer_idx = layer_idx;
    p.L = layer_idx != nullptr ? L : 1;
    p.G = G;
    p.group_k = K / G;
    const cuuint64_t w_dims[3] = {n, k / 2, static_cast<cuuint64_t>(p.L)}, w_str[2] = {n, k / 2 * n};
    const cuuint32_t w_box[3] = {BN, 128, 1};
    const cuuint64_t rs_dims[2] = {n, k / 64}, rs_str[1] = {2 * n};
    const cuuint32_t rs_box[2] = {BN, 4};
    return byte_map_4d(&p.a, a, a_dims, a_strides, a_box) &&
           tensor_map(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, qw, w_dims, w_str, w_box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
           tensor_map(&p.rs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rs, rs_dims, rs_str, rs_box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  // K tile and half of logical k (a multiple of 64) in the consumers' walk; width: the tile's k (128, or 64 for
  // a group's last tile when group_k % 128 == 64)
  __device__ static void locate(const Params& p, int tpg, int k, int& t, int& slot, int& width) {
    const int g = k / p.group_k, in = k - g * p.group_k;
    t = g * tpg + (in >> 7);
    slot = (in >> 6) & 1;
    width = min(128, p.group_k - (in & ~127));
  }
};

// (a & b) | c in one LOP3 (the compiler splits it when b and c are both immediates; also gemm_w4a4.cu's)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (a & c) | (b & ~c) and a & b in one LOP3 each, opaque to the compiler (which otherwise splits the first into
// two LOP3s with immediates and moves the second past the permutes that use it, once a column)
__device__ __forceinline__ uint32_t w4_select(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t w4_and(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("and.b32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bytes 0 of a, b, c, d as one word
__device__ __forceinline__ uint32_t w4_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The 16 int8 values of the codes under rescale r: t[0..1] codes 0 .. 7, t[2..3] codes -8 .. -1 (byte i of the
// pair: code i, or i - 8). Each value is round_half_even(clip(c r, +-127)) (the same as clipping after the
// rounding, 127 being an integer): x + 1.5 * 2^23 in one f32 rounding leaves the integer in the low bits, two's
// complement in the low byte; codes c and -c take +-x of one product (rounding is symmetric).
__device__ __forceinline__ void w4_table(float r, uint32_t (&t)[4]) {
  constexpr float MAGIC = 12582912.f;
  const float a = fabsf(r), sg = r < 0.f ? -1.f : 1.f;
  uint32_t pos[8], neg[8];  // codes 1 .. 8 and -1 .. -8
#pragma unroll
  for (int c = 1; c <= 8; ++c) {
    const float x = fminf(__fmul_rn(static_cast<float>(c), a), 127.f);
    pos[c - 1] = __float_as_uint(__fmaf_rn(sg, x, MAGIC));
    neg[c - 1] = __float_as_uint(__fmaf_rn(-sg, x, MAGIC));
  }
  t[0] = w4_bytes(0u, pos[0], pos[1], pos[2]);
  t[1] = w4_bytes(pos[3], pos[4], pos[5], pos[6]);
  t[2] = w4_bytes(neg[7], neg[6], neg[5], neg[4]);
  t[3] = w4_bytes(neg[3], neg[2], neg[1], neg[0]);
}

// Quarter w of a raw box (PLANE = w / 2: the low or high nibbles of packed rows 64 (w % 2) .. + 63, rescale row
// w) decoded by one warp into k bytes [64 slot, 64 slot + 64) of a W tile. Lane l takes columns 4 l .. 4 l + 3.
// Four packed rows W0..W3 (a 32-bit load each: the lane's four columns) make two selector words, A from rows 0
// and 1 (byte j: the two codes of column j) and B from rows 2 and 3; for column j, permutes of A and B give the
// four codes' low three bits (which byte of a table pair) and their sign bits (which pair), and three more
// permutes the four int8 values, k in order in one word.
template <int PLANE>
__device__ __forceinline__ void w4_decode_quarter(const unsigned char* raw, int w, unsigned char* wt, int slot,
                                                  int lane) {
  // every load first (independent of the stores that follow, which the compiler cannot see): the lane's 32-bit
  // word of the 64 packed rows, in the order of its steps
  const unsigned char* rows = raw + (64 * (w & 1)) * W4Src::BN + 4 * lane;
  uint32_t wd[64];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = (s + (lane >> 1)) & 3;  // step s's 16 k: rows 16 c .. 16 c + 15 of the quarter
#pragma unroll
    for (int i = 0; i < 16; ++i) wd[16 * s + i] = *reinterpret_cast<const uint32_t*>(rows + (16 * c + i) * W4Src::BN);
  }
  const uint2 rsv = *reinterpret_cast<const uint2*>(raw + W4Src::CODES + w * (W4Src::BN * 2) + 8 * lane);
  uint32_t t[4][4];
  w4_table(__uint_as_float(rsv.x << 16), t[0]);
  w4_table(__uint_as_float(rsv.x & 0xFFFF0000u), t[1]);
  w4_table(__uint_as_float(rsv.y << 16), t[2]);
  w4_table(__uint_as_float(rsv.y & 0xFFFF0000u), t[3]);
  const uint32_t M44 = 0x44444444u, LO = 0x10101010u, HI = 0x32323232u, M0F = 0x0F0F0F0Fu, M77 = 0x77777777u;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = (s + (lane >> 1)) & 3;
    uint32_t o[4][4];  // [column][4 k]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t w0 = wd[16 * s + 4 * q], w1 = wd[16 * s + 4 * q + 1];
      const uint32_t w2 = wd[16 * s + 4 * q + 2], w3 = wd[16 * s + 4 * q + 3];
      // byte j of A: row 0's code of column j in the low nibble, row 1's in the high one; B: rows 2 and 3
      const uint32_t A = PLANE ? w4_select(w0 >> 4, w1, M0F) : w4_select(w0, w1 << 4, M0F);
      const uint32_t B = PLANE ? w4_select(w2 >> 4, w3, M0F) : w4_select(w2, w3 << 4, M0F);
      const uint32_t magA = w4_and(A, M77), magB = w4_and(B, M77);  // each code's index in its table pair
      // each code's pair, as the selector of the final permute: nibble i = i + 4 (sign of code i)
      const uint32_t hA = and_or(A >> 1, M44, LO), hB = and_or(B >> 1, M44, HI);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t sel = static_cast<uint32_t>(j | ((j + 4) << 4));  // byte j of A, then byte j of B
        const uint32_t mag = __byte_perm(magA, magB, sel);
        const uint32_t lo = __byte_perm(t[j][0], t[j][1], mag), hi = __byte_perm(t[j][2], t[j][3], mag);
        o[j][q] = __byte_perm(lo, hi, __byte_perm(hA, hB, sel));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * lane + j;
      *reinterpret_cast<uint4*>(wt + n * 128 + (((4 * slot + c) ^ (n & 7)) << 4)) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    }
  }
}

// Bytes from the base of the ring (and of the epilogue's shared memory) to the barriers.
template <class Epi>
__host__ __device__ inline int w4_bar_offset(const typename Epi::Params& e) {
  const int epi = (Epi::smem(e) + 7) / 8 * 8;
  return W4Src::RING > epi ? W4Src::RING : epi;
}

template <class Epi>
int w4_smem_bytes(const typename Epi::Params& e) {
  return w4_bar_offset<Epi>(e) + 8 * W4Src::BARS + 1024;
}

// The s8 GEMM of the packed weight: gemm_sm90_kernel's consumers and epilogue (BN 128) on W4Src's tiles.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_w4_kernel(const __grid_constant__ W4Src::Params p, const __grid_constant__ typename Epi::Params e, int M,
                   int N, int K) {
  using S = W4Src;
  constexpr int BN = S::BN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* afull = reinterpret_cast<uint64_t*>(sm + w4_bar_offset<Epi>(e));
  uint64_t* aempty = afull + S::ST_A;
  uint64_t* rfull = aempty + S::ST_A;
  uint64_t* wfull = rfull + S::ST_W;
  uint64_t* wempty = wfull + S::DEC;
  unsigned char* dec = sm + S::OFF_DEC;
  int m0, n0;
  band_tile((M + BM - 1) / BM, N / BN, BN, m0, n0);
  const int groups = p.G, tpg = (p.group_k + S8::BK - 1) / S8::BK, T = groups * tpg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::ST_A; ++s) {
      mbar_init(afull + s, 1);
      mbar_init(aempty + s, 8);  // the consumers' eight warps
    }
#pragma unroll
    for (int s = 0; s < S::ST_W; ++s) mbar_init(rfull + s, 1);
#pragma unroll
    for (int b = 0; b < S::DEC; ++b) {
      mbar_init(wfull + b, 2);  // a tile's two halves (a one-half tile arrives twice at once)
      mbar_init(wempty + b, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- warpgroup 0: the decoders; its first thread issues the boxes' copies ----
    const int nb = K / 256;
    int layer = 0;
    auto load_box = [&](int b) {
      unsigned char* raw = sm + S::OFF_RAW + (b % S::ST_W) * S::RAW;
      mbar_expect_tx(rfull + b % S::ST_W, S::RAW);
      tma_load_3d(raw, &p.w, rfull + b % S::ST_W, n0, 128 * b, layer);
      tma_load_2d(raw + S::CODES, &p.rs, rfull + b % S::ST_W, n0, 4 * b);
    };
    if (threadIdx.x == 0) {
      if (p.layer_idx != nullptr) {
        layer = __ldg(p.layer_idx);
        layer = layer < 0 ? 0 : (layer >= p.L ? p.L - 1 : layer);
      }
      for (int b = 0; b < S::ST_W && b < nb; ++b) load_box(b);
    }
    for (int b = 0; b < nb; ++b) {
      if (b > 0) wg_sync(S::DEC_BAR);  // every quarter of box b - 1 is decoded: its stage is free
      if (threadIdx.x == 0 && b > 0 && b + S::ST_W - 1 < nb) load_box(b + S::ST_W - 1);
      __syncwarp();
      int t, slot, width;
      S::locate(p, tpg, 256 * b + 64 * warp, t, slot, width);
      mbar_wait(rfull + b % S::ST_W, (b / S::ST_W) & 1);
      mbar_wait(wempty + t % S::DEC, ((t / S::DEC) & 1) ^ 1);  // tile t - DEC's products are done
      const unsigned char* raw = sm + S::OFF_RAW + (b % S::ST_W) * S::RAW;
      if (warp < 2)
        w4_decode_quarter<0>(raw, warp, dec + (t % S::DEC) * S::W_TILE, slot, lane);
      else
        w4_decode_quarter<1>(raw, warp, dec + (t % S::DEC) * S::W_TILE, slot, lane);
      fence_proxy_async();  // the tile's stores, visible to wgmma's reads
      __syncwarp();
      if (lane == 0) mbar_arrive_cnt(wfull + t % S::DEC, width == 128 ? 1 : 2);
    }
    return;
  }

  // ---- consumers: 64 rows a warpgroup (gemm_sm90_kernel's); the first thread issues the A tiles ----
  const int ct = threadIdx.x - WG, cw = ct / WG, cwarp = (ct % WG) / 32;
  auto load_a = [&](int a) {
    const int s = a % S::ST_A, g = a / tpg;
    mbar_expect_tx(afull + s, A_TILE);
    tma_load(sm + s * A_TILE, &p.a, afull + s, (a - g * tpg) * S8::BK, g, m0, 0);
  };
  if (ct == 0) {
    for (int a = 0; a < S::ST_A && a < T; ++a) load_a(a);
  }
  const int row0 = m0 + cw * 64 + cwarp * 16 + (lane >> 2);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  typename Epi::template State<BN> st;
  int t = 0;
  for (int g = 0; g < groups; ++g) {
    Epi::begin_group(e, st, g, row0, M);
    for (int i = 0; i < tpg; ++i, ++t) {
      const int s = t % S::ST_A, b = t % S::DEC;
      mbar_wait(afull + s, (t / S::ST_A) & 1);
      mbar_wait(wfull + b, (t / S::DEC) & 1);
      const unsigned char* a = sm + s * A_TILE + cw * 64 * 128;
      const unsigned char* w = dec + b * S::W_TILE;
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S8::BK / S8::K_STEP; ++kk)
        S8::mma<BN>(acc, sw128_desc(a + kk * 32), S8::w_desc(w, kk), Epi::FOLDS ? (i > 0 || kk > 0) : 1);
      wg_commit();
      wg_wait<1>();  // tile t - 1's products are done: its A stage and W tile go back
      if (t > 0) {
        if (lane == 0) {
          mbar_arrive(aempty + (t - 1) % S::ST_A);
          mbar_arrive(wempty + (t - 1) % S::DEC);
        }
        if (ct == 0 && t - 1 + S::ST_A < T) {  // once both warpgroups are past tile t - 1, its stage's next tile
          mbar_wait(aempty + (t - 1) % S::ST_A, ((t - 1) / S::ST_A) & 1);
          load_a(t - 1 + S::ST_A);
        }
      }
    }
    wg_wait<0>();
    reg_fence(acc);
    if constexpr (Epi::FOLDS) Epi::fold(e, st, acc, g, row0);
  }
  named_sync(EPI_BAR);  // both consumers' products are done: the ring is free for the epilogue
  Epi::finish(e, st, acc, sm, m0, n0, row0, ct, M, N);
}

template <class Epi>
int launch_w4(const W4Src::Params& p, const typename Epi::Params& e, int M, int N, int K, cudaStream_t stream) {
  const int bytes = w4_smem_bytes<Epi>(e);
  if (bytes > MAX_SMEM || K % 256 != 0 || N % W4Src::BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {  // the most any launch may ask; each asks for its own
    cudaError_t err =
        cudaFuncSetAttribute(gemm_w4_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int grid = (N / W4Src::BN) * ((M + BM - 1) / BM);
  gemm_w4_kernel<Epi><<<grid, THREADS, bytes, stream>>>(p, e, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm90
}  // namespace
