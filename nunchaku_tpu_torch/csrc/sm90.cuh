// The sm_90a building blocks shared by the attention core (flash_sm90.cuh)
// and the GEMM main loop (gemm_sm90.cuh): mbarriers, TMA and bulk copies,
// wgmma descriptors and fences, named barriers between the consumer
// warpgroups, setmaxnreg, and the host's tensor-map encoder.
//
// A barrier wait that spins for seconds (a lost arrival) traps instead of
// hanging the card.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime (no -lcuda)
#include <string.h>

#include "mma.cuh"

namespace {
namespace sm90 {

constexpr int WG = 128;  // threads of a warpgroup

// ---------------------------------------------------------------------------
// barriers and copies
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

// `count` arrivals at once.
__device__ __forceinline__ void mbar_arrive_cnt(uint64_t* bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
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

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// One box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 2-D tensor map (c0 the contiguous coordinate) into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// One box of a 2-D tensor map (c0 the contiguous coordinate) from shared memory to global memory, in the issuing
// thread's open bulk group; rows and columns past the map's dimensions are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Until at most N of the issuing thread's bulk groups are still reading their shared memory (READ), or still
// writing at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// An int32 of magnitude below 2^22 as an f32, exactly, on the full-rate
// pipes (IADD, FADD) instead of the quarter-rate I2F: its bits added to those
// of 1.5 * 2^23, minus 1.5 * 2^23.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.f;
}

// Shared-memory writes by ordinary stores, made visible to the asynchronous
// proxy (wgmma's operand reads) before a product is issued on them.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// wgmma descriptors and fences
// ---------------------------------------------------------------------------

// wgmma descriptor of a tile of 128-byte rows in the 128-byte swizzle: start
// address, 1024 bytes (eight rows) between 8-row groups (the stride offset),
// swizzle mode 1. The leading offset (in 16-byte units) is the distance
// between two 64-column panels of an MN-major operand wider than 64; a
// K-major operand, or an MN-major one 64 columns wide, does not read it.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lead16 = 1) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead16 & 0x3FFF) << 16) |
         (64ull << 32) | (1ull << 62);
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
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Named barriers of the two consumer warpgroups (ids 1 and up, 256 threads).
__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

// A named barrier of one warpgroup's 128 threads (ids above the two-warpgroup ones).
__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// ---------------------------------------------------------------------------
// thread-block clusters: the blocks of a cluster meet at a barrier and read
// each other's shared memory (distributed shared memory)
// ---------------------------------------------------------------------------

// Every thread of every block of the cluster; this block's shared-memory
// writes before it are visible to the others' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of p (in this block's shared memory) in block `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ float ld_cluster(unsigned a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(unsigned a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The card's SM count (132 on an H100 SXM if the runtime cannot say), read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
                                                   cudaSuccess)
      n = 132;
  }
  return n;
}

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

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

// The tensor map of a row-major (rows, cols) matrix of `elem`-byte elements
// (1: uint8, 2: bf16), rows `ld` elements apart, in boxes of box_cols x
// box_rows; swizzled: the 128-byte swizzle (box_cols * elem == 128).
inline bool matrix_map(CUtensorMap* map, const void* base, int elem, int rows, int cols, int ld, int box_rows,
                       int box_cols, bool swizzled) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of an array of `rank` (<= 5) dimensions of `type` (dims[0] the contiguous one; strides in bytes
// of dims 1 .. rank - 1, multiples of 16) in boxes of box[0 .. rank - 1]; a box reaching past a dimension reads
// zeros there. Encoded maps are kept by everything the encoder reads (the same inputs always give the same map),
// so a launch on the pointers and shapes of an earlier one encodes nothing; they sit in 256 sets of 4 picked by a
// hash of those inputs, so a lookup costs the same however many maps are kept.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* base;
    cuuint64_t dims[5], strides[4];
    cuuint32_t box[5];
    int type, rank, swizzle;
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  static_assert(sizeof(Key) % 8 == 0, "the hash reads the key in 8-byte words");
  constexpr int SETS = 256, WAYS = 4;
  static Entry cache[SETS][WAYS];
  static int used[SETS], next[SETS];
  Key key;
  memset(&key, 0, sizeof key);  // padding and unused dimensions compare equal
  key.base = base;
  memcpy(key.dims, dims, rank * sizeof(cuuint64_t));
  memcpy(key.strides, strides, (rank - 1) * sizeof(cuuint64_t));
  memcpy(key.box, box, rank * sizeof(cuuint32_t));
  key.type = static_cast<int>(type);
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  uint64_t h = 0;  // the key's words, each mixed in by the MurmurHash3 finalizer
  for (size_t i = 0; i < sizeof key; i += 8) {
    uint64_t w;
    memcpy(&w, reinterpret_cast<const unsigned char*>(&key) + i, 8);
    h ^= w;
    h = (h ^ (h >> 33)) * 0xff51afd7ed558ccdull;
    h = (h ^ (h >> 33)) * 0xc4ceb9fe1a85ec53ull;
    h ^= h >> 33;
  }
  const int set = static_cast<int>(h % SETS);
  for (int i = 0; i < used[set]; ++i) {
    if (memcmp(&cache[set][i].key, &key, sizeof key) == 0) {
      *map = cache[set][i].map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[set][next[set]].key = key;
  cache[set][next[set]].map = *map;
  next[set] = (next[set] + 1) % WAYS;
  used[set] = used[set] < WAYS ? used[set] + 1 : WAYS;
  return true;
}

// The tensor map of a 4-D uint8 array (dims[0] the contiguous one; strides in bytes of dims 1-3, multiples of
// 16) in boxes of box[0..3] with the 128-byte swizzle (box[0] = 128), kept as tensor_map keeps it.
inline bool byte_map_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                        const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Launch kernel on a grid whose x dimension is cut into clusters of `cluster_x` blocks (x a multiple of it).
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster_x,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace sm90
}  // namespace
