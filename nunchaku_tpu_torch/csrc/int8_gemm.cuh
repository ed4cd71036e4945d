// The low-rank tiles of the int8 chain kernels' epilogues (gemm_w8a8_gelu_quant.cu, grouped_epi.cuh,
// gemm_w8a8_gelu_quant_pipe.cu): bf16(lora_act) and proj_up of one chunk of at most RANK_CHUNK ranks staged in
// shared memory (LoraRows, lora_rows, stage_lora_rows), and the rank-R sums of a thread's 4 x 16 block of a 128 x
// 128 output tile in the order of the WMMA kernels those epilogues replaced (lora_sums_4x16, lora_sums_all), so
// their outputs stay that arithmetic bit for bit. The kernels' products run on gemm_sm90.cuh's s8 loop.
#pragma once

#include "common.cuh"

namespace i8gemm {

constexpr int BM = 128, BN = 128;  // the output tile the low-rank sums cover
constexpr int RANK_CHUNK = 128;    // low-rank widths are staged and summed in chunks of this many ranks

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// The s8 epilogues' low-rank tiles (gemm_w8a8_gelu_quant.cu, grouped_epi.cuh): one chunk of at most
// RANK_CHUNK ranks, bf16(lora_act[m0:, j0:j0 + R]) row-major, rows ld = R rounded up to 8, plus 8, apart
// (16-byte aligned rows: eight ranks a load), and proj_up[j0:j0 + R, n0:] [R][BN]; lora_rows_bytes(R) bytes from
// `base`. A rank above RANK_CHUNK runs its chunks one after another through the same tiles, so shared memory
// stays that of rank RANK_CHUNK.
struct LoraRows {
  bf16* la;
  bf16* pu;
  int R, ld;
};

__host__ __device__ constexpr int lora_chunk(int R) { return R < RANK_CHUNK ? R : RANK_CHUNK; }

__host__ __device__ constexpr int lora_rows_ld(int R) { return (R + 7) / 8 * 8 + 8; }

__host__ __device__ constexpr size_t lora_rows_bytes(int R) {
  return R == 0 ? 0
                : align128(static_cast<size_t>(BM) * lora_rows_ld(R) * sizeof(bf16)) +
                      align128(static_cast<size_t>(R) * BN * sizeof(bf16));
}

__device__ __forceinline__ LoraRows lora_rows(unsigned char* base, int R) {
  return LoraRows{reinterpret_cast<bf16*>(base),
                  reinterpret_cast<bf16*>(base + align128(static_cast<size_t>(BM) * lora_rows_ld(R) * sizeof(bf16))),
                  R, lora_rows_ld(R)};
}

// The tiles of lr (lr.R ranks from rank j0) by `threads` threads (index ct), the loads in flight together:
// proj_up's rows (pu: row j0 of the (R_all, N) proj_up) by 16-byte cp.async copies, lora_act's rows (la: column
// j0 of the (M, ld_la) lora_act) by batches of float4 loads (scalar when a row's ranks are not 16-byte aligned);
// rows at or past M are zeros. The caller waits for the copies (cp_async_wait<0>) and synchronises its threads
// before reading them.
__device__ __forceinline__ void stage_lora_rows(const LoraRows& lr, const float* __restrict__ la, int ld_la,
                                                const bf16* __restrict__ pu, int m0, int n0, int N, int M, int ct,
                                                int threads) {
  const int R = lr.R;
  for (int i = ct; i < R * (BN / 8); i += threads) {
    const int j = i / (BN / 8), c = i % (BN / 8);
    cp_async16(lr.pu + j * BN + 8 * c, pu + static_cast<size_t>(j) * N + n0 + 8 * c, true);
  }
  cp_async_commit();
  if (R % 4 == 0 && ld_la % 4 == 0) {  // item i: row i / (R / 4), ranks 4 (i % (R / 4)) .. + 3
    constexpr int BATCH = 4;
    const int q = R / 4;
    for (int i0 = ct; i0 < BM * q; i0 += BATCH * threads) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * threads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < BM * q && m0 + i / q < M)
          v[u] = __ldg(reinterpret_cast<const float4*>(la + static_cast<size_t>(m0 + i / q) * ld_la + 4 * (i % q)));
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * threads;
        if (i < BM * q) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(lr.la + (i / q) * lr.ld + 4 * (i % q));
          d[0] = __floats2bfloat162_rn(v[u].x, v[u].y);
          d[1] = __floats2bfloat162_rn(v[u].z, v[u].w);
        }
      }
    }
  } else {
    for (int i = ct; i < BM * R; i += threads) {
      const int r = i / R, j = i % R;
      lr.la[r * lr.ld + j] =
          __float2bfloat16(m0 + r < M ? __ldg(la + static_cast<size_t>(m0 + r) * ld_la + j) : 0.f);
    }
  }
}

// The rank sums of the WMMA kernels' epilogue for a thread's 4 x 16 block of the tile (the s8 epilogues' thread
// tile: rows r0 .. r0 + 3, columns c0 .. c0 + 7 and c0 + 64 .. c0 + 71), one chunk's ranks added on: s[8 (2q + h)
// + i] = fmaf(bf16(la[r0 + q, j]), pu[j, c0 + 64h + i], s[..]) over the chunk's j in order. The caller zeroes s
// before the first chunk, so the chunks give the products and the order of one pass over all ranks. Eight ranks
// of a row are one 16-byte load; eight threads with c0 = 0, 8, .., 56 read 128 contiguous bytes of a proj_up row.
__device__ __forceinline__ void lora_sums_4x16(const LoraRows& lr, float (&s)[64], int r0, int c0) {
  auto rank = [&](int j, const float (&a)[4]) {
    const bf16* prow = lr.pu + static_cast<size_t>(j) * BN + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 raw = *reinterpret_cast<const uint4*>(prow + 64 * h);
      const bf16* p = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[8 * (2 * q + h) + i] = fmaf(a[q], bf2f(p[i]), s[8 * (2 * q + h) + i]);
    }
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

// s = the rank-R sums of lora_sums_4x16 over all R ranks of lora_act (M, R) and proj_up (R, N), where the first
// chunk (lora_chunk(R) ranks) is staged in lr0 and read (the threads synchronised after its staging); each
// further chunk is staged through the same tiles between two barriers (`sync`: every thread that stages and
// reads them).
template <class Sync>
__device__ __forceinline__ void lora_sums_all(const LoraRows& lr0, const float* la, const bf16* pu, int R, int m0,
                                              int n0, int N, int M, int ct, int threads, float (&s)[64], int r0,
                                              int c0, unsigned char* base, Sync sync) {
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  lora_sums_4x16(lr0, s, r0, c0);
  for (int j0 = RANK_CHUNK; j0 < R; j0 += RANK_CHUNK) {
    const LoraRows lr = lora_rows(base, lora_chunk(R - j0));
    sync();  // every thread has read the previous chunk
    stage_lora_rows(lr, la + j0, R, pu + static_cast<size_t>(j0) * N, m0, n0, N, M, ct, threads);
    cp_async_wait<0>();
    sync();
    lora_sums_4x16(lr, s, r0, c0);
  }
}

}  // namespace i8gemm
