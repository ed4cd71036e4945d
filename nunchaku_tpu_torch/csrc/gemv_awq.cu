// AWQ W4A16 GEMV: bf16 activations (M <= 8 rows) times 4-bit asymmetric
// weights, f32 result.
//
// Replaces nunchaku_tpu/ops/gemv.py _gemv_kernel (:25, launched by
// awq_w4a16_linear :58):
//   w = bf16(q * s[g(k), n] - z[g(k), n])   (q an unsigned nibble)
//   out = x @ w  (f32 accumulation)  + bias
// with g(k) = k / 64 and the (K/2, N) weight packed along K in the
// block-split-half order (byte j of pack block b holds k = 256b + j in its
// low nibble and 256b + 128 + j in its high one).
//
// Bound on the H100: bytes (the packed weight; at M 1, K 3072, N 18432 it
// reads 28.3 MB of codes and 3.5 MB of scales and zeros, 9.5 us at
// 3.35 TB/s). The decode is the rest: at ~8 ALU operations a weight, as
// CUDA cores that convert each nibble to f32 and multiply-add it into M sums
// spend them, 56.6 M weights take ~15 us on 132 SMs, above the byte time.
// Design:
//   - The products run on the tensor cores: out^T (N x M) = W^T (N x K) .
//     x^T (K x M) as mma.sync m16n8k16, the weight the A operand, x the B
//     operand (M <= 8 rows fill n8 exactly; rows past M are zero). Which
//     16 k and 16 columns an mma takes is free as long as A and B agree: k
//     slots (2i, 2i + 1) are the low and high nibble of one packed byte, so
//     a byte decodes straight into one bf16x2 A register (q_lo, q_hi), with
//     the scale and zero pairs (s[g], s[g + 2]) of its two groups.
//   - Decode, two weights at a time: one PRMT puts the byte's two nibbles
//     into the two halves, one LOP3 keeps them and ors in 0x4300 (bf16 128 +
//     q), one bf16x2 FMA takes 128 away (exact), one bf16x2 FMA forms
//     q s - z rounded once to bf16. The f32 formula rounds q s - z to f32
//     first and then to bf16: q s is exact in f32, so the two agree unless
//     the f32 subtraction itself rounds onto a bf16 tie (double rounding).
//   - A warp walks a slab of 64 packed rows (one pair of scale groups) x 128
//     columns in two steps of 32 rows. Lane (g, t4) holds rows 8i + t4 and
//     8i + 4 + t4 of columns 16g .. 16g + 15 (mma n slot g (g + 8) of n-tile
//     T is column 16g + 2T (+ 1)): 8 loads of 16 bytes a step, 8 lanes span
//     the 128 columns of a row, so each load instruction reads four whole
//     128-byte rows. The next step's loads are issued before this step's
//     decode, so a warp keeps 4 KB in flight (~8.7 warps a SM); a slab's
//     scale and zero rows load as it opens. (Slower, on the card: a cp.async
//     ring of four steps a warp, 12 KB in flight; the scales prefetched a
//     step ahead, 199 registers, or capped to 168 with spills.)
//   - A block is 4 warps on one 128-column strip and a range of slabs; the
//     warps take its slabs in turn. A thread-block cluster of ks blocks along
//     K splits a strip's slabs, so N 9216 or 18432 at K 3072 makes 288
//     blocks, all resident at once: the warps' sums meet in shared memory
//     (warp order), the cluster's in the leader through distributed shared
//     memory (rank order; the remote loads issued together), which adds the
//     bias and stores. One launch, no scratch in device memory, no atomics:
//     results are the same bit for bit run to run.
#include "sm90.cuh"

namespace {

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int COLS = 128;  // columns of a block's strip
constexpr int SLAB = 64;   // packed rows of a slab: one pair of scale groups
constexpr int STEP = 32;   // packed rows of a step (4 row groups of 8)
constexpr int MAXM = 8;
constexpr int MAX_KS = 8, TARGET_BLOCKS = 264;  // two blocks a SM on the H100's 132

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Byte `B` of u (v = u >> 4) -> bf16x2 (q_lo s_lo - z_lo, q_hi s_hi - z_hi), each rounded once; nz = -z.
template <int B>
__device__ __forceinline__ uint32_t decode(uint32_t u, uint32_t v, uint32_t s, uint32_t nz) {
  constexpr uint32_t sel = B | (B << 4) | ((4 + B) << 8) | ((4 + B) << 12);  // [u.B, u.B, v.B, v.B]
  const uint32_t q128 = (prmt(u, v, sel) & 0x000F000Fu) | 0x43004300u;     // bf16 (128 + q_lo, 128 + q_hi)
  const uint32_t q = bf16x2_fma(q128, 0x3F803F80u, 0xC300C300u);           // x 1 - 128: exact
  return bf16x2_fma(q, s, nz);
}

// The x pair of packed row p's two k (k_lo, k_lo + 128) in row m: the B operand of one mma k slot pair.
__device__ __forceinline__ uint32_t x_pair(const unsigned short* xm, int klo) {
  return static_cast<uint32_t>(__ldg(xm + klo)) | (static_cast<uint32_t>(__ldg(xm + klo + 128)) << 16);
}

// Grid (ks, N / COLS), clusters of ks along x; x (M, K), qw (K/2, N), ws / wz (K/64, N) bf16, bias (N,) | null,
// out (M, N) f32.
__global__ void __launch_bounds__(THREADS)
    gemv_awq_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ qw, const bf16* __restrict__ ws,
                    const bf16* __restrict__ wz, const bf16* __restrict__ bias, float* __restrict__ out, int M,
                    int N, int K, int ks) {
  __shared__ float red[WARPS][32][32];  // [warp][accumulator][lane]
  const int rank = blockIdx.x, n0 = blockIdx.y * COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t4 = lane & 3;
  const int slabs = K / (2 * SLAB), lo = rank * slabs / ks, hi = (rank + 1) * slabs / ks;
  const int cb = n0 + 16 * g;  // this lane's 16 columns
  const unsigned short* xm = reinterpret_cast<const unsigned short*>(x) + static_cast<size_t>(g) * K;
  const bool xrow = g < M;
  float acc[8][4];
#pragma unroll
  for (int T = 0; T < 8; ++T) acc[T][0] = acc[T][1] = acc[T][2] = acc[T][3] = 0.f;

  // the warp's steps: slabs lo + warp, lo + warp + 4, ..., two steps a slab
  const int nsteps = lo + warp < hi ? 2 * ((hi - lo - warp + WARPS - 1) / WARPS) : 0;
  auto step_row = [&](int i) { return (lo + warp + WARPS * (i >> 1)) * SLAB + (i & 1) * STEP; };
  auto load = [&](uint4 (&r)[8], int i) {
    const int8_t* src = qw + static_cast<size_t>(step_row(i) + t4) * N + cb;
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(4 * j) * N));
  };
  uint4 cur[8], nxt[8];
  uint32_t sp[16], nzp[16];  // this lane's columns: (s_lo, s_hi) and -(z_lo, z_hi) as bf16x2
  if (nsteps > 0) load(cur, 0);
  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) load(nxt, i + 1);  // the next step's codes in flight under this one's decode
    const int p0 = step_row(i);
    const int glo = p0 / 64 + 2 * (p0 / 128);     // the low nibbles' group; the high ones' is + 2
    const int klo = 256 * (p0 / 128) + p0 % 128;  // k of row p0's low nibble
    if ((i & 1) == 0) {  // a new slab: its scale and zero pairs
      const uint4* s_lo = reinterpret_cast<const uint4*>(ws + static_cast<size_t>(glo) * N + cb);
      const uint4* s_hi = reinterpret_cast<const uint4*>(ws + static_cast<size_t>(glo + 2) * N + cb);
      const uint4* z_lo = reinterpret_cast<const uint4*>(wz + static_cast<size_t>(glo) * N + cb);
      const uint4* z_hi = reinterpret_cast<const uint4*>(wz + static_cast<size_t>(glo + 2) * N + cb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 a = __ldg(s_lo + h), b = __ldg(s_hi + h), c = __ldg(z_lo + h), d = __ldg(z_hi + h);
        const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
        const uint32_t cv[4] = {c.x, c.y, c.z, c.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[8 * h + 2 * e] = prmt(av[e], bv[e], 0x5410);
          sp[8 * h + 2 * e + 1] = prmt(av[e], bv[e], 0x7632);
          nzp[8 * h + 2 * e] = prmt(cv[e], dv[e], 0x5410) ^ 0x80008000u;
          nzp[8 * h + 2 * e + 1] = prmt(cv[e], dv[e], 0x7632) ^ 0x80008000u;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t b0 = 0, b1 = 0;
      if (xrow) {
        b0 = x_pair(xm, klo + 8 * r + t4);
        b1 = x_pair(xm, klo + 8 * r + 4 + t4);
      }
      const uint4 ra = cur[2 * r], rb = cur[2 * r + 1];
      const uint32_t ua[4] = {ra.x, ra.y, ra.z, ra.w}, ub[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        const uint32_t va = ua[wd] >> 4, vb = ub[wd] >> 4;
        uint32_t a[4];
        a[0] = decode<0>(ua[wd], va, sp[4 * wd], nzp[4 * wd]);
        a[1] = decode<1>(ua[wd], va, sp[4 * wd + 1], nzp[4 * wd + 1]);
        a[2] = decode<0>(ub[wd], vb, sp[4 * wd], nzp[4 * wd]);
        a[3] = decode<1>(ub[wd], vb, sp[4 * wd + 1], nzp[4 * wd + 1]);
        mma_bf16(acc[2 * wd], a, b0, b1);
        a[0] = decode<2>(ua[wd], va, sp[4 * wd + 2], nzp[4 * wd + 2]);
        a[1] = decode<3>(ua[wd], va, sp[4 * wd + 3], nzp[4 * wd + 3]);
        a[2] = decode<2>(ub[wd], vb, sp[4 * wd + 2], nzp[4 * wd + 2]);
        a[3] = decode<3>(ub[wd], vb, sp[4 * wd + 3], nzp[4 * wd + 3]);
        mma_bf16(acc[2 * wd + 1], a, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
  }

  // acc[T][e]: out[m = 2 t4 + (e & 1)][cb + 2T + (e >> 1)]; the warps' sums in warp order, then the cluster's
#pragma unroll
  for (int T = 0; T < 8; ++T)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * T + e][lane] = acc[T][e];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int a = 0; a < 32; ++a) {
      float v = red[0][a][lane];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += red[w][a][lane];
      red[0][a][lane] = v;
    }
  }
  sm90::cluster_sync();
  if (rank == 0) {
    // warp w of the leader: accumulators 8w .. 8w + 7 of every lane; each one's ks partial sums are loaded
    // first (the remote loads in flight together), then added in rank order
    float part[8][MAX_KS];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = 8 * warp + i;
#pragma unroll
      for (int r = 0; r < MAX_KS; ++r)
        part[i][r] = r < ks && 2 * t4 + (a & 1) < M ? sm90::ld_cluster(sm90::cluster_addr(&red[0][a][lane], r)) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = 8 * warp + i, m = 2 * t4 + (a & 1), n = cb + 2 * (a >> 2) + ((a >> 1) & 1);
      float v = part[i][0];
#pragma unroll
      for (int r = 1; r < MAX_KS; ++r)
        if (r < ks) v += part[i][r];
      if (m < M) out[static_cast<size_t>(m) * N + n] = bias != nullptr ? v + bf2f(bias[n]) : v;
    }
  }
  sm90::cluster_sync();  // the leader's reads of the others' shared memory are done
}

// blocks of the cluster along K: 2, 4 or 8 while the strips alone make fewer than two blocks a SM and every warp
// keeps a slab
int k_splits(int N, int K) {
  const int strips = N / COLS, slabs = K / (2 * SLAB);
  int ks = 1;
  while (ks < MAX_KS && strips * ks < TARGET_BLOCKS && slabs >= 2 * ks * WARPS) ks *= 2;
  return ks;
}

}  // namespace

// x (M, K) bf16, qweight (K/2, N) int8 (unsigned nibbles), wscales and
// wzeros (K/64, N) bf16, bias (N,) bf16 | null -> out (M, N) f32. Needs
// M <= 8, K % 256 == 0, N % 128 == 0 (the Python wrapper asks N % 256).
extern "C" int nt_gemv_awq(const void* x, const void* qweight, const void* wscales, const void* wzeros,
                           const void* bias, void* out, int M, int N, int K, void* stream) {
  if (M < 1 || M > MAXM || K % 256 || N % COLS) return static_cast<int>(cudaErrorInvalidValue);
  const int ks = k_splits(N, K);
  cudaError_t e = sm90::launch_cluster(gemv_awq_kernel, dim3(ks, N / COLS), THREADS, 0, ks,
                                       static_cast<cudaStream_t>(stream), static_cast<const bf16*>(x),
                                       static_cast<const int8_t*>(qweight), static_cast<const bf16*>(wscales),
                                       static_cast<const bf16*>(wzeros), static_cast<const bf16*>(bias),
                                       static_cast<float*>(out), M, N, K, ks);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
