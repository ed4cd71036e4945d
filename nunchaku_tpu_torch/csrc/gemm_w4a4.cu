// W4A4 GEMM of the int4 / nvfp4 SVDQuant modes: 4-bit activations times
// 4-bit weights with per-group scales, plus the rank-r branch and the bias.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w4a4_kernel (:125, launched by
// _svdq_gemm_w4a4 :1906 for precision int4 / nvfp4), in both of its forms:
// non-stacked, and the stacked (layer-index) mode its scans reach through
// attach_stacked_weights (stacked_w, :130-135: qw_ref[0] of the layer the
// scalar prefetch names). In the stacked mode the weight is layer idx of an
// (L, K/2, N) stack, idx a device-resident int32 read once at entry
// (common.cuh stacked_layer); the rest of the kernel is the same code, so a
// stacked launch is bit-identical to the plain launch on that layer:
//   out = bf16( sum_k bf16(a_k * sa[g(k), m]) * bf16(w_k * sw[g(k), n])
//               + bf16(lora_act) @ proj_up + bias )
// with f32 accumulation. a_k, w_k are 4-bit codes: int4 nibbles (weights
// and activations signed, or activations unsigned after the post-GELU
// shift), or signed e2m1 codes decoded to {0, .5, 1, 1.5, 2, 3, 4, 6}
// (nvfp4; the stray code -8 decodes to -8 as in _decode_e2m1). g(k) = k / G,
// G = 64 (int4) or 16 (nvfp4). Every value x scale product is rounded to
// bf16 on both operands, as the Pallas kernel does (:151-160): the H100 has
// no 4-bit tensor-core type, and an int8 or fp8 product with per-group
// partials would round elsewhere.
//
// Layouts: qact (M, K/2) and the weight as its (N, K/2) K-contiguous
// storage, both packed in the block-split-half order (byte j of pack
// block b holds k = 256b + j in its low nibble and 256b + 128 + j in its
// high one); ascales (K/G, M), wscales (K/G, N) bf16.
//
// Bound on the H100: operations (2*M*N*K bf16 FLOP; at FLUX.1-dev shapes
// M = 4608, K = 3072, N = 12288 the work is ~2,500 FLOP per byte moved,
// far above the bf16 ridge). Design: block tile 128 x 128, one pack block
// (256 k, 128 packed bytes a row) per step through a two-stage cp.async
// ring of packed bytes and scale rows; eight warps as 2 (M) x 4 (N), warp
// tile 64 x 32 of mma.sync m16n8k16 bf16 with f32 accumulators. The codes
// are decoded straight into the A and B fragment registers (no bf16 tile
// in shared memory): a contraction is invariant to one k-permutation
// applied to both operands, so each lane takes 16 consecutive packed bytes
// of its row (A) or column (B) with one bank-conflict-free 16-byte load
// and maps their 32 nibbles onto its k-slots of eight k16 steps. Within those bytes all low
// nibbles share one scale group and all high nibbles another (at G = 64
// and G = 16 alike), so a decoded pair of values takes one bf16x2
// multiply. int4 nibbles become bf16 through the exponent trick (0x4300 |
// u is 128 + u), e2m1 codes through a 16-entry table in shared memory.
// The rank-r term enters the accumulators by mma before the main loop,
// the bias after it.
#include "mma.cuh"

namespace {

constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int WM = 64, WN = 32;          // warp tile: 8 warps as 2 (M) x 4 (N)
constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles of a warp
constexpr int PB = 128;                   // packed bytes of a row per step (256 k)
constexpr int HB = PB / 2;                // a half step: 64 bytes, 8 k16 steps of mma
constexpr int MAX_GPB = 16;               // scale groups per step (nvfp4: 256 / 16)

enum Mode { INT4_S = 0, INT4_U = 1, E2M1 = 2 };

struct Stage {
  uint8_t a[2][BM][HB];  // a[h][m][c] = qact[m0 + m][PB * b + HB * h + c]
  uint8_t w[2][BN][HB];  // w[h][n][c] = wt[n0 + n][PB * b + HB * h + c]
  bf16 sa[MAX_GPB][BM];  // ascales[gpb * b + i][m0 + m]
  bf16 sw[MAX_GPB][BN];  // wscales[gpb * b + i][n0 + n]
};
struct Smem {
  Stage st[2];
  uint32_t e2m1[16];  // bf16 bits of each signed e2m1 code, by nibble
};

// bf16 bits of _decode_e2m1(sign-extended nibble u), u = 0..15
__constant__ uint16_t kE2M1[16] = {0x0000, 0x3F00, 0x3F80, 0x3FC0, 0x4000, 0x4040, 0x4080, 0x40C0,
                                   0xC100, 0xC0C0, 0xC080, 0xC040, 0xC000, 0xBFC0, 0xBF80, 0xBF00};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) { return *reinterpret_cast<__nv_bfloat162*>(&u); }

// One 32-bit word of packed bytes B0..B3 -> four bf16 pairs, each of two
// nibbles of the same plane: v[0] = (lo B0, lo B2), v[1] = (hi B0, hi B2),
// v[2] = (lo B1, lo B3), v[3] = (hi B1, hi B3); v[0], v[2] take the low
// plane's scale, v[1], v[3] the high plane's.
template <int MODE>
__device__ __forceinline__ void decode_word(uint32_t w, const uint32_t* tab, uint32_t (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = (w >> (4 * i)) & 0x000F000Fu;  // two nibbles, one per bf16 half
    if (MODE == E2M1) {
      v[i] = tab[x & 0xF] | (tab[x >> 16] << 16);
    } else {
      // 0x4300 | u is the bf16 128 + u; signed nibbles (u ^ 8) - 8
      const uint32_t bits = (MODE == INT4_S ? (x ^ 0x00080008u) : x) | 0x43004300u;
      const uint32_t off = MODE == INT4_S ? 0x43084308u : 0x43004300u;  // (136, 136) or (128, 128)
      v[i] = as_u32(__hsub2(as_bf162(bits), as_bf162(off)));
    }
  }
}

__device__ __forceinline__ uint32_t scale2(uint32_t v, __nv_bfloat162 s) {
  return as_u32(__hmul2(as_bf162(v), s));  // one rounding to bf16, nearest even
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ __nv_bfloat162 bcast(bf16 s) { return __halves2bfloat162(s, s); }

__device__ __forceinline__ void load_stage(Stage& st, const int8_t* qa, const int8_t* wt,
                                           const bf16* as, const bf16* ws, int m0, int n0, int b,
                                           int M, int N, int K2, int gpb) {
  for (int c = threadIdx.x; c < BM * (PB / 16); c += THREADS) {
    const int r = c / (PB / 16), cc = c % (PB / 16);
    const bool ok = m0 + r < M;
    cp_async16(&st.a[cc / 4][r][(cc % 4) * 16],
               qa + static_cast<size_t>(ok ? m0 + r : 0) * K2 + PB * b + cc * 16, ok);
  }
  for (int c = threadIdx.x; c < BN * (PB / 16); c += THREADS) {
    const int r = c / (PB / 16), cc = c % (PB / 16);
    cp_async16(&st.w[cc / 4][r][(cc % 4) * 16], wt + static_cast<size_t>(n0 + r) * K2 + PB * b + cc * 16,
               true);
  }
  for (int c = threadIdx.x; c < gpb * (BM / 8); c += THREADS) {  // 8 bf16 per 16-byte chunk
    const int g = c / (BM / 8), cc = c % (BM / 8);
    const bool ok = m0 + cc * 8 < M;  // M % 8 == 0: a chunk is all in or all out
    cp_async16(&st.sa[g][cc * 8], as + static_cast<size_t>(gpb * b + g) * M + (ok ? m0 + cc * 8 : 0), ok);
  }
  for (int c = threadIdx.x; c < gpb * (BN / 8); c += THREADS) {
    const int g = c / (BN / 8), cc = c % (BN / 8);
    cp_async16(&st.sw[g][cc * 8], ws + static_cast<size_t>(gpb * b + g) * N + n0 + cc * 8, true);
  }
}

template <int AMODE, bool LORA, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    gemm_w4a4_kernel(const int8_t* __restrict__ qa, const bf16* __restrict__ as,
                     const int8_t* __restrict__ wt, const bf16* __restrict__ ws,
                     const float* __restrict__ la, const bf16* __restrict__ pu,
                     const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int N, int K, int R,
                     const int* __restrict__ lidx, int L) {
  constexpr int WMODE = AMODE == E2M1 ? E2M1 : INT4_S;  // weights are always signed
  constexpr int G = AMODE == E2M1 ? 16 : 64;
  constexpr int GPB = 256 / G;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int K2 = K / 2, nb = K / 256;
  wt = stacked_layer(wt, lidx, L, static_cast<size_t>(N) * K2);
  if (threadIdx.x < 16) sm.e2m1[threadIdx.x] = kE2M1[threadIdx.x];

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(sm.st[0], qa, wt, as, ws, m0, n0, 0, M, N, K2, GPB);
  cp_async_commit();

  if (LORA) {  // acc = bf16(lora_act) @ proj_up, in k16 steps (columns past R read as 0)
    for (int kc = 0; kc < R; kc += 16) {
      auto lav = [&](int m, int k) { return (m < M && k < R) ? la[static_cast<size_t>(m) * R + k] : 0.f; };
      auto puv = [&](int k, int n) { return k < R ? bf2f(pu[static_cast<size_t>(k) * N + n]) : 0.f; };
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + 8 * j + g;
        bf[j][0] = pack_bf16(puv(kc + 2 * t, n), puv(kc + 2 * t + 1, n));
        bf[j][1] = pack_bf16(puv(kc + 2 * t + 8, n), puv(kc + 2 * t + 9, n));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r0 = m0 + wm * WM + 16 * i + g, r1 = r0 + 8;
        const uint32_t af[4] = {pack_bf16(lav(r0, kc + 2 * t), lav(r0, kc + 2 * t + 1)),
                                pack_bf16(lav(r1, kc + 2 * t), lav(r1, kc + 2 * t + 1)),
                                pack_bf16(lav(r0, kc + 2 * t + 8), lav(r0, kc + 2 * t + 9)),
                                pack_bf16(lav(r1, kc + 2 * t + 8), lav(r1, kc + 2 * t + 9))};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }

  for (int b = 0; b < nb; ++b) {
    if (b + 1 < nb) load_stage(sm.st[(b + 1) & 1], qa, wt, as, ws, m0, n0, b + 1, M, N, K2, GPB);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Stage& st = sm.st[b & 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // this lane's bytes [HB h + 16 t, +16) of the pack block: low nibbles
      // k = 256 b + 64 h + 16 t + i, high nibbles k + 128
      const int glo = G == 64 ? h : 4 * h + t, ghi = glo + GPB / 2;
      uint4 braw[NT];
      __nv_bfloat162 bslo[NT], bshi[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn * WN + 8 * j + g;
        braw[j] = *reinterpret_cast<const uint4*>(&st.w[h][n][16 * t]);
        bslo[j] = bcast(st.sw[glo][n]);
        bshi[j] = bcast(st.sw[ghi][n]);
      }
      uint4 araw[MT][2];
      __nv_bfloat162 aslo[MT][2], ashi[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = wm * WM + 16 * i + g + 8 * rr;
          araw[i][rr] = *reinterpret_cast<const uint4*>(&st.a[h][r][16 * t]);
          aslo[i][rr] = bcast(st.sa[glo][r]);
          ashi[i][rr] = bcast(st.sa[ghi][r]);
        }
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {  // word wd of the 16 bytes: k16 steps 2 wd and 2 wd + 1
        uint32_t bfr[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          decode_word<WMODE>(word_of(braw[j], wd), sm.e2m1, bfr[j]);
          bfr[j][0] = scale2(bfr[j][0], bslo[j]);
          bfr[j][1] = scale2(bfr[j][1], bshi[j]);
          bfr[j][2] = scale2(bfr[j][2], bslo[j]);
          bfr[j][3] = scale2(bfr[j][3], bshi[j]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ar[2][4];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            decode_word<AMODE>(word_of(araw[i][rr], wd), sm.e2m1, ar[rr]);
            ar[rr][0] = scale2(ar[rr][0], aslo[i][rr]);
            ar[rr][1] = scale2(ar[rr][1], ashi[i][rr]);
            ar[rr][2] = scale2(ar[rr][2], aslo[i][rr]);
            ar[rr][3] = scale2(ar[rr][3], ashi[i][rr]);
          }
          // k16 step 2 wd: slots (2t, 2t+1) <- low-plane pair, (2t+8, 2t+9) <- high-plane pair
          const uint32_t a0[4] = {ar[0][0], ar[1][0], ar[0][1], ar[1][1]};
          const uint32_t a1[4] = {ar[0][2], ar[1][2], ar[0][3], ar[1][3]};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            mma_bf16(acc[i][j], a0, bfr[j][0], bfr[j][1]);
            mma_bf16(acc[i][j], a1, bfr[j][2], bfr[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * WN + 8 * j + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (BIAS) {
        b0 = bf2f(bias[n]);
        b1 = bf2f(bias[n + 1]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = m0 + wm * WM + 16 * i + g + 8 * rr;
        if (m < M) {
          *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(m) * N + n) =
              pack_bf16(__fadd_rn(acc[i][j][2 * rr], b0), __fadd_rn(acc[i][j][2 * rr + 1], b1));
        }
      }
    }
  }
}

template <int AMODE, bool LORA, bool BIAS>
cudaError_t launch(const void* qa, const void* as, const void* wt, const void* ws, const void* la,
                   const void* pu, const void* bias, void* out, int M, int N, int K, int R, const int* lidx, int L,
                   cudaStream_t s) {
  static bool configured = false;
  const int smem = static_cast<int>(sizeof(Smem));
  auto kernel = gemm_w4a4_kernel<AMODE, LORA, BIAS>;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const int8_t*>(qa), static_cast<const bf16*>(as),
                                      static_cast<const int8_t*>(wt), static_cast<const bf16*>(ws),
                                      static_cast<const float*>(la), static_cast<const bf16*>(pu),
                                      static_cast<const bf16*>(bias), static_cast<bf16*>(out), M, N, K, R, lidx, L);
  return cudaGetLastError();
}

template <int AMODE>
cudaError_t dispatch(const void* qa, const void* as, const void* wt, const void* ws, const void* la,
                     const void* pu, const void* bias, void* out, int M, int N, int K, int R, const int* lidx, int L,
                     cudaStream_t s) {
  const bool lora = la != nullptr && R > 0;
  if (lora && bias != nullptr)
    return launch<AMODE, true, true>(qa, as, wt, ws, la, pu, bias, out, M, N, K, R, lidx, L, s);
  if (lora) return launch<AMODE, true, false>(qa, as, wt, ws, la, pu, bias, out, M, N, K, R, lidx, L, s);
  if (bias != nullptr)
    return launch<AMODE, false, true>(qa, as, wt, ws, la, pu, bias, out, M, N, K, R, lidx, L, s);
  return launch<AMODE, false, false>(qa, as, wt, ws, la, pu, bias, out, M, N, K, R, lidx, L, s);
}

}  // namespace

// qact (M, K/2) int8, ascales (K/G, M) bf16, wt (N, K/2) int8 (the packed
// (K/2, N) weight K-contiguous), wscales (K/G, N) bf16, lora_act (M, R) f32
// | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null -> out (M, N)
// bf16. mode: 0 int4 with signed activations, 1 int4 with unsigned
// activations, 2 nvfp4 (e2m1 codes). layer_idx: null, or a device int32
// naming the layer of a stack of L such weights that starts at wt (each
// (N, K/2), N * K/2 bytes apart). Needs K % 256 == 0, N % 128 == 0,
// M % 8 == 0 (checked by the Python wrapper).
extern "C" int nt_gemm_w4a4(const void* qact, const void* ascales, const void* wt, const void* wscales,
                            const void* lora_act, const void* proj_up, const void* bias, void* out, int M,
                            int N, int K, int R, int mode, const void* layer_idx, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lidx = static_cast<const int*>(layer_idx);
  auto run = [&](auto fn) {
    return fn(qact, ascales, wt, wscales, lora_act, proj_up, bias, out, M, N, K, R, lidx, L, s);
  };
  cudaError_t e = cudaErrorInvalidValue;
  if (mode == INT4_S) e = run(dispatch<INT4_S>);
  if (mode == INT4_U) e = run(dispatch<INT4_U>);
  if (mode == E2M1) e = run(dispatch<E2M1>);
  return static_cast<int>(e);
}
