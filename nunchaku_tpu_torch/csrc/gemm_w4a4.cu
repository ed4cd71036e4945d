// W4A4 GEMM of the int4 / nvfp4 SVDQuant modes: 4-bit activations times
// 4-bit weights with per-group scales, plus the rank-r branch and the bias.
//
// Replaces nunchaku_tpu/ops/gemm.py _gemm_w4a4_kernel (:125, launched by
// _svdq_gemm_w4a4 :1906 for precision int4 / nvfp4), in both of its forms:
// non-stacked, and the stacked (layer-index) mode its scans reach through
// attach_stacked_weights (stacked_w, :130-135: qw_ref[0] of the layer the
// scalar prefetch names). In the stacked mode the weight is layer idx of an
// (L, K/2, N) stack, idx a device-resident int32 the producer thread reads
// (clamped to [0, L)) as a TMA coordinate; the rest of the kernel is the
// same code, so a stacked launch is bit-identical to the plain launch on
// that layer:
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
// far above the bf16 ridge). So the decode must run under the products.
// Decoding both operands into shared memory is not enough (the bf16 probe's
// k_v6 form, gemm_probe_bf16.cu): at the tensor cores' rate a wgmma
// m64n128k16 reads 64 bytes a clock of B from shared memory, and writing
// both decoded tiles back takes 64 more of the SM's 128. Design (one block
// a 128 x 128 output tile, 384 threads, gemm_sm90.cuh's building blocks):
//   - register-A wgmma (Bf16RegA): two consumer warpgroups of 64
//     rows each decode their own rows of A straight into A-fragment
//     registers, so A never touches shared memory; a K tile (128 k) is 8
//     wgmma m64n128k16 a warpgroup; tile t + 1's fragments are decoded into
//     the second register set while tile t's products run (the loop
//     unrolled by two so the two sets are fixed registers, the last tile
//     peeled);
//   - W is decoded once a block into a swizzled K-major bf16 tile both
//     consumer warpgroups read, by warpgroup 0 (the decoders; no setmaxnreg:
//     384 threads at ptxas's 168 registers fit), into four rotating tile
//     buffers, so the decoders run up to three K tiles ahead of the
//     products and a W decode never waits on a consumer's barrier. On the
//     consumers instead it made their critical path the decode (measured
//     slower, and it spilled);
//   - warpgroup 0's first thread also issues the TMA copies, two K tiles
//     ahead, into a 3-stage ring: each K tile's packed bytes (64 bytes of
//     each row of A and of W, the weight through a 3-D map whose third
//     coordinate is the stack's layer) and its scale rows (the low and the
//     high nibble plane's: 1 group each at G 64, 4 at G 16);
//   - the rank-r term is R / 16 more register-A k steps before the loop
//     (2 at R <= 32; above, 8 for each chunk of 128 ranks, the chunks one
//     after another through one tile): bf16(lora_act) as A, proj_up (R, N)
//     by TMA as an MN-major B tile; the bias is added at the store. A partial
//     last row tile: TMA reads zeros past M, the store masks those rows.
// The k-permutation. A contraction is invariant to one permutation of k
// applied to both operands. Lane (g, t4) of a warp takes the 16 packed
// bytes [16 t4, 16 t4 + 16) of its rows' 64 (one 16-byte load each), and
// its word w of them (bytes B0..B3 at 16 t4 + 4 w) fills k steps 2 w and
// 2 w + 1: (lo B0, lo B1) the A slots (2 t4, 2 t4 + 1) of step 2 w, (hi B0,
// hi B1) slots (2 t4 + 8, + 9), (lo B2, lo B3) and (hi B2, hi B3) the same
// of step 2 w + 1. The decoded W tile puts every value at the k position
// of the slot that holds the same logical k in A. Within those 16 bytes all
// low nibbles share one scale group and all high nibbles another, at G 64
// and G 16 alike, so a decoded pair takes one bf16x2 multiply. int4
// nibbles become bf16 through the exponent trick (0x4300 | u is 128 + u),
// e2m1 codes through byte permutes over two 8-entry tables in registers
// (by the code's low three bits, for each sign bit) that give a byte under
// the exponent of 64; the shared-memory accesses stay LDS / STS (the
// aligned base is an offset into the shared array).
#include "gemm_sm90.cuh"

namespace {

using namespace gemm90;

constexpr int BN = 128;                  // block N tile (BM = 128: gemm90::BM)
constexpr int HB = 64;                   // packed bytes of a row a K tile (128 k)
constexpr int RAW_A = BM * HB, RAW_W = BN * HB;
constexpr int DEC = 2 * BN * 128;        // a decoded W tile: two K-major panels of 64 k, BN rows of 128 bytes
constexpr int DEC_BUFS = 4;

enum Mode { INT4_S = 0, INT4_U = 1, E2M1 = 2 };

template <int MODE>
struct Shape {
  static constexpr int G = MODE == E2M1 ? 16 : 64;
  static constexpr int GR = 64 / G;                               // scale rows of a nibble plane a K tile
  static constexpr int SA = 2 * GR * BM * 2;                      // A's scale rows (low, high plane) a K tile
  static constexpr int SW = 2 * GR * BN * 2;                      // W's
  static constexpr int BYTES = RAW_A + RAW_W + SA + SW;           // the copies of a K tile
  static constexpr int STAGE = (BYTES + 1023) / 1024 * 1024;      // 1024-aligned: the swizzled W box
  static constexpr int ST = 3;                                    // ring depth
  static constexpr int LEAD = ST - 1;                             // K tiles the copies run ahead of the W decode
  static constexpr int RING = ST * STAGE;
  static constexpr int LORA = RING + DEC_BUFS * DEC;              // proj_up's tile: two panels of up to 128 rows
  static constexpr int BARS = LORA + DEC;                         // full[ST], empty[ST], wfull / wempty[4], lora
  static constexpr int SMEM = BARS + 8 * (2 * ST + 2 * DEC_BUFS + 1) + 1024;
};

struct Params {
  CUtensorMap a, w, as, ws, pu;
  const float* la;
  const bf16* bias;
  bf16* out;
  const int* layer_idx;  // null: not a stack
  int L, M, N, K, R;
};

// bf16 operands with A from registers, f32 accumulators. A is 64 x 16 a warpgroup, four .b32 a thread in the
// mma.sync m16n8k16 A layout (warp w of the warpgroup rows 16 w .. 16 w + 15: a0 row g, k 2 t4 .. + 1; a1 row
// g + 8; a2, a3 the same at k + 8); B is 16 x 128 in shared memory, 128-byte swizzled, K-major (MN_MAJOR 0: BN
// rows of 64 k, a k step 32 bytes along them) or MN-major (1: panels of 64 columns, as gemm90::Bf16's W).
struct Bf16RegA {
  // d (64 x 128 f32) += A (registers) . B (descriptor); MN_MAJOR: B's layout
  template <int MN_MAJOR>
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(MN_MAJOR));
  }
};

constexpr int W_WARPS = 4;  // warpgroup 0 decodes W (and its first thread issues the copies)

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) { return *reinterpret_cast<__nv_bfloat162*>(&u); }
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) { return as_u32(__hsub2(as_bf162(a), as_bf162(b))); }
// one rounding of the exact product to bf16, nearest even
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) { return as_u32(__hmul2(as_bf162(a), as_bf162(b))); }
__device__ __forceinline__ uint32_t bcast(bf16 s) {
  const uint32_t u = *reinterpret_cast<const unsigned short*>(&s);
  return u | (u << 16);
}

// (a & b) ^ c in one LOP3 (the compiler splits it when b and c are both immediates; and_or: gemm_sm90.cuh)
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Half h of one word of packed bytes B0..B3 -> two bf16 pairs of exact code
// values: h 0 v[0] = (lo B0, lo B1), v[1] = (hi B0, hi B1); h 1 the same of
// B2, B3. v[0] takes the low plane's scale, v[1] the high plane's.
template <int MODE>
__device__ __forceinline__ void decode_half(uint32_t w, int h, uint32_t (&v)[2]) {
  if constexpr (MODE == E2M1) {
    // bytes 0x80 | (2 x + 16) of each code's value x (the codes are signed nibbles: -1 is -0.5, -7 is -6, the
    // stray -8 is -8) by its low three bits, for each sign bit; under the exponent byte 0x42 each is the bf16
    // 64 + x + 8
    constexpr uint32_t P0 = 0x93929190u, P1 = 0x9C989694u, N0 = 0x8A888480u, N1 = 0x8F8E8D8Cu;
    constexpr uint32_t EXP = 0x42424242u, OFF = 0x42904290u;  // (72, 72)
    const uint32_t y = h ? w >> 16 : w;  // nibbles lo Bx, hi Bx, lo By, hi By in y's low 16 bits
    const uint32_t mag = y & 0x7777u;
    const uint32_t u = __byte_perm(__byte_perm(P0, P1, mag), __byte_perm(N0, N1, mag),
                                   and_or(y >> 1, 0x4444u, 0x3210u));  // each byte from N where its sign is set
    v[0] = sub2(__byte_perm(u, EXP, 0x4240), OFF);
    v[1] = sub2(__byte_perm(u, EXP, 0x4341), OFF);
  } else {
    // 0x4300 | u is the bf16 128 + u; signed nibbles (u ^ 8) - 8
    constexpr uint32_t K = MODE == INT4_S ? 0x43084308u : 0x43004300u;  // (136, 136) or (128, 128)
    const uint32_t x = __byte_perm(w, 0, h ? 0x4342 : 0x4140);        // [B0, 0, B1, 0] or [B2, 0, B3, 0]
    v[0] = sub2(and_xor(x, 0x000F000Fu, K), K);
    v[1] = sub2(and_xor(x >> 4, 0x000F000Fu, K), K);
  }
}

// A K tile's W, decoded by warpgroup 0 (dt: this thread, 0 .. 127): 512 units (row n, word wd), unit u = dt +
// 128 k (a warp's eight lanes of one wd take eight rows). A unit reads word wd of each of the row's four
// 16-byte chunks of the raw stage (the 64-byte swizzle of the TMA box) and writes k steps 2 wd and 2 wd + 1 of
// the decoded tile: chunk c's pairs are the slots (2 c, 2 c + 1) of each step's low and high 8, the k positions
// A's lane t4 = c holds. All of a thread's loads come first (they are independent), then the decodes and stores.
template <int MODE>
__device__ __forceinline__ void decode_w(const unsigned char* st, unsigned char* wdst, int dt) {
  using S = Shape<MODE>;
  constexpr int PER = BN * 4 / WG;
  const bf16* sw = reinterpret_cast<const bf16*>(st + RAW_A + RAW_W + S::SA);  // [plane][GR][BN]
  uint32_t word[PER][4];
  bf16 slo[PER][S::GR], shi[PER][S::GR];  // nvfp4: chunk c's low nibbles are group lo + c
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = dt + WG * k, n = (u >> 5) * 8 + (u & 7), wd = (u >> 3) & 3;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      word[k][c] = *reinterpret_cast<const uint32_t*>(st + RAW_A + n * 64 + ((c ^ ((n >> 1) & 3)) << 4) + 4 * wd);
#pragma unroll
    for (int gi = 0; gi < S::GR; ++gi) {
      slo[k][gi] = sw[gi * BN + n];
      shi[k][gi] = sw[(S::GR + gi) * BN + n];
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int u = dt + WG * k, n = (u >> 5) * 8 + (u & 7), wd = (u >> 3) & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int step = 2 * wd + h, j = 2 * (step & 3);
      uint32_t v[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        decode_half<MODE>(word[k][c], h, v[c]);
        v[c][0] = mul2(v[c][0], bcast(slo[k][S::GR == 1 ? 0 : c]));
        v[c][1] = mul2(v[c][1], bcast(shi[k][S::GR == 1 ? 0 : c]));
      }
      unsigned char* row = wdst + (step >> 2) * (DEC / 2) + n * 128;
      *reinterpret_cast<uint4*>(row + ((j ^ (n & 7)) << 4)) = make_uint4(v[0][0], v[1][0], v[2][0], v[3][0]);
      *reinterpret_cast<uint4*>(row + (((j + 1) ^ (n & 7)) << 4)) = make_uint4(v[0][1], v[1][1], v[2][1], v[3][1]);
    }
  }
}

// A consumer thread's view of the ring and of the decoded W tiles.
template <int MODE>
struct Consumer {
  using S = Shape<MODE>;
  unsigned char* sm;   // the ring
  unsigned char* dec;  // DEC_BUFS decoded W tiles
  uint64_t* full;
  uint64_t* empty;
  uint64_t* wfull;
  uint64_t* wempty;
  int lane, t4, r0;  // r0: this thread's first row of the block's tile (the other r0 + 8)

  // K tile t's raw stage -> this warpgroup's A fragments: rows r0 and r0 + 8, bytes [16 t4, 16 t4 + 16) of
  // each; then this warp's part of the stage goes back to the producer
  __device__ __forceinline__ void decode(int t, uint32_t (&fa)[8][4]) const {
    const int s = t % S::ST;
    mbar_wait(full + s, (t / S::ST) & 1);
    const unsigned char* st = sm + s * S::STAGE;
    const bf16* sa = reinterpret_cast<const bf16*>(st + RAW_A + RAW_W);  // [plane][GR][BM]
    const int gi = S::GR == 1 ? 0 : t4;  // nvfp4: lane t4's low nibbles are group lo + t4
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + r * HB + 16 * t4);
      const uint32_t slo = bcast(sa[gi * BM + r]), shi = bcast(sa[(S::GR + gi) * BM + r]);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int wd = 0; wd < 4; ++wd)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k step 2 wd + h: (lo, lo) slots 2 t4, + 1 (a0 / a1), (hi, hi) + 8 (a2 / a3)
          uint32_t v[2];
          decode_half<MODE>(words[wd], h, v);
          fa[2 * wd + h][rr] = mul2(v[0], slo);
          fa[2 * wd + h][2 + rr] = mul2(v[1], shi);
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // tile t's products (fragments fa, W tile buffer t % 3 once decoded), committed as one group
  __device__ __forceinline__ void products(float (&acc)[64], int t, const uint32_t (&fa)[8][4]) const {
    const int b = t % DEC_BUFS;
    const unsigned char* wt = dec + b * DEC;
    mbar_wait(wfull + b, (t / DEC_BUFS) & 1);
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s) Bf16RegA::mma<0>(acc, fa[s], sw128_desc(wt + (s >> 2) * (DEC / 2) + (s & 3) * 32));
    wg_commit();
  }

  // tile t's products, then, once tile t - 1's are done (its W buffer goes back to the decoders, its fragments
  // are free), tile t + 1's A decode under them
  __device__ __forceinline__ void step(float (&acc)[64], int t, const uint32_t (&cur)[8][4],
                                       uint32_t (&nxt)[8][4]) const {
    products(acc, t, cur);
    wg_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(wempty + (t - 1) % DEC_BUFS);
    decode(t + 1, nxt);
  }
};

// The copies of K tile t into its ring stage (one thread), once the stage's previous tile is released: A's and
// W's packed bytes (the weight through a 3-D map whose third coordinate is the stack's layer) and their scale
// rows. The K tile's packed columns are [64 t, 64 t + 64): k = 256 b + 64 h + [0, 64) (low nibbles) and + 128
// (high), b = t / 2, h = t % 2; their scale groups start at rows lo and hi.
template <int MODE>
__device__ __forceinline__ void load_tile(const Params& p, unsigned char* sm, uint64_t* full, uint64_t* empty, int t,
                                          int m0, int n0, int layer) {
  using S = Shape<MODE>;
  const int s = t % S::ST;
  mbar_wait(empty + s, ((t / S::ST) & 1) ^ 1);
  unsigned char* st = sm + s * S::STAGE;
  const int lo = (t / 2 * 256 + t % 2 * 64) / S::G, hi = lo + 128 / S::G;
  mbar_expect_tx(full + s, S::BYTES);
  tma_load_2d(st, &p.a, full + s, 64 * t, m0);
  tma_load_3d(st + RAW_A, &p.w, full + s, 64 * t, n0, layer);
  unsigned char* sc = st + RAW_A + RAW_W;
  tma_load_2d(sc, &p.as, full + s, m0, lo);
  tma_load_2d(sc + S::SA / 2, &p.as, full + s, m0, hi);
  tma_load_2d(sc + S::SA, &p.ws, full + s, n0, lo);
  tma_load_2d(sc + S::SA + S::SW / 2, &p.ws, full + s, n0, hi);
}

template <int MODE, int LSTEPS>
__global__ void __launch_bounds__(THREADS, 1) gemm_w4a4_kernel(const __grid_constant__ Params p) {
  using S = Shape<MODE>;
  constexpr int WMODE = MODE == E2M1 ? E2M1 : INT4_S;  // weights are always signed
  constexpr int LPANEL = 16 * LSTEPS * 128;           // one 64-column panel of proj_up's rows
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // aligned by an offset into the shared array, so every pointer derived from it stays a shared-memory one (LDS
  // and STS, not generic loads and stores)
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* dec = sm + S::RING;
  unsigned char* lora = sm + S::LORA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BARS);
  uint64_t* empty = full + S::ST;
  uint64_t* wfull = empty + S::ST;
  uint64_t* wempty = wfull + DEC_BUFS;
  uint64_t* lora_bar = wempty + DEC_BUFS;
  int m0, n0;
  band_tile((p.M + BM - 1) / BM, p.N / BN, BN, m0, n0);
  const int T = p.K / 128;  // K tiles (even: K % 256 == 0)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8 + W_WARPS);  // the consumers' eight warps (A) and the decoders (W)
    }
#pragma unroll
    for (int b = 0; b < DEC_BUFS; ++b) {
      mbar_init(wfull + b, W_WARPS);
      mbar_init(wempty + b, 8);
    }
    mbar_init(lora_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // No setmaxnreg: the decoders need registers too, and 384 threads at ptxas's 168 fit.
  if (warp < W_WARPS) {
    // ---- warpgroup 0: the W decoders; its first thread also issues the copies, LEAD tiles ahead ----
    int layer = 0;
    if (threadIdx.x == 0) {
      if (LSTEPS > 0) {
        mbar_expect_tx(lora_bar, 2 * LPANEL);
        tma_load_2d(lora, &p.pu, lora_bar, n0, 0);
        tma_load_2d(lora + LPANEL, &p.pu, lora_bar, n0 + 64, 0);
      }
      if (p.layer_idx != nullptr) {
        layer = __ldg(p.layer_idx);
        layer = layer < 0 ? 0 : (layer >= p.L ? p.L - 1 : layer);
      }
      for (int t = 0; t < S::LEAD && t < T; ++t) load_tile<MODE>(p, sm, full, empty, t, m0, n0, layer);
    }
    for (int t = 0; t < T; ++t) {
      // tile t + LEAD's stage held tile t + LEAD - ST = t - 1, which every decoder has passed and the consumers
      // release while they run tile t - 2's products
      if (threadIdx.x == 0 && t + S::LEAD < T) load_tile<MODE>(p, sm, full, empty, t + S::LEAD, m0, n0, layer);
      __syncwarp();
      const int s = t % S::ST, b = t % DEC_BUFS;
      mbar_wait(full + s, (t / S::ST) & 1);
      mbar_wait(wempty + b, ((t / DEC_BUFS) & 1) ^ 1);  // tile t - 4's products are done
      decode_w<WMODE>(sm + s * S::STAGE, dec + b * DEC, threadIdx.x);
      fence_proxy_async();  // the W stores, visible to wgmma's reads
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(wfull + b);
        mbar_arrive(empty + s);
      }
    }
    return;
  }

  // ---- consumers: 64 rows a warpgroup ----
  const int ct = threadIdx.x - WG;
  const Consumer<MODE> c{sm, dec, full, empty, wfull, wempty, lane, lane & 3,
                         ct / WG * 64 + (ct % WG) / 32 * 16 + (lane >> 2)};

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if constexpr (LSTEPS > 0) {
    // acc = bf16(lora_act) @ proj_up: the rank in chunks of 16 LSTEPS (past R: zeros), each through the one
    // proj_up tile; chunk ch + 1's copy waits until both warpgroups' products have read chunk ch
    constexpr int CH = 16 * LSTEPS;
    const int chunks = (p.R + CH - 1) / CH;
    for (int ch = 0; ch < chunks; ++ch) {
      uint32_t lf[LSTEPS][4];
#pragma unroll
      for (int kk = 0; kk < LSTEPS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + c.r0 + 8 * (e & 1), k = CH * ch + 16 * kk + 2 * c.t4 + 8 * (e >> 1);
          const float* row = p.la + static_cast<size_t>(m) * p.R;
          const bool ok = m < p.M;
          lf[kk][e] = pack_bf16(ok && k < p.R ? row[k] : 0.f, ok && k + 1 < p.R ? row[k + 1] : 0.f);
        }
      mbar_wait(lora_bar, ch & 1);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < LSTEPS; ++kk)
        Bf16RegA::mma<1>(acc, lf[kk], sw128_desc(lora + kk * 16 * 128, LPANEL / 16));
      wg_commit();
      if (ch + 1 < chunks) {
        wg_wait<0>();
        named_sync(1);  // the two consumer warpgroups
        if (ct == 0) {
          mbar_expect_tx(lora_bar, 2 * LPANEL);
          tma_load_2d(lora, &p.pu, lora_bar, n0, CH * (ch + 1));
          tma_load_2d(lora + LPANEL, &p.pu, lora_bar, n0 + 64, CH * (ch + 1));
        }
      }
    }
    mbar_wait(full, 0);  // the last products run while the first K tile arrives
    wg_wait<0>();
  }

  uint32_t fa0[8][4], fa1[8][4];
  c.decode(0, fa0);
  int t = 0;
  for (; t + 2 < T; t += 2) {
    c.step(acc, t, fa0, fa1);
    c.step(acc, t + 1, fa1, fa0);
  }
  c.step(acc, t, fa0, fa1);
  c.products(acc, t + 1, fa1);
  wg_wait<0>();
  reg_fence(acc);

  // the store: bias added, rounded to bf16; rows past M masked
  const int m = m0 + c.r0, t4 = c.t4;
  bf16* dst0 = p.out + static_cast<size_t>(m) * p.N + n0 + 2 * t4;
  bf16* dst1 = dst0 + static_cast<size_t>(8) * p.N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float b0 = 0.f, b1 = 0.f;
    if (p.bias != nullptr) {
      b0 = bf2f(p.bias[n0 + 8 * j + 2 * t4]);
      b1 = bf2f(p.bias[n0 + 8 * j + 2 * t4 + 1]);
    }
    if (m < p.M)
      *reinterpret_cast<uint32_t*>(dst0 + 8 * j) = pack_bf16(__fadd_rn(acc[4 * j], b0), __fadd_rn(acc[4 * j + 1], b1));
    if (m + 8 < p.M)
      *reinterpret_cast<uint32_t*>(dst1 + 8 * j) =
          pack_bf16(__fadd_rn(acc[4 * j + 2], b0), __fadd_rn(acc[4 * j + 3], b1));
  }
}

// The tensor maps of one launch (kept by their inputs: a forward relaunches on the same pointers); false if the
// encoder refuses one.
template <int MODE>
bool maps(Params& p, const void* qa, const void* as, const void* wt, const void* ws, const void* pu, int lsteps) {
  using S = Shape<MODE>;
  const cuuint64_t M = p.M, N = p.N, K2 = p.K / 2, KG = p.K / S::G, L = p.layer_idx != nullptr ? p.L : 1;
  const cuuint64_t a_dims[2] = {K2, M}, a_str[1] = {K2};
  const cuuint32_t a_box[2] = {HB, BM};
  const cuuint64_t w_dims[3] = {K2, N, L}, w_str[2] = {K2, K2 * N};
  const cuuint32_t w_box[3] = {HB, BN, 1};
  const cuuint64_t as_dims[2] = {M, KG}, as_str[1] = {2 * M};
  const cuuint64_t ws_dims[2] = {N, KG}, ws_str[1] = {2 * N};
  const cuuint32_t as_box[2] = {BM, S::GR}, ws_box[2] = {BN, S::GR};
  const auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, B16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = tensor_map(&p.a, U8, 2, qa, a_dims, a_str, a_box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
            tensor_map(&p.w, U8, 3, wt, w_dims, w_str, w_box, CU_TENSOR_MAP_SWIZZLE_64B) &&
            tensor_map(&p.as, B16, 2, as, as_dims, as_str, as_box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
            tensor_map(&p.ws, B16, 2, ws, ws_dims, ws_str, ws_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && lsteps > 0) {  // proj_up (R, N) in 64-column panels of 16 lsteps rows (past R: zeros)
    const cuuint64_t pu_dims[2] = {N, static_cast<cuuint64_t>(p.R)}, pu_str[1] = {2 * N};
    const cuuint32_t pu_box[2] = {64, static_cast<cuuint32_t>(16 * lsteps)};
    ok = tensor_map(&p.pu, B16, 2, pu, pu_dims, pu_str, pu_box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  return ok;
}

template <int MODE, int LSTEPS>
int launch_w4a4(const Params& p, cudaStream_t stream) {
  constexpr int bytes = Shape<MODE>::SMEM;
  static_assert(bytes <= MAX_SMEM, "shared memory of one block");
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(gemm_w4a4_kernel<MODE, LSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int grid = (p.M + BM - 1) / BM * (p.N / BN);
  gemm_w4a4_kernel<MODE, LSTEPS><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(Params& p, const void* qa, const void* as, const void* wt, const void* ws, const void* pu,
             cudaStream_t stream) {
  const int lsteps = p.R == 0 ? 0 : (p.R <= 32 ? 2 : 8);  // above 128: chunks of 128
  if (!maps<MODE>(p, qa, as, wt, ws, pu, lsteps)) return static_cast<int>(cudaErrorInvalidValue);
  if (lsteps == 0) return launch_w4a4<MODE, 0>(p, stream);
  if (lsteps == 2) return launch_w4a4<MODE, 2>(p, stream);
  return launch_w4a4<MODE, 8>(p, stream);
}


// ---------------------------------------------------------------------------
// The other design, as a yardstick (tools/time_w4a4.py; no path runs it): decode both operands once to bf16 in
// global memory, then run the bf16 GEMM probe's k_bf loop (gemm_probe_bf16.cu) on them. a16 (Mp, Kx) and w16
// (Kx, N) hold bf16(code x scale) in logical k order, as the kernel above multiplies them; columns / rows
// [K, Kx) append the rank-r term (bf16(lora_act) against proj_up) and the bias (a column of ones against it),
// zeros past them; a16's rows past M are zeros. Each thread decodes 16 packed bytes of a row (32 k).
// ---------------------------------------------------------------------------

struct DecodeParams {
  const unsigned char* qa;
  const bf16* as;
  const unsigned char* wt;
  const bf16* ws;
  const float* la;
  const bf16* pu;
  const bf16* bias;
  bf16* a16;
  bf16* w16;
  int M, Mp, N, K, R, Kx;
};

// the packed bytes [16 q, 16 q + 16) of a row: k = kb + [0, 16) (low nibbles) and kb + 128 + [0, 16) (high)
__device__ __forceinline__ int chunk_k(int q) { return q / 8 * 256 + q % 8 * 16; }

// thread (row m, chunk q of Kx / 32)
template <int MODE>
__global__ void w4a4_decode_a(const DecodeParams p) {
  using S = Shape<MODE>;
  const int qs = p.Kx / 32, idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.Mp * qs) return;
  const int m = idx / qs, q = idx % qs;
  uint32_t lo[8], hi[8];
  bf16* dst = p.a16 + static_cast<size_t>(m) * p.Kx;
  if (q < p.K / 32) {
    const int kb = chunk_k(q);
    if (m < p.M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p.qa + static_cast<size_t>(m) * (p.K / 2) + 16 * q);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      const uint32_t slo = bcast(p.as[kb / S::G * p.M + m]), shi = bcast(p.as[(kb + 128) / S::G * p.M + m]);
#pragma unroll
      for (int wd = 0; wd < 4; ++wd)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[2];
          decode_half<MODE>(words[wd], h, v);
          lo[2 * wd + h] = mul2(v[0], slo);
          hi[2 * wd + h] = mul2(v[1], shi);
        }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0u;
    }
    uint4* d0 = reinterpret_cast<uint4*>(dst + kb);
    uint4* d1 = reinterpret_cast<uint4*>(dst + kb + 128);
    d0[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d0[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    d1[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    d1[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    return;
  }
  const int c0 = 32 * q - p.K;  // the appended columns c0 .. c0 + 31: rank r < R, then the bias' ones
  for (int i = 0; i < 32; i += 2) {
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + i + e;
      x[e] = m >= p.M ? 0.f : (c < p.R ? p.la[static_cast<size_t>(m) * p.R + c] : (c == p.R && p.bias ? 1.f : 0.f));
    }
    *reinterpret_cast<uint32_t*>(dst + p.K + c0 + i) = pack_bf16(x[0], x[1]);
  }
}

// thread (column pair n, n + 1; chunk q of Kx / 32): the two rows' decoded pairs along k, transposed to pairs
// along n, one 4-byte store a row of w16 (a warp's 32 pairs: 128 contiguous bytes)
template <int MODE>
__global__ void w4a4_decode_w(const DecodeParams p) {
  using S = Shape<MODE>;
  const int np = p.N / 2, idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= np * (p.Kx / 32)) return;
  const int n = 2 * (idx % np), q = idx / np;
  bf16* dst = p.w16 + n;
  if (q < p.K / 32) {
    const int kb = chunk_k(q);
    const unsigned char* src = p.wt + static_cast<size_t>(n) * (p.K / 2) + 16 * q;
    const uint4 r0 = *reinterpret_cast<const uint4*>(src), r1 = *reinterpret_cast<const uint4*>(src + p.K / 2);
    const uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
    const uint32_t slo = *reinterpret_cast<const uint32_t*>(p.ws + kb / S::G * p.N + n);  // (s_n, s_n+1)
    const uint32_t shi = *reinterpret_cast<const uint32_t*>(p.ws + (kb + 128) / S::G * p.N + n);
    const uint32_t s[2][2] = {{__byte_perm(slo, 0, 0x1010), __byte_perm(slo, 0, 0x3232)},
                              {__byte_perm(shi, 0, 0x1010), __byte_perm(shi, 0, 0x3232)}};
#pragma unroll
    for (int wd = 0; wd < 4; ++wd)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v0[2], v1[2];
        decode_half<MODE>(w0[wd], h, v0);
        decode_half<MODE>(w1[wd], h, v1);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {  // the low and the high nibble plane
          const uint32_t a = mul2(v0[pl], s[pl][0]), b = mul2(v1[pl], s[pl][1]);
          const size_t k = kb + 128 * pl + 4 * wd + 2 * h;
          *reinterpret_cast<uint32_t*>(dst + k * p.N) = __byte_perm(a, b, 0x5410);
          *reinterpret_cast<uint32_t*>(dst + (k + 1) * p.N) = __byte_perm(a, b, 0x7632);
        }
      }
    return;
  }
  for (int i = 0; i < 32; ++i) {  // the appended rows: proj_up's, then the bias
    const int r = 32 * q - p.K + i;
    uint32_t v = 0u;
    if (r < p.R)
      v = *reinterpret_cast<const uint32_t*>(p.pu + static_cast<size_t>(r) * p.N + n);
    else if (r == p.R && p.bias)
      v = *reinterpret_cast<const uint32_t*>(p.bias + n);
    *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(p.K + r) * p.N) = v;
  }
}

template <int MODE>
int launch_decode(const DecodeParams& p, cudaStream_t stream) {
  constexpr int WMODE = MODE == E2M1 ? E2M1 : INT4_S;
  const int qs = p.Kx / 32, threads = 256;
  w4a4_decode_a<MODE><<<(p.Mp * qs + threads - 1) / threads, threads, 0, stream>>>(p);
  w4a4_decode_w<WMODE><<<(p.N / 2 * qs + threads - 1) / threads, threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qact (M, K/2) int8, ascales (K/G, M) bf16, wt (N, K/2) int8 (the packed
// (K/2, N) weight K-contiguous), wscales (K/G, N) bf16, lora_act (M, R) f32
// | null, proj_up (R, N) bf16 | null, bias (N,) bf16 | null -> out (M, N)
// bf16. mode: 0 int4 with signed activations, 1 int4 with unsigned
// activations, 2 nvfp4 (e2m1 codes). layer_idx: null, or a device int32
// naming the layer of a stack of L such weights that starts at wt (each
// (N, K/2), N * K/2 bytes apart). Needs K % 256 == 0, N % 128 == 0,
// M % 8 == 0 and 16-byte aligned operands (checked by the
// Python wrapper).
extern "C" int nt_gemm_w4a4(const void* qact, const void* ascales, const void* wt, const void* wscales,
                            const void* lora_act, const void* proj_up, const void* bias, void* out, int M,
                            int N, int K, int R, int mode, const void* layer_idx, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 256 != 0 || N % BN != 0 || M % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.la = static_cast<const float*>(lora_act);
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.layer_idx = static_cast<const int*>(layer_idx);
  p.L = L;
  p.M = M;
  p.N = N;
  p.K = K;
  p.R = lora_act != nullptr && proj_up != nullptr ? R : 0;
  if (mode == INT4_S) return dispatch<INT4_S>(p, qact, ascales, wt, wscales, proj_up, s);
  if (mode == INT4_U) return dispatch<INT4_U>(p, qact, ascales, wt, wscales, proj_up, s);
  if (mode == E2M1) return dispatch<E2M1>(p, qact, ascales, wt, wscales, proj_up, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode yardstick (tools/time_w4a4.py): the operands and mode of nt_gemm_w4a4 (the weight not a stack) ->
// a16 (Mp, Kx) and w16 (Kx, N) bf16, whose bf16 product with f32 sums is the W4A4 GEMM's function. Needs
// K % 256 == 0, N % 2 == 0, Mp >= M, Kx % 32 == 0, Kx >= K + R (+ 1 with a bias), 16-byte aligned qact / wt.
extern "C" int nt_w4a4_decode(const void* qact, const void* ascales, const void* wt, const void* wscales,
                              const void* lora_act, const void* proj_up, const void* bias, void* a16, void* w16,
                              int M, int Mp, int N, int K, int R, int Kx, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lora_act == nullptr || proj_up == nullptr) R = 0;
  if (K % 256 != 0 || N % 2 != 0 || Mp < M || Kx % 32 != 0 || Kx < K + R + (bias != nullptr ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeParams p{static_cast<const unsigned char*>(qact), static_cast<const bf16*>(ascales),
                       static_cast<const unsigned char*>(wt), static_cast<const bf16*>(wscales),
                       static_cast<const float*>(lora_act), static_cast<const bf16*>(proj_up),
                       static_cast<const bf16*>(bias), static_cast<bf16*>(a16), static_cast<bf16*>(w16),
                       M, Mp, N, K, R, Kx};
  if (mode == INT4_S) return launch_decode<INT4_S>(p, s);
  if (mode == INT4_U) return launch_decode<INT4_U>(p, s);
  if (mode == E2M1) return launch_decode<E2M1>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
