// Fixed-shift flash attention, non-causal, head_dim 128: every form is an
// instantiation of the Hopper attention core (flash_sm90.cuh, policy FIXED).
//
// Replaces nunchaku_tpu/ops/attention.py _flash_kernel_fixed (:403, launched
// by flash_attention :672 with fixed_softmax=True, out_bshd=True), with and
// without its kv mask (:410-411, :428-429):
//   s = f32(q . k) [+ mask[b, col]];  padded kv columns -> -1e30
//   p = exp2(min(s, 116) - 16)        (no running max: q carries the log2(e)
//                                      softmax scale, so s stays far below 116)
//   l = sum of the f32 p;  o = (bf16(p) @ v) / l, written as (B, S, H*D) bf16
// p can reach 2^100, so the PV product takes bf16 p (fp16 would overflow).
// The exponential is ex2.approx.ftz of the f32 argument (the twin's torch.exp2
// is exact to the f32 step; a p below 2^-126 is 0 here).
//
// Bound on the H100: operations (4*S_q*S_kv*D per head in bf16; at FLUX.1-dev
// S = 4608 the work per byte is ~S/2, far above the bf16 ridge). Design: the
// core's block of 128 query rows, one TMA producer warpgroup and two wgmma
// consumer warpgroups, k / v in 128-row tiles through a two-stage ring. The
// fixed shift has no running max and no rescale: a consumer's exp2 pass of
// one tile runs while the tensor cores do the other consumer's products; each
// thread keeps f32 row-sum shares of its two rows, met across the lane quad
// at the end.
//
// The mask form (MASK; Qwen-Image's padded prompts) adds a (B, S_kv) f32
// log2-domain bias, 0 or -1e30 for a bool mask, to each logit before the cap
// (the wrapper pads each bias row with -1e30 to whole tiles; the producer
// copies a tile's 128 values into shared memory beside its k). A 0
// bias leaves the logits bit for bit those of the unmasked kernel; a masked
// column gives exp2(min(-1e30 + q . k, 116) - 16) = exp2(-1e30), exactly 0,
// so it adds nothing to the row sum or to p @ v.
//
// The block-sparse form (IDX) replaces _bs_kernel_fixed (:1109, launched by
// block_sparse_attention :1241 with fixed_softmax=True): the same arithmetic
// (logits times an f32 scale_log2, 1 when q is prescaled), but each query row
// attends only to the kv blocks of bkv columns that select_blocks picked for
// its query block of bq rows. The ids, (B*H, Sq/bq, kk) int32 ascending, stay
// on the card; the producer and the consumers walk the same 128-column
// sub-tiles of the selected blocks in order (sparse_walk.cuh), and only those
// are loaded. Only the largest id can be the ragged tail block: its sub-tiles
// past Skv are not visited, and its columns past Skv inside a visited one are
// masked as in the dense loop. With every block selected the walk is the
// dense loop's, so the output equals the plain form's bit for bit.
//
// The denominator form (DENOM) replaces _flash_kernel_fixed_denom (:461,
// flash_attention :672 with return_denom=True), the step kernel of the ring
// (sequence-parallel) attention in nunchaku_tpu/parallel/sp.py: the dense loop
// unchanged (logits times scale_log2, exactly 1 for a prescaled q, so the
// logits, p and o are bit for bit the plain form's), the output in (B, H, Sq,
// D) and the f32 row sum l = sum p written beside it as (B, H, Sq). The fixed
// shift makes partial results over disjoint kv shards combine exactly, o =
// sum_i o_i l_i / sum_i l_i, so each ring step needs only o and l.
//
// The two-tile form (U2) replaces _flash_kernel_fixed2 (:508, flash_attention
// with kv_unroll=2): JAX's step of two 64-column tiles is one 128-column tile
// of the core, and each step adds (sum p1 + sum p2) of its two halves to the
// thread's row sums (the twin's l + (ps0 + ps1)), as every form here does;
// p . v runs through the wgmma chain.
#include "flash_sm90.cuh"

namespace {

constexpr int D = 128;

template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, float* lsum, int B, int H,
           int Sq, int Skv, int bshd, const Sparse& sp, cudaStream_t stream) {
  return sm90::launch<sm90::FIXED, D, FORM>(q, k, v, mask, out, lsum, B, H, Sq, Skv, bshd, sp, stream);
}

}  // namespace

// q (B, H, Sq, 128) carrying softmax-scale * log2(e), k/v (B, H, Skv, 128)
// bf16, mask null or a (B, Skv) f32 log2-domain bias whose rows are padded
// with -1e30 to a multiple of 128 -> out (B, Sq, H*128) bf16.
extern "C" int nt_flash_fixed(const void* q, const void* k, const void* v, const void* mask, void* out,
                              int B, int H, int Sq, int Skv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sparse dense{nullptr, 0, 0, 0, 0, 1.f};
  return mask ? launch<sm90::MASK>(q, k, v, mask, out, nullptr, B, H, Sq, Skv, 1, dense, s)
              : launch<sm90::PLAIN>(q, k, v, mask, out, nullptr, B, H, Sq, Skv, 1, dense, s);
}

// Block-sparse: q (B, H, Sq, 128), k/v (B, H, Skv, 128) bf16, idx (B*H, nq,
// kk) int32 kv-block ids (nq = ceil(Sq / bq); bq, bkv multiples of 128),
// logits times scale_log2 -> out (B, Sq, H*128) when bshd, else (B, H, Sq, 128).
extern "C" int nt_bs_fixed(const void* q, const void* k, const void* v, const void* idx, void* out, int B,
                           int H, int Sq, int Skv, int nq, int kk, int bq, int bkv, int bshd,
                           float scale_log2, void* stream) {
  if (bq % sm90::BQ || bkv % sm90::BKV || kk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Sparse sp{static_cast<const int*>(idx), nq, kk, bq, bkv, scale_log2};
  return launch<sm90::IDX>(q, k, v, nullptr, out, nullptr, B, H, Sq, Skv, bshd, sp,
                           static_cast<cudaStream_t>(stream));
}

// Denominator form: q (B, H, Sq, 128), k/v (B, H, Skv, 128) bf16, logits times
// scale_log2 -> out (B, H, Sq, 128) bf16 and l (B, H, Sq) f32, the row sums of p.
extern "C" int nt_flash_fixed_denom(const void* q, const void* k, const void* v, void* out, void* l, int B, int H,
                                    int Sq, int Skv, float scale_log2, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  return launch<sm90::DENOM>(q, k, v, nullptr, out, static_cast<float*>(l), B, H, Sq, Skv, 0, dense,
                             static_cast<cudaStream_t>(stream));
}

// Two-tile form: as nt_flash_fixed without a mask, logits times scale_log2, out
// (B, Sq, H*128) when bshd, else (B, H, Sq, 128).
extern "C" int nt_flash_fixed_unroll2(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
                                      int Skv, int bshd, float scale_log2, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, scale_log2};
  return launch<sm90::U2>(q, k, v, nullptr, out, nullptr, B, H, Sq, Skv, bshd, dense,
                          static_cast<cudaStream_t>(stream));
}
