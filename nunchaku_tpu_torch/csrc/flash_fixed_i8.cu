// Fixed-shift flash attention with int8 q . k, non-causal, head_dim 128: the
// int8 form (I8) of the Hopper attention core (flash_sm90.cuh, policy FIXED).
//
// Replaces nunchaku_tpu/ops/attention.py _flash_kernel_fixed_i8 (:563, launched
// by flash_attention_i8 :994; FLUX's attention under attn_int8, q and k
// quantized per (batch, head, token) by quantize_qk :974):
//   s = (f32(q8 . k8) * qs[row]) * ks[col];  columns past Skv -> -1e30
//   p = exp2(min(s, 116) - 16);  l = sum of the f32 p;  o = (bf16(p) @ v) / l
// q carries softmax-scale * log2(e) from before its quantization. p . v stays
// bf16: p is unbounded under the fixed shift, so int8 p would need a running
// max again. The exponential is ex2.approx.ftz, as in every fixed form.
//
// Bound on the H100: operations. Half the work (q . k, 2*S_q*S_kv*D per head)
// at the int8 rate, half (p . v) at the bf16 rate; the bytes (int8 q and k,
// bf16 v and output, the scales) are ~S/2 below the work at FLUX's S = 4608.
// Design: the core's block of 128 query rows (a TMA producer warpgroup, two
// wgmma consumer warpgroups of 64 rows), with q and k as one 128-byte panel
// of int8 each: q . k is four wgmma m64n128k32 s8 steps with s32
// accumulators (exact: |q8 . k8| <= 128 * 127^2 < 2^24 also converts to f32
// exactly), p . v the bf16 RS chain of the other forms. A k + v stage is 48
// KB, so the ring holds four. Each tile's 128 column scales arrive by a bulk
// copy beside its k (the wrapper pads ks with zeros to whole tiles, as JAX
// pads it to whole kv blocks); each thread's two row scales are read once
// into registers.
#include "flash_sm90.cuh"

// q8 (B, H, Sq, 128) int8 and qs (B, H, Sq) f32, k8 (B, H, Skv, 128) int8 and
// ks (B, H, ks_ld) f32 (each row padded with zeros to ks_ld = Skv rounded up
// to 128), v (B, H, Skv, 128) bf16 -> out (B, Sq, H*128) bf16 when bshd, else
// (B, H, Sq, 128).
extern "C" int nt_flash_fixed_i8(const void* q8, const void* qs, const void* k8, const void* ks, const void* v,
                                 void* out, int B, int H, int Sq, int Skv, int bshd, void* stream) {
  const Sparse dense{nullptr, 0, 0, 0, 0, 1.f};
  return sm90::launch<sm90::FIXED, 128, sm90::I8>(q8, k8, v, ks, out, nullptr, B, H, Sq, Skv, bshd, dense,
                                                  static_cast<cudaStream_t>(stream), static_cast<const float*>(qs));
}
