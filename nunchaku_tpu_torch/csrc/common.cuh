// Shared device helpers for the port's Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// 16-byte global->shared async copy; pred == false zero-fills the 16 bytes
// without reading the source (ragged tile edges).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

// eight f32 of a read-only operand (32-byte aligned)
__device__ __forceinline__ void ldg8f(float (&d)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p)), b = __ldg(reinterpret_cast<const float4*>(p + 4));
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
}

// The stacked-weight (layer-index) modes of the 4-bit GEMMs and the dequant:
// the kernel-side counterpart of the Pallas kernels' scalar prefetch of the
// scan's layer index. ``idx`` is a 0-d int32 tensor on the card (the index
// never passes through the host, so a block loop can be captured in a CUDA
// graph); each block reads it once at entry and moves the weight pointer to
// layer idx of the (L, K/2, N) stack: idx * (K/2) * N bytes, whichever of
// (K/2, N) and (N, K/2) the layer is stored as. An index outside [0, L) is
// clamped to the nearest layer, so the kernel never reads outside the stack
// (the plain PyTorch twins raise on it).
__device__ __forceinline__ const int8_t* stacked_layer(const int8_t* w, const int* idx, int L, size_t layer_bytes) {
  if (idx == nullptr) return w;
  int l = __ldg(idx);
  l = l < 0 ? 0 : (l >= L ? L - 1 : l);
  return w + static_cast<size_t>(l) * layer_bytes;
}

// tanh-approx GELU in the operation order of the JAX epilogue
// (ops/gemm.py _tanh_gelu): 0.5*x*(1+tanh(c*(x+0.044715*x*x*x))).
// The _rn intrinsics keep nvcc from contracting into FMAs, so the float
// rounding follows the plain PyTorch twin step by step (tanhf aside).
__device__ __forceinline__ float tanh_gelu(float x) {
  float x3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  float z = __fmul_rn(0.7978845608028654f, __fadd_rn(x, x3));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(z)));
}
