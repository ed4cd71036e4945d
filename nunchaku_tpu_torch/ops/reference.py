"""Numerics constants and small reference ops of the port's main path.

Copies of what ``nunchaku_tpu/ops/reference.py`` defines for the w4a8
FLUX path: the int4 group size, the post-GELU shift of unsigned next
layers, the tanh-approximated GELU and RMSNorm; and the parameter-free
LayerNorm of ``nunchaku_tpu/models/normalization.py``.
"""

from __future__ import annotations

import torch

GROUP_INT4 = 64
GELU_SHIFT = 0.171875  # makes post-GELU activations non-negative (unsigned next layer)
# absmax -> int8 scale. XLA compiles the JAX package's ``absmax / 127.0`` into
# a multiply by the f32 reciprocal of 127; the port does the same, so its
# scales (and codes) match bit for bit.
RCP127 = 1.0 / 127.0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU in f32, in the JAX epilogue's operation order
    (``ops/gemm.py _tanh_gelu``): ``0.5*x*(1+tanh(c*(x+0.044715*x*x*x)))``."""
    x = x.float()
    z = 0.7978845608028654 * (x + ((0.044715 * x) * x) * x)
    return (0.5 * x) * (1.0 + torch.tanh(z))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """RMSNorm in f32 with eps 1e-6."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + 1e-6) * weight.float()


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free LayerNorm in f32, eps 1e-6 (mean, then the mean of
    squared deviations, like ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    return d * torch.rsqrt(var + 1e-6)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on bf16-rounded operands with f32 accumulation (JAX's
    ``dot(bf16, bf16, preferred_element_type=f32)``). Runs as an f32
    product of bf16 values: every product is exact in f32, and with TF32
    off (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
    default) the sums stay f32 on the card too."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product (``torch._int_mm``, on the CPU
    and the card). On the card it needs M > 16 and K, N multiples of 8; the
    callers pad small M. A K-contiguous ``b`` (strides (1, K), as the dequant
    kernel writes it) is passed as it is: cuBLAS's int8 tensor-core kernels
    take both operands K-contiguous."""
    if not (b.is_contiguous() or b.t().is_contiguous()):
        b = b.contiguous()
    return torch._int_mm(a.contiguous(), b)
