"""Numerics constants and small reference ops of the port's main path.

Copies of what ``nunchaku_tpu/ops/reference.py`` defines for the FLUX
path: the int4 and nvfp4 group sizes, the post-GELU shift of unsigned next
layers, the tanh-approximated GELU and RMSNorm; the e2m1 (nvfp4) code
decode and encode of ``ops/gemm.py`` / ``ops/quantize.py`` and its largest
value (``core/dtypes.py``); and the parameter-free LayerNorm of
``nunchaku_tpu/models/normalization.py``.
"""

from __future__ import annotations

import torch

GROUP_INT4 = 64
GROUP_FP4 = 16
E2M1_MAX = 6.0  # largest e2m1 magnitude
GELU_SHIFT = 0.171875  # makes post-GELU activations non-negative (unsigned next layer)
# absmax -> int8 scale. XLA compiles the JAX package's ``absmax / 127.0`` into
# a multiply by the f32 reciprocal of 127; the port does the same, so its
# scales (and codes) match bit for bit.
RCP127 = 1.0 / 127.0
# The int4 / nvfp4 scales' divisors compile the same way (absmax / 7, / 15, / 6).
RCP7, RCP15, RCP_E2M1_MAX = 1.0 / 7.0, 1.0 / 15.0, 1.0 / E2M1_MAX


def is_4bit(precision: str) -> bool:
    """The SVDQuant parity precisions: 4-bit codes with per-group scales on
    both operands (int4, nvfp4). Their linears quantize their own
    activations (no int8 producer or chain) and their modulation linears
    are AWQ W4A16; int8 and w4a8 linears take int8 activations."""
    return precision in ("int4", "nvfp4")


def group_size(precision: str) -> int:
    """Scale group along K of the 4-bit precisions; -1: one group per row (int8)."""
    if precision == "int4":
        return GROUP_INT4
    if precision == "nvfp4":
        return GROUP_FP4
    if precision == "int8":
        return -1
    raise ValueError(f"unknown precision {precision!r}")


def decode_e2m1(code: torch.Tensor) -> torch.Tensor:
    """Signed e2m1 code (integer tensor, [-8, 7]) -> f32 value: magnitude
    ``0.5 m`` for ``e == 0``, else ``(1 + 0.5 m) 2^(e-1)`` with ``e = |c| >> 1``,
    ``m = |c| & 1`` (JAX ``_decode_e2m1``; the stray code -8 decodes to -8)."""
    a = code.to(torch.int32).abs()
    e = a >> 1
    m = (a & 1).float()
    mag = torch.where(e == 0, 0.5 * m, (1.0 + 0.5 * m) * torch.exp2((e - 1).float()))
    return torch.where(code < 0, -mag, mag)


def e2m1_value_to_code(v: torch.Tensor) -> torch.Tensor:
    """Exact e2m1 values {0, +-.5, +-1, +-1.5, +-2, +-3, +-4, +-6} -> int8 codes
    (JAX ``_e2m1_value_to_code``)."""
    t = torch.nan_to_num(2.0 * v.abs(), nan=0.0).to(torch.int32)  # {0, 1, 2, 3, 4, 6, 8, 12}; NaN -> 0 as in XLA
    idx = torch.where(t <= 4, t, torch.where(t == 6, 5, torch.where(t == 8, 6, 7)))
    return torch.where(v < 0, -idx, idx).to(torch.int8)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU in f32, in the JAX epilogue's operation order
    (``ops/gemm.py _tanh_gelu``): ``0.5*x*(1+tanh(c*(x+0.044715*x*x*x)))``."""
    x = x.float()
    z = 0.7978845608028654 * (x + ((0.044715 * x) * x) * x)
    return (0.5 * x) * (1.0 + torch.tanh(z))


def gelu_jax(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU in f32 in the order of ``jax.nn.gelu(approximate=
    True)``: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``, the
    unfused MLP's activation (the chain epilogue's order is :func:`gelu`)."""
    x = x.float()
    z = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(z)))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 (eps 1e-6 unless given)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * weight.float()


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
