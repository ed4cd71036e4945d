"""AWQ W4A16 (weight-only 4-bit) linear: the kernel for small M and the
dequantize-then-multiply route for large M.

Counterparts of ``nunchaku_tpu/ops/gemv.py``:

* :func:`awq_w4a16_linear` -- kernel ``csrc/gemv_awq.cu`` (JAX
  ``_gemv_kernel`` :25, ``awq_w4a16_linear`` :58), for M < 16 (the AdaLN
  modulation linears of the int4 / nvfp4 models run at M = batch);
* :func:`awq_w4a16_linear_plain` -- its plain PyTorch twin, which is also
  the large-M route (JAX ``awq_w4a16_linear_xla`` :128, left to XLA there):
  the weight dequantized to bf16 once, then one product.

Weights are asymmetric: ``w = bf16(q * wscale - wzero)`` computed in f32,
q an unsigned nibble, one scale and zero per 64 rows of K (the kernel; the
large-M route takes any group, as T5's TinyChat files need); the (K/2, N)
weight is packed along K in the block-split-half layout.
"""

from __future__ import annotations

import torch

from ..core.packing import PACK_BLOCK, unpack_int4
from . import _build
from .reference import GROUP_INT4, bf16_matmul

AWQ_XLA_MIN_M = 16  # M at and above which the dequantize-then-multiply route runs (JAX gemv.py:168)
KERNEL_MAX_M = 8  # rows per kernel launch
KERNEL_COLS = 256  # columns per block of csrc/gemv_awq.cu
KERNEL_K_BLOCK = 512  # k per block (the kernel's K split)


def awq_dequant(qweight: torch.Tensor, wscales: torch.Tensor, wzeros: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed unsigned nibbles -> (K, N) bf16 ``q * s - z``, one
    scale and zero per K/G rows (G = K / wscales.shape[0])."""
    q = unpack_int4(qweight, 0, unsigned=True).float()
    g = q.shape[0] // wscales.shape[0]
    s = wscales.float().repeat_interleave(g, dim=0)
    z = wzeros.float().repeat_interleave(g, dim=0)
    return (q * s - z).to(torch.bfloat16)


def awq_w4a16_linear_plain(x, qweight, wscales, wzeros, bias=None):
    """``x @ dequant(qweight) + bias`` -> (M, N) f32, bf16 operands and f32
    sums: the kernel's twin and the large-M route."""
    out = bf16_matmul(x, awq_dequant(qweight, wscales, wzeros))
    if bias is not None:
        out = out + bias.float()[None, :]
    return out


def awq_w4a16_linear(x, qweight, wscales, wzeros, bias=None):
    """:func:`awq_w4a16_linear_plain` for small M: x (M, K) bf16, qweight
    (K/2, N) int8, wscales / wzeros (K/64, N) bf16, bias (N,) or None ->
    (M, N) f32. On the card each launch takes up to 8 rows of x."""
    if not x.is_cuda:
        return awq_w4a16_linear_plain(x, qweight, wscales, wzeros, bias)
    m, k = x.shape
    n = qweight.shape[1]
    _build.require(x.dtype == torch.bfloat16, "x: bf16 expected")
    _build.require(qweight.dtype == torch.int8 and qweight.is_contiguous() and tuple(qweight.shape) == (k // 2, n),
                   "qweight: contiguous (K/2, N) int8")
    _build.require(k % PACK_BLOCK == 0 and n % KERNEL_COLS == 0,
                   f"AWQ kernel needs K % 256 == 0, N % 256 == 0 (K={k}, N={n})")
    for name, t in (("wscales", wscales), ("wzeros", wzeros)):
        _build.require(t.dtype == torch.bfloat16 and t.is_contiguous() and tuple(t.shape) == (k // GROUP_INT4, n),
                       f"{name}: contiguous bf16 (K/64, N)")
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    lib = _build.library()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = -(-k // KERNEL_K_BLOCK)
    for r0 in range(0, m, KERNEL_MAX_M):
        xr = x[r0:r0 + KERNEL_MAX_M].contiguous()
        rows = xr.shape[0]
        part = torch.empty((splits, rows, n), dtype=torch.float32, device=x.device)
        _build.check(lib.nt_gemv_awq(xr.data_ptr(), qweight.data_ptr(), wscales.data_ptr(), wzeros.data_ptr(),
                                     None if b is None else b.data_ptr(), part.data_ptr(), out[r0:].data_ptr(),
                                     rows, n, k, torch.cuda.current_stream(x.device).cuda_stream), "gemv_awq")
        awq_w4a16_linear.launches += 1
    return out


awq_w4a16_linear.launches = 0
