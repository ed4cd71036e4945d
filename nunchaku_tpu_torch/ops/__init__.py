"""Kernels of the port and their launch counts.

Each kernel wrapper keeps a plain integer ``launches`` that grows by one
for every call that launches its CUDA kernel (never for the plain PyTorch
twin), so a run can show which kernels the main path went through.
"""

from __future__ import annotations

from .attention import flash_attention, flash_attention_online, qkv_rope_producer
from .gemm import dequant_w4a8, gemm_w8a8_grouped, gemm_w8a8_grouped_res, svdq_gemm_w8a8_gelu_quant
from .quantize import ln_mod_quant_int8

KERNEL_WRAPPERS = {
    "dequant_w4a8": dequant_w4a8,
    "gemm_w8a8_gelu_quant": svdq_gemm_w8a8_gelu_quant,
    "gemm_w8a8_grouped": gemm_w8a8_grouped,
    "flash_fixed": flash_attention,
    "ln_mod_quant_int8": ln_mod_quant_int8,
    "qkv_rope_producer": qkv_rope_producer,
    "gemm_w8a8_grouped_res": gemm_w8a8_grouped_res,
    "flash_online": flash_attention_online,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
