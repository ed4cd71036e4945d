"""Kernels of the port and their launch counts.

Each kernel wrapper keeps a plain integer ``launches`` that grows by one
for every call that launches its CUDA kernel (never for the plain PyTorch
twin), so a run can show which kernels the main path went through. The
W4A4 GEMM counts each of its modes apart, the dequant its e2m1 form, the
flash kernels their kv-mask and block-sparse forms, the online flash kernel
its head-dim-64 and head-dim-112 forms, the packed w4a8 GEMM its rank-1
and grouped modes, and the stacked (layer-index) modes of the W4A4 GEMM,
the dequant and the packed GEMM theirs.
"""

from __future__ import annotations

from .attention import (BS_COUNTS, MASKED_COUNTS, ONLINE_DIM_COUNTS, flash_attention, flash_attention_online,
                        qkv_rope_producer)
from .gemm import (DEQUANT_E2M1, STACKED_COUNTS, W4A4_COUNTS, dequant_w4a8, gemm_w4a8, gemm_w4a8_grouped, gemm_w8a8_grouped,
                   gemm_w8a8_grouped_res, svdq_gemm_w4a8_gelu_quant, svdq_gemm_w8a8_gelu_quant)
from .gemv import awq_w4a16_linear
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
    **W4A4_COUNTS,  # gemm_w4a4 by mode: gemm_w4a4_int4, gemm_w4a4_int4_unsigned, gemm_w4a4_nvfp4
    "gemv_awq": awq_w4a16_linear,
    **MASKED_COUNTS,  # flash_fixed_masked, flash_online_masked
    **BS_COUNTS,  # bs_fixed, bs_online
    "dequant_w4a8_e2m1": DEQUANT_E2M1,
    "gemm_w4a8": gemm_w4a8,
    "gemm_w4a8_grouped": gemm_w4a8_grouped,
    "gemm_w4a8_gelu_quant": svdq_gemm_w4a8_gelu_quant,
    "flash_online_d64": ONLINE_DIM_COUNTS[64],
    "flash_online_d112": ONLINE_DIM_COUNTS[112],
    **STACKED_COUNTS,  # gemm_w4a4_int4_stacked, gemm_w4a4_nvfp4_stacked, dequant_w4a8_stacked, gemm_w4a8_stacked
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
