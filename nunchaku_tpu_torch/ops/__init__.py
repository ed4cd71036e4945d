"""Kernels of the port and their launch counts.

Each kernel mode keeps a plain integer ``launches`` that grows by one for
every call that launches its CUDA kernel (never for the plain PyTorch
twin), so a run can show which kernels the main path went through. The
flash kernels count their kv-mask and block-sparse forms apart (the
fixed-shift kernel also its denominator, two-tile and int8 forms), the online
flash kernel its head-dim-64 and head-dim-112 and token-major forms, the LN
producer its dual mode, the qkv producer its prepare mode; every GEMM and dequant
mode counts in ``ops.gemm.COUNTS``, through one rule: a launch on layer
``layer_idx`` of a stack counts under the mode's name + ``_stacked``. The two
GEMM probe kernels no model path launches count per instantiation in
``ops.gemm_probe.COUNTS`` (``<mode>@<tile>`` for the int8 one's tiles).
"""

from __future__ import annotations

from .attention import (BS_COUNTS, FIXED_FORM_COUNTS, MASKED_COUNTS, ONLINE_DIM_COUNTS, flash_attention,
                        flash_attention_bshd, flash_attention_online, qkv_prepare, qkv_rope_producer)
from .gemm import COUNTS as GEMM_COUNTS
from .gemm_probe import COUNTS as PROBE_COUNTS
from .gemv import awq_w4a16_linear
from .quantize import ln_mod_quant_int8, ln_mod_quant_int8_dual

KERNEL_WRAPPERS = {
    "flash_fixed": flash_attention,
    "ln_mod_quant_int8": ln_mod_quant_int8,
    "qkv_rope_producer": qkv_rope_producer,
    "flash_online": flash_attention_online,
    "gemv_awq": awq_w4a16_linear,
    **MASKED_COUNTS,  # flash_fixed_masked, flash_online_masked
    **BS_COUNTS,  # bs_fixed, bs_online
    **FIXED_FORM_COUNTS,  # flash_fixed_denom, flash_fixed_unroll2, flash_fixed_i8
    "flash_online_d64": ONLINE_DIM_COUNTS[64],
    "flash_online_d112": ONLINE_DIM_COUNTS[112],
    # the four op-level entry points no model path calls (as in JAX)
    "ln_mod_quant_dual": ln_mod_quant_int8_dual,
    "qkv_prepare": qkv_prepare,
    "flash_online_bshd": flash_attention_bshd,
    **GEMM_COUNTS,  # every GEMM / dequant mode (ops.gemm.MODES) and its stacked form, mode + "_stacked";
    # gemm_w8a8_gelu_quant_pipe (pipelined=True), which has none
    **PROBE_COUNTS,  # the GEMM probes of nunchaku_tpu_torch/tools (no model path)
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
