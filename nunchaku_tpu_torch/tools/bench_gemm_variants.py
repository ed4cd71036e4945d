"""The GEMM variants of the W4A4 product, each alone, on the card.

Port of ``tools/bench_gemm_variants.py`` (the TPU script that isolated the
costs of the W4A4 kernel at FLUX's fc1 shape, M 4608, K 3072, N 12288): the
same inputs (``numpy.random.default_rng(0)``, the same draws in the same
order), the same variant names and 30 timed calls each after one untimed;
each line prints ms and TF/s, on the card also the share of the bound.

    python -m nunchaku_tpu_torch.tools.bench_gemm_variants

Variant -> the port:

* ``V_base bf16 mm`` (``k_bf`` :55): ``gemm_probe_bf16``, bf16 x bf16;
* ``V1 unpack only`` (``k_v1`` :70): both operands packed int4, no scales;
* ``V2 int8+scales`` (``k_v2`` :81): int4 codes held as int8, both scaled;
* ``V3 current full``: the port's ``svdq_gemm_w4a4`` at int4 (the W4A4
  kernel, ``csrc/gemm_w4a4.cu``), as the JAX line calls the JAX package's;
* ``V4 packed-a/i8-w`` (``k_v4`` :96): packed A, int8-held W, scaled;
* ``V5 int8 dot`` (``k_i8dot`` :107): ``gemm_probe_i8``, each K tile's int32
  partial added in f32, cast to bf16;
* ``V6 plane-split`` (``k_v6`` :118): packed both, scaled (one decode in
  shared memory: the plane split was a TPU relayout workaround);
* ``V7 w8a8 turbo`` (``k_v7`` :159): the int8 product in f32 with the rank-1
  epilogue ``acc * a_scale[m] * w_scale[n]``;
* ``V7 <tile>`` (``v7_with`` :178): the same at each card tile the kernel
  is built for. The JAX script's nine TPU tiles (sized for 16 MB of VMEM)
  do not carry over.

The int8 weights are held K-contiguous (the kernel's and ``torch._int_mm``'s
layout, as the port's linears hold them), built once before timing; the
bf16-operand kernel reads its weights N-contiguous, as drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gemm import svdq_gemm_w4a4
from ..ops.gemm_probe import gemm_probe_bf16, gemm_probe_i8
from .probe_common import RANK1_TILES, bound, k_contiguous, nvidia_smi, row, share, tensor, tile_fits, time_ms

M, K, N = 4608, 3072, 12288


def inputs(m, k, n, device):
    """The JAX script's draws, in its order, as tensors on ``device``."""
    rng = np.random.default_rng(0)
    qa = tensor(rng.integers(-127, 128, (m, k // 2)), torch.int8, device)
    qa8 = tensor(rng.integers(-7, 8, (m, k)), torch.int8, device)
    asc = tensor(rng.random((k // 64, m)), torch.bfloat16, device)
    qw = tensor(rng.integers(-127, 128, (k // 2, n)), torch.int8, device)
    qw8 = tensor(rng.integers(-7, 8, (k, n)), torch.int8, device)
    ws = tensor(rng.random((k // 64, n)), torch.bfloat16, device)
    wbf = tensor(rng.random((k, n)), torch.bfloat16, device)
    abf = tensor(rng.random((m, k)), torch.bfloat16, device)
    at = tensor(rng.random((1, m)), torch.float32, device)
    wt = tensor(rng.random((1, n)), torch.float32, device)
    return dict(qa=qa, qa8=qa8, asc=asc, qw=qw, qw8=qw8, ws=ws, wbf=wbf, abf=abf, at=at, wt=wt)


def variants(x, m, k, n):
    """(name, call, bytes its operands and output move, int8 ops, bf16 flop)."""
    qw_k = k_contiguous(x["qw"])  # the W4A4 kernel reads its packed weight K-contiguous
    qw8_k = k_contiguous(x["qw8"])
    flop = 2 * m * k * n
    out = 2 * m * n
    sc = 2 * (k // 64) * (m + n)
    vs = [("V_base bf16 mm", lambda: gemm_probe_bf16(x["abf"], x["wbf"]), 2 * m * k + 2 * k * n + out, 0, flop),
          ("V1 unpack only  ", lambda: gemm_probe_bf16(x["qa"], x["qw"], a_form="p4", w_form="p4"),
           m * k // 2 + k * n // 2 + out, 0, flop),
          ("V2 int8+scales  ", lambda: gemm_probe_bf16(x["qa8"], x["qw8"], x["asc"], x["ws"], a_form="i8",
                                                       w_form="i8"), m * k + k * n + sc + out, 0, flop),
          ("V3 current full ", lambda: svdq_gemm_w4a4(x["qa"], x["asc"], qw_k, x["ws"], precision="int4"),
           m * k // 2 + k * n // 2 + sc + out, 0, flop),
          ("V4 packed-a/i8-w", lambda: gemm_probe_bf16(x["qa"], x["qw8"], x["asc"], x["ws"], a_form="p4",
                                                       w_form="i8"), m * k // 2 + k * n + sc + out, 0, flop),
          ("V5 int8 dot     ", lambda: gemm_probe_i8(x["qa8"], qw8_k, acc="f32"), m * k + k * n + out, flop, 0),
          ("V6 plane-split  ", lambda: gemm_probe_bf16(x["qa"], x["qw"], x["asc"], x["ws"], a_form="p4",
                                                       w_form="p4"), m * k // 2 + k * n // 2 + sc + out, 0, flop),
          ("V7 w8a8 turbo   ", lambda: gemm_probe_i8(x["qa8"], qw8_k, x["at"], x["wt"], acc="f32"),
           m * k + k * n + 4 * (m + n) + out, flop, 0)]
    for tile in RANK1_TILES:
        if tile_fits(tile, m, k, n):
            vs.append((f"V7 {tile}", lambda tile=tile: gemm_probe_i8(x["qa8"], qw8_k, x["at"], x["wt"], acc="f32",
                                                                     tile=tile),
                       m * k + k * n + 4 * (m + n) + out, flop, 0))
    return vs


def run(device="cuda", m=M, k=K, n=N, iters=30, log=print) -> list[dict]:
    """Time every variant on ``device`` -> one row each (name, ms, tflops,
    bound_ms, of_bound); ``log`` receives each line as the JAX script prints
    it."""
    x = inputs(m, k, n, device)
    rows = []
    with torch.no_grad():
        for name, fn, nbytes, i8_ops, bf16_ops in variants(x, m, k, n):
            r = row(name, time_ms(fn, iters, device, warmup=1), 2 * m * k * n, bound(nbytes, i8_ops, bf16_ops)[0],
                    device)
            log(f"{name}: {r['ms']:.3f} ms {r['tflops']:.1f} TF/s{share(r)}")
            rows.append(r)
    return rows


def main(argv=None) -> int:
    """Every variant at the JAX script's sizes on the card; like the JAX
    script, it reads no arguments."""
    print(nvidia_smi(), flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
