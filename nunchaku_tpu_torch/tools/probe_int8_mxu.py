"""What limits the int8 product on the card, at FLUX's qkv shape.

Port of ``tools/probe_int8_mxu.py`` (the TPU probe of M 4608, K 3072, N
3072): the same inputs (``numpy.random.default_rng(0)``, the same draws),
the same lines and 30 timed calls each after one untimed; each line prints
TF/s, and its ms and share of the card's bound.

    python -m nunchaku_tpu_torch.tools.probe_int8_mxu

Line -> the port (``pallas_mm`` / ``mk_kernel`` :48, :73 -> the probe kernels):

* A. the bf16 product: ``gemm_probe_bf16`` (bf16 x bf16, f32 sums);
* B. int8, each K tile's int32 partial added in f32: ``gemm_probe_i8(acc="f32")``;
* C. int8, int32 throughout: ``gemm_probe_i8(acc="i32")``;
* D. int8 with all of K in one tile: not expressible on this card (a
  256 x 3072 int8 A tile alone is 768 KB, a block holds at most 227 KB of
  shared memory); the line says so where the JAX script prints FAIL;
* E. XLA's int8 ``dot_general``: ``torch._int_mm``, cast to bf16;
* E2. XLA's bf16 dot: ``torch.matmul``;
* F. the int32 product at each card tile the kernel is built for
  (``"chain"``: the int8 chain kernels' own instantiation of the s8 wgmma
  loop, 128 x 128 x 128 at 4 stages). The JAX script's TPU tiles (sized for
  16 MB of VMEM) do not carry over.

A runs at the bf16-operand kernel's 128 x 128 x 64 tile, B and C at the
int8 kernel's ``"chain"`` tile (the line names keep the JAX script's
spelling). E and E2 are the library's products, the yardsticks of the lines
above them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gemm_probe import gemm_probe_bf16, gemm_probe_i8
from ..ops.reference import int8_matmul
from .probe_common import (I32_TILES, bound, k_contiguous, nvidia_smi, row, share, tensor, tile_fits, tile_label,
                           time_ms)

M, K, N = 4608, 3072, 3072
SMEM_BLOCK = 232448  # bytes of shared memory one block may use on the H100
FULL_K = (256, 1024, 3072)  # the JAX script's line D tile


def full_k_reason(k: int) -> str:
    bm, bn, _ = FULL_K
    return (f"not expressible on this card: a {bm} x {k} int8 A tile alone is {bm * k // 1024} KB and the "
            f"{k} x {bn} W tile {k * bn // 1024} KB, where a block holds at most {SMEM_BLOCK // 1024} KB of "
            f"shared memory")


def inputs(m, k, n, device):
    rng = np.random.default_rng(0)
    a8 = tensor(rng.integers(-127, 127, (m, k)), torch.int8, device)
    w8 = tensor(rng.integers(-127, 127, (k, n)), torch.int8, device)
    abf = tensor(rng.normal(size=(m, k)), torch.bfloat16, device)
    wbf = tensor(rng.normal(size=(k, n)), torch.bfloat16, device)
    return a8, k_contiguous(w8), abf, wbf


def run(device="cuda", m=M, k=K, n=N, iters=30, log=print) -> list[dict]:
    """Every line on ``device`` -> one row each (name, ms, tflops, bound_ms,
    of_bound, note); line D's ms is None, its note the reason."""
    a8, w8, abf, wbf = inputs(m, k, n, device)
    fl = 2 * m * k * n
    i8_bytes, bf_bytes = m * k + k * n + 2 * m * n, 2 * m * k + 2 * k * n + 2 * m * n
    lines = [("A. bf16 128/128/64", lambda: gemm_probe_bf16(abf, wbf), bound(bf_bytes, bf16_ops=fl)[0]),
             ("B. int8 f32 acc 128/128/64", lambda: gemm_probe_i8(a8, w8, acc="f32"), bound(i8_bytes, fl)[0]),
             ("C. int8 i32 acc 128/128/64", lambda: gemm_probe_i8(a8, w8, acc="i32"), bound(i8_bytes, fl)[0]),
             ("D. int8 full-K (bk=3072)", None, None),
             ("E. XLA int8 dot_general (torch._int_mm)", lambda: int8_matmul(a8, w8).to(torch.bfloat16),
              bound(i8_bytes, fl)[0]),
             ("E2. XLA bf16 dot (torch.matmul)", lambda: torch.matmul(abf, wbf), bound(bf_bytes, bf16_ops=fl)[0])]
    lines += [(f"F. int8 {tile_label(tile, '/')}", lambda tile=tile: gemm_probe_i8(a8, w8, tile=tile),
               bound(i8_bytes, fl)[0]) for tile in I32_TILES if tile_fits(tile, m, k, n)]
    rows = []
    with torch.no_grad():
        for name, fn, bnd in lines:
            if fn is None:
                r = row(name, None, fl, None, device, note=full_k_reason(k))
                log(f"{name}: {r['note']}")
            else:
                r = row(name, time_ms(fn, iters, device, warmup=1), fl, bnd, device)
                log(f"{name}: {r['tflops']:.0f} TF/s ({r['ms']:.3f} ms{share(r)})")
            rows.append(r)
    return rows


def main(argv=None) -> int:
    """Every line at the JAX script's sizes on the card; like the JAX
    script, it reads no arguments."""
    print(nvidia_smi(), flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
