"""Per-shape tile sweep of the int8 product against the library's, at every
int8 GEMM shape of a FLUX.1-dev 1024px step, with a dispatch line per shape.

Port of ``tools/tune_gemm_impl.py`` (the TPU sweep of XLA's int8 dot
against Pallas tiles): the same 13 shapes (image stream 4096 + text 512
tokens), the same inputs (``numpy.random.default_rng(0)``: per shape CH 4
activations (CH, M, K) then the weight (K, N)), CH calls chained per timed
run, each output's corner consumed into the carry, 5 timed runs after one
untimed. Each line prints the best and every candidate's TF/s, as the JAX
script's dispatch table.

    python -m nunchaku_tpu_torch.tools.tune_gemm_impl

Candidate -> the port:

* ``xla``: XLA's int8 ``dot_general`` -> ``torch._int_mm``, cast to bf16;
* ``pl <bm>/<bn>/<bk>`` (``kern`` :70, int32 accumulator, bf16 out):
  ``gemm_probe_i8`` at each card tile the kernel is built for that divides
  the shape (``pl chain``: the int8 chain kernels' own instantiation of the
  s8 wgmma loop, 128 x 128 x 128 at 4 stages). The JAX script's TPU tiles
  and its VMEM fit (``fits_vmem``) do not carry over.

The weight is held K-contiguous (the kernel's and ``torch._int_mm``'s
layout), built once per shape before timing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gemm_probe import gemm_probe_i8
from ..ops.reference import int8_matmul
from .probe_common import I32_TILES, bound, k_contiguous, nvidia_smi, row, tensor, tile_fits, tile_label, time_ms

CH = 4
# (M, K, N): every int8 GEMM in a FLUX 1024px step (S_img 4096, S_txt 512)
SHAPES = [
    (4608, 3072, 9216),    # dual img qkv
    (4608, 3072, 3072),    # dual img to_out
    (4608, 3072, 12288),   # dual img fc1
    (4608, 12288, 3072),   # dual img fc2
    (512, 3072, 9216),     # dual txt qkv
    (512, 3072, 3072),     # dual txt to_out
    (512, 3072, 12288),    # dual txt fc1
    (512, 12288, 3072),    # dual txt fc2
    (5120, 3072, 9216),    # single qkv
    (5120, 3072, 3072),    # single attn_out
    (5120, 3072, 12288),   # single fc1
    (5120, 12288, 3072),   # single fc2
    (5120, 3072, 21504),   # single qkv+fc1 fused (one input)
]


def chained(fn, srcs):
    c = torch.zeros((1, 1), dtype=torch.float32, device=srcs.device)
    for a in srcs:
        c = c + fn(a)[:1, :1].float()
    return c


def run(device="cuda", shapes=SHAPES, iters=5, ch=CH, log=print) -> list[dict]:
    """Every shape on ``device`` -> one row per (shape, candidate): name
    ``"(M,K,N) <candidate>"``, ms per product, tflops, bound_ms, of_bound;
    ``log`` receives one dispatch line per shape."""
    rng = np.random.default_rng(0)
    rows = []
    with torch.no_grad():
        for (m, k, n) in shapes:
            a8s = tensor(rng.integers(-127, 127, (ch, m, k)), torch.int8, device)
            w8 = k_contiguous(tensor(rng.integers(-127, 127, (k, n)), torch.int8, device))
            fl = 2 * m * k * n
            bnd = bound(m * k + k * n + 2 * m * n, int8_ops=fl)[0]
            cands = [("xla", lambda a, w8=w8: int8_matmul(a, w8).to(torch.bfloat16))]
            cands += [(f"pl {tile_label(tile, '/')}", lambda a, w8=w8, tile=tile: gemm_probe_i8(a, w8, tile=tile))
                      for tile in I32_TILES if tile_fits(tile, m, k, n)]
            shape_rows = []
            for name, fn in cands:
                ms = time_ms(lambda fn=fn: chained(fn, a8s), iters, device, warmup=1) / ch
                shape_rows.append((name, row(f"({m},{k},{n}) {name}", ms, fl, bnd, device)))
            best = max(shape_rows, key=lambda r: r[1]["tflops"])
            log(f"({m},{k},{n}): best={best[0]} {best[1]['tflops']:.0f} TF/s | "
                + ", ".join(f"{name}={r['tflops']:.0f}" for name, r in shape_rows))
            rows += [r for _, r in shape_rows]
            del a8s, w8
    return rows


def main(argv=None) -> int:
    """Every shape on the card, at the JAX script's iteration count; like
    the JAX script, it reads no arguments."""
    print(nvidia_smi(), flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
