"""The pipelined chain producer against the ordinary one at token counts
that give its persistent blocks equal and unequal tile shares, on the card.

    python -m nunchaku_tpu_torch.tools.probe_chain_waves [--m 4224 4608 8448] [--rank 32] [--iters 10]

The pipelined kernel (``svdq_gemm_w8a8_gelu_quant(..., pipelined=True)``,
``csrc/gemm_w8a8_gelu_quant_pipe.cu``) runs persistent blocks, one an SM,
each over an equal contiguous share of the (M / 128) x (N / 128) output
tiles; at FLUX.1-dev's fc1 (K 3072, N 12288) that is 96 tiles per 128 rows:
M 4224 gives 3168 tiles (24 a block on 132 SMs), M 4608 (the 1024px joint
sequence) 3456 (26-27 a block), M 8448 6336 (48). The ordinary producer
runs one block a 128-row x bn-column scale group. Each line gives the tile
count, the tiles a block takes and both kernels' times (CUDA events over
warm launches) on the same seeded inputs, with the card's name and power
limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..ops import checks
from ..ops.gemm import svdq_gemm_w8a8_gelu_quant
from .probe_common import nvidia_smi, time_ms

K, N = 3072, 12288  # FLUX.1-dev fc1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4224, 4608, 8448])
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_chain_waves: no CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in args.m:
        case = checks.gelu_quant_case(m, K, N, args.rank, device="cuda")
        tiles = (m // 128) * (N // 128)  # the pipelined kernel's 128 x 128 output tiles
        blocks = min(tiles, sms)
        pipe = time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*case, pipelined=True), args.iters, warmup=1)
        plain = time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*case), args.iters, warmup=1)
        print(f"M={m} K={K} N={N} R={args.rank}: {tiles} tiles over {blocks} persistent blocks, "
              f"{tiles // blocks}-{-(-tiles // blocks)} a block; pipelined {pipe:.4f} ms, ordinary {plain:.4f} ms, "
              f"ratio {pipe / plain:.3f}", flush=True)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
