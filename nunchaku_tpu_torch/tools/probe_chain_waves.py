"""The pipelined chain producer against the ordinary one at whole and
partial waves of blocks, on the card.

    python -m nunchaku_tpu_torch.tools.probe_chain_waves [--m 4224 4608 8448] [--rank 32] [--iters 10]

The pipelined kernel (``svdq_gemm_w8a8_gelu_quant(..., pipelined=True)``)
runs one block a SM over a grid of (N / bn) x (M / 128) equal blocks; at
FLUX.1-dev's fc1 (K 3072, N 12288, bn 1536) that is 8 blocks per 128 rows:
M 4224 gives 264 blocks (two whole waves of 132 SMs), M 4608 (the 1024px
joint sequence) 288 (2.18 waves), M 8448 528 (four). Each line gives both
kernels' times (CUDA events over warm launches) on the same seeded inputs,
with the card's name and power limit first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from ..ops import checks
from ..ops.gemm import chain_tile_n, svdq_gemm_w8a8_gelu_quant

K, N = 3072, 12288  # FLUX.1-dev fc1


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[4224, 4608, 8448])
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_chain_waves: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in args.m:
        case = checks.gelu_quant_case(m, K, N, args.rank, device="cuda")
        blocks = N // chain_tile_n(N) * (m // 128)
        pipe = cuda_ms(lambda: svdq_gemm_w8a8_gelu_quant(*case, pipelined=True), args.iters)
        plain = cuda_ms(lambda: svdq_gemm_w8a8_gelu_quant(*case), args.iters)
        print(f"M={m} K={K} N={N} R={args.rank}: {blocks} blocks ({blocks / sms:.2f} waves of {sms}), pipelined "
              f"{pipe:.4f} ms, ordinary {plain:.4f} ms, ratio {pipe / plain:.3f}", flush=True)
        del case
    return 0


if __name__ == "__main__":
    sys.exit(main())
