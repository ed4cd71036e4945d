"""Times and output digests of the int8 GEMM probe (``csrc/gemm_probe_i8.cu``)
at every built (accumulator, epilogue, tile), beside ``torch._int_mm``, at
the three probe shapes: PERF.md row 22a's (bench_gemm_variants: M 4608, K
3072, N 12288), 22d's (probe_m512: M 512, K 3072, N 9216) and a K 12288
shape of tune_gemm_impl (M 5120, K 12288, N 3072). A quick A/B of the kernel
without the whole ``chip_smoke.py``: run it in two trees, in turns, and
compare.

    python -m nunchaku_tpu_torch.tools.time_probe_i8 [SHAPE ...]

One line per row: ``<shape> <mode>@<tile> <ms> graph <ms> bound <ms> <share>%
int_mm <ratio>x sha <digest>``. ``ms`` is a call's time back to back (CUDA
events over warm calls); ``graph`` the device's alone, from a CUDA graph of
the same calls replayed; the share of the bound and the ratio to
``torch._int_mm`` (its graph time, on the same operands, int32 out) are of
the graph time. The digest is a SHA-256 of the bf16 output on inputs drawn
from a seed on the card: every int32 row's digest is the same (exact sums),
an f32 row's only between builds that sum the same K tiles. A SHAPE argument
(``22a``, ``22d``, ``k12288``) selects that shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools

import torch

from ..ops import checks
from ..ops.gemm_probe import I8_BUILT, gemm_probe_i8, i8_mode
from ..ops.reference import int8_matmul
from .probe_common import bound, nvidia_smi, tile_fits, time_ms
from .time_attention import graph_ms
from .time_chain import digest

SHAPES = {"22a": (4608, 3072, 12288), "22d": (512, 3072, 9216), "k12288": (5120, 12288, 3072)}
ITERS = 20  # timed calls a row, back to back
GRAPH_CALLS = 10  # calls a row's CUDA graph holds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", help=f"shapes to run (default: all of {tuple(SHAPES)})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_probe_i8: no CUDA device")
        return 1
    print(nvidia_smi(), flush=True)
    for name, (m, k, n) in SHAPES.items():
        if args.shapes and name not in args.shapes:
            continue
        a, w, sa, sw = checks.probe_i8_case(m, k, n, device="cuda")
        lib = graph_ms([lambda: int8_matmul(a, w)] * GRAPH_CALLS)
        print(f"{name} M={m} K={k} N={n}: torch._int_mm {time_ms(lambda: int8_matmul(a, w), ITERS):.4f} graph "
              f"{lib:.4f}; with the cast to bf16 graph "
              f"{graph_ms([lambda: int8_matmul(a, w).to(torch.bfloat16)] * GRAPH_CALLS):.4f}", flush=True)
        for (acc, rank1), tiles in I8_BUILT.items():
            sc = (sa, sw) if rank1 else ()
            bnd = bound(m * k + k * n + 2 * m * n + (4 * (m + n) if rank1 else 0), int8_ops=2 * m * n * k)[0]
            for tile in tiles:
                if not tile_fits(tile, m, k, n):
                    continue
                call = functools.partial(gemm_probe_i8, a, w, *sc, acc=acc, tile=tile)
                sha = digest(call())
                ms = time_ms(call, ITERS)
                dev = graph_ms([call] * GRAPH_CALLS)
                print(f"{name} {i8_mode(acc, rank1)}@{tile} {ms:.4f} graph {dev:.4f} bound {bnd:.4f} "
                      f"{100 * bnd / dev:.1f}% int_mm {dev / lib:.3f}x sha {sha}", flush=True)
        del a, w, sa, sw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
