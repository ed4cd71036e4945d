"""Times and output digests of the LN + modulate + quantize producer
(``csrc/ln_mod_quant.cu``) at FLUX.1-dev's shapes: the single mode (PERF.md
row 6) at the joint sequence (M 4608), the image stream (M 4096) and the
text stream (M 512), K 3072, R 32, and at M 4608 with R 128 and 256; the
dual mode (row 15) at M 4608 with heads of R 32 + 32 and 128 + 128. Beside
each row, ``F.layer_norm`` of the same stream as a yardstick for the
LayerNorm alone (not the same function: no modulation, quantization or
low-rank product), and the row's bound. A quick A/B of the kernel without
the whole ``chip_smoke.py``: run it in two trees, in turns, and compare.

    python -m nunchaku_tpu_torch.tools.time_ln [--split] [ROW ...]

One line per row: ``<row> <ms> graph <ms> host <ms> layer_norm <ms> bound
<ms> (<by>) <share>% sha <digest>``. ``ms`` is a call's time back to back
(CUDA events over warm calls); ``graph`` the device's alone, from a CUDA
graph of the same calls replayed (no host work between the kernels), and the
share of the bound is of it; ``host`` the host's time to enqueue one call: a
row whose ms is no more than that is bound by the host. The digest is a
SHA-256 of the outputs' bytes (q, ascales, lora_act; both heads' in the dual
mode) on inputs drawn from a seed on the card, so two builds whose digests
agree give the same outputs bit for bit. ``--split`` adds each device
kernel's ms a call (the profiler over five calls; run it apart from an A/B,
as the profiler slows the host's later launches). A ROW argument selects
that row, or every ``ROW:<variant>`` row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import checks
from ..ops.quantize import ln_mod_quant_int8, ln_mod_quant_int8_dual
from .probe_common import bound, nvidia_smi, time_ms
from .time_attention import graph_ms
from .time_chain import digest, kernel_split

DIM, S_IMG, S_TXT = 3072, 4096, 512  # FLUX.1-dev: the hidden width, the image and text streams at 1024px
ITERS = 50  # timed calls a row
GRAPH_CALLS = 20  # calls a row's CUDA graph holds


def single_bytes(m, k, r):
    """x bf16, the modulation's scale and shift f32, smooth, proj_down read once; q int8, ascales, lora_act
    written once."""
    return 2 * m * k + 8 * k + 2 * k + 2 * k * r + m * k + 4 * m + 4 * m * r


def dual_bytes(m, k, r1, r2):
    """x read once, the modulation, two smooths and proj_downs; two (q, ascales, lora_act) written."""
    return 2 * m * k + 8 * k + 4 * k + 2 * k * (r1 + r2) + 2 * (m * k + 4 * m) + 4 * m * (r1 + r2)


def rows():
    """(row, make) with make() -> (call, x, bound)."""
    def single(m, r):
        def make():
            args = checks.ln_mod_quant_case(1, m, DIM, r, device="cuda")
            return (lambda: ln_mod_quant_int8(*args), args[0],
                    bound(single_bytes(m, DIM, r), bf16_ops=2 * m * DIM * r))
        return make

    def dual(m, r):
        def make():
            args = checks.ln_dual_case(1, m, DIM, r, r, device="cuda")
            return (lambda: sum(ln_mod_quant_int8_dual(*args), ()), args[0],
                    bound(dual_bytes(m, DIM, r, r), bf16_ops=2 * m * DIM * 2 * r))
        return make

    m = S_IMG + S_TXT
    yield "6", single(m, 32)
    yield "6:m4096", single(S_IMG, 32)
    yield "6:m512", single(S_TXT, 32)
    yield "6:r128", single(m, 128)
    yield "6:r256", single(m, 256)
    yield "15", dual(m, 32)
    yield "15:r128", dual(m, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_ln: no CUDA device")
        return 1
    print(nvidia_smi())
    for row, make in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call, x, (bnd, by) = make()
        sha = digest(call())
        ms = time_ms(call, ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            call()
        host = (time.perf_counter() - t0) * 1e3 / ITERS
        torch.cuda.synchronize()
        dev = graph_ms([call] * GRAPH_CALLS)
        ln = time_ms(lambda: torch.nn.functional.layer_norm(x, (DIM,), eps=1e-6), ITERS)
        print(f"{row} {ms:.4f} graph {dev:.4f} host {host:.4f} layer_norm {ln:.4f} bound {bnd:.4f} ({by}) "
              f"{100 * bnd / dev:.1f}% sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
