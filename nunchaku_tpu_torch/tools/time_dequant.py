"""Times and output digests of the w4a8 weight dequant
(``csrc/dequant_w4a8.cu``) at the shapes its model paths call: PERF.md row 1
at FLUX.1-dev's fc1 (K 3072, N 12288) and fc2 (K 12288, N 3072: ``1:fc2``),
row 1s (the stacked mode, layer 3 of 3 at Z-Image's qkv, K 3840, N 11520),
row 1e (e2m1 codes, nvfp4-a8) at both FLUX shapes (``1e``, ``1e:fc2``) and
stacked at fc1 (``1e:s``). A quick A/B of the kernel without the whole
``chip_smoke.py``: run it in two trees, in turns, and compare.

    python -m nunchaku_tpu_torch.tools.time_dequant [--split] [ROW ...]

One line per row: ``<row> <ms> graph <ms> host <ms> bound <ms> (bytes)
<share>% sha <digest>``. ``ms`` is a call's time back to back (CUDA events
over warm calls); ``graph`` the device's alone, from a CUDA graph of the
same calls replayed, and the share of the bound is of it; ``host`` the
host's time to enqueue one call (the least of five runs). The digest is a
SHA-256 of the int8 codes on inputs drawn from a seed on the card: the codes
are exact, so every build's digest of a row is the same. ``--split`` adds
each device kernel's ms a call (the profiler over five calls; run it apart
from an A/B). A ROW argument selects that row, or every ``ROW:<variant>``
row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import checks
from ..ops.gemm import dequant_w4a8, w4a8_group
from .probe_common import bound, nvidia_smi, time_ms
from .time_attention import graph_ms
from .time_chain import digest, kernel_split
from .time_qkv import host_ms

DIM, HID = 3072, 12288  # FLUX.1-dev: fc1 (DIM -> HID), fc2 (HID -> DIM)
ZI_DIM, ZI_QKV = 3840, 3 * 3840  # Z-Image-Turbo's qkv
ITERS = 50  # timed calls a row
GRAPH_CALLS = 20  # calls a row's CUDA graph holds


def deq_bytes(k, n, g=64):
    """Packed codes and bf16 rescales of g-row groups read once, the int8 weight written once."""
    return k // 2 * n + 2 * (k // g) * n + k * n


def rows():
    """(row, (K, N, codes, stacked))."""
    yield "1", (DIM, HID, "int4", False)
    yield "1:fc2", (HID, DIM, "int4", False)
    yield "1s", (ZI_DIM, ZI_QKV, "int4", True)
    yield "1e", (DIM, HID, "e2m1", False)
    yield "1e:fc2", (HID, DIM, "e2m1", False)
    yield "1e:s", (DIM, HID, "e2m1", True)


def row_bound(k, n, codes):
    return bound(deq_bytes(k, n, w4a8_group(codes)))


def make(k, n, codes, stacked):
    """-> the call: the dequant of the case's weight, or of the last layer of a 3-layer stack holding it."""
    qw, rs = checks.dequant_case(k, n, codes=codes, device="cuda")
    if not stacked:
        return lambda: dequant_w4a8(qw, rs, codes)
    stack, ids = checks.stack_case(qw)
    return lambda: dequant_w4a8(stack, rs, codes, layer_idx=ids[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_dequant: no CUDA device")
        return 1
    print(nvidia_smi())
    for row, (k, n, codes, stacked) in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call = make(k, n, codes, stacked)
        bnd, by = row_bound(k, n, codes)
        sha = digest(call())
        ms = time_ms(call, ITERS)
        host = host_ms(call)
        dev = graph_ms([call] * GRAPH_CALLS)
        print(f"{row} {ms:.4f} graph {dev:.4f} host {host:.4f} bound {bnd:.4f} ({by}) {100 * bnd / dev:.1f}% "
              f"sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
