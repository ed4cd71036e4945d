"""Times and output digests of the packed-int4 w4a8 kernels at FLUX.1-dev's
and Z-Image-Turbo's shapes: the packed GEMM (``csrc/gemm_w4a8.cu``, PERF.md
rows 10, 11, 11s rank-1 and 11g, 11gs grouped) and the W4 form of the
GELU -> requantize producer (``csrc/gemm_w8a8_gelu_quant.cu``, rows 12,
12s), at ranks 32, 128 and 256 and at the text stream's M 512, each beside
``torch._int_mm`` of its product on the dequantized weight, the dequant
route at the same shape (``dequant_w4a8`` then the int8 kernel with the
same epilogue; for the rank-1 rows also then ``gemm_w8a8``, the model's
standalone int8 linear: ``_int_mm`` and a torch epilogue) and its bound. A
quick A/B of the two kernels without the whole ``chip_smoke.py``: run it in
two trees, in turns, and compare the digests.

    python -m nunchaku_tpu_torch.tools.time_packed [--split] [ROW ...]

One line per row: ``<row> <ms> int_mm <ms> deq+int8 <ms> [deq+int_mm <ms>]
bound <ms> (<by>) <share>% sha <digest>``; the digest is a SHA-256 of the
outputs' bytes (the GEMM's bf16 output; the producer's qout, qscales and
lora_next) on inputs drawn from a seed on the card, so two builds whose
digests agree give the same outputs bit for bit. A row the kernel refuses
(a rank an earlier build does not take) prints ``refused``. ``--split``
adds each device kernel's ms a call (the profiler over five calls). A ROW
argument selects that row, or every ``ROW:<variant>`` row. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import checks
from ..ops.gemm import (dequant_w4a8, gemm_w4a8, gemm_w4a8_grouped, gemm_w8a8, gemm_w8a8_grouped, gemm_w8a8_rank1,
                        svdq_gemm_w4a8_gelu_quant, svdq_gemm_w8a8_gelu_quant)
from ..ops.reference import int8_matmul
from .probe_common import bound, nvidia_smi, time_ms
from .time_chain import digest, kernel_split

DIM, HID, S_IMG, S_TXT = 3072, 12288, 4096, 512  # FLUX.1-dev: qkv (DIM -> 3 DIM), fc1 (DIM -> HID), fc2 (HID -> DIM)
ZI_DIM = 3840  # Z-Image-Turbo: the stacked qkv (DIM -> 3 DIM)
GROUPS = HID // 1536  # the producer's scale groups: the consumer's K groups
ITERS = 20  # timed calls a row


def packed_bound(m, k, n, r, groups):
    """qact, ascales (G, M), the packed codes (K/2 x N), rescales (K/64, N), wscales, lora_act, proj_up, bias
    read once; the bf16 output written once; 2 M N K int8 ops, 2 M N R bf16."""
    nbytes = m * k + 4 * groups * m + k * n // 2 + 2 * (k // 64) * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n
    return bound(nbytes + 2 * m * n, 2 * m * n * k, 2 * m * n * r)


def packed_producer_bound(m, k, n, r, groups):
    """qact, ascales, the packed codes and rescales, wscales, lora_act, proj_up, bias, rsmooth, proj_down read
    once; qout, qscales, lora_next written once; 2 M N K int8 ops, 4 M N R bf16 (both low-rank products)."""
    nbytes = m * k + 4 * m + k * n // 2 + 2 * (k // 64) * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n + 4 * n
    nbytes += 2 * n * r + m * n + 4 * groups * m + 4 * m * r
    return bound(nbytes, 2 * m * n * k, 4 * m * n * r)


def rows():
    """(row, make) with make() -> (call, int8_mm, deq_int8, deq_int_mm or None, bound)."""
    def gemm(m, k, n, r, groups=1, stacked=False):
        def make():
            case = checks.w4a8_case(m, k, n, r, device="cuda") if groups == 1 else checks.w4a8_grouped_case(
                m, k, n, groups, r, device="cuda")
            qa, asc, qw, rs, ws, la, pu, bias = case
            w_run, kw = qw, {}
            if stacked:
                w_run, ids = checks.stack_case(qw)
                kw["layer_idx"] = ids[-1]
            fn = gemm_w4a8 if groups == 1 else gemm_w4a8_grouped
            w8 = dequant_w4a8(qw, rs)
            int8_kernel = gemm_w8a8_rank1 if groups == 1 else gemm_w8a8_grouped
            deq = (lambda: int8_kernel(qa, asc, dequant_w4a8(w_run, rs, layer_idx=kw.get("layer_idx")), ws, la, pu,
                                       bias))
            deq_mm = None
            if groups == 1:
                deq_mm = lambda: gemm_w8a8(qa, asc, dequant_w4a8(w_run, rs, layer_idx=kw.get("layer_idx")), ws, la,
                                           pu, bias)
            return (lambda: fn(qa, asc, w_run, rs, ws, la, pu, bias, **kw), lambda: int8_matmul(qa, w8), deq, deq_mm,
                    packed_bound(m, k, n, r, groups))
        return make

    def producer(m, r, stacked=False):
        def make():
            qa, asc, qw, rs, *rest = checks.w4a8_gelu_quant_case(m, DIM, HID, r, device="cuda")
            w_run, kw = qw, {}
            if stacked:
                w_run, ids = checks.stack_case(qw)
                kw["layer_idx"] = ids[-1]
            w8 = dequant_w4a8(qw, rs)
            deq = lambda: svdq_gemm_w8a8_gelu_quant(qa, asc, dequant_w4a8(w_run, rs, layer_idx=kw.get("layer_idx")),
                                                    *rest)
            return (lambda: svdq_gemm_w4a8_gelu_quant(qa, asc, w_run, rs, *rest, **kw), lambda: int8_matmul(qa, w8),
                    deq, None, packed_producer_bound(m, DIM, HID, r, GROUPS))
        return make

    m = S_IMG + S_TXT
    for tag, r in (("", 32), (":r128", 128), (":r256", 256)):
        yield "11" + tag, gemm(m, DIM, 3 * DIM, r)
    yield "11:m512", gemm(S_TXT, DIM, 3 * DIM, 32)
    for tag, r in (("", 32), (":r128", 128), (":r256", 256)):
        yield "11s" + tag, gemm(m, ZI_DIM, 3 * ZI_DIM, r, stacked=True)
    for tag, r in (("", 32), (":r128", 128), (":r256", 256)):
        yield "11g" + tag, gemm(m, HID, DIM, r, groups=GROUPS)
    yield "11g:m512", gemm(S_TXT, HID, DIM, 32, groups=GROUPS)
    yield "11gs", gemm(m, HID, DIM, 32, groups=GROUPS, stacked=True)
    for tag, r in (("", 32), (":r128", 128), (":r256", 256)):
        yield "12" + tag, producer(m, r)
    yield "12:m512", producer(S_TXT, 32)
    yield "12s", producer(m, 32, stacked=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_packed: no CUDA device")
        return 1
    print(nvidia_smi())
    for row, make in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call, mm, deq, deq_mm, (bnd, by) = make()
        try:
            sha = digest(call())
            ms = time_ms(call, ITERS)
            lib = time_ms(mm, ITERS)
            yard = time_ms(deq, ITERS)
            extra = "" if deq_mm is None else f" deq+int_mm {time_ms(deq_mm, ITERS):.4f}"
        except (ValueError, RuntimeError) as e:
            print(f"{row} refused ({str(e).splitlines()[0][:80]})", flush=True)
            continue
        print(f"{row} {ms:.4f} int_mm {lib:.4f} deq+int8 {yard:.4f}{extra} bound {bnd:.4f} ({by}) "
              f"{100 * bnd / ms:.1f}% sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call, mm, deq, deq_mm
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
