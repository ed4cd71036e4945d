"""Times and output digests of the int8 MLP chain pair at FLUX.1-dev's
shapes: the GELU -> requantize producer (``csrc/gemm_w8a8_gelu_quant.cu``,
PERF.md rows 2, 2s, 13) at fc1 (K 3072, N 12288) and the grouped consumer
(``csrc/gemm_w8a8_grouped.cu``, rows 3, 3s, 3', 3's, 3p) at fc2 (K 12288 in
8 groups, N 3072), at the joint sequence (M 4608) and the text stream (M
512), ranks 32, 128 and 256, each beside ``torch._int_mm`` of its product and
its bound; and the pipelined producer
(``csrc/gemm_w8a8_gelu_quant_pipe.cu``, row 14: ``pipelined=True``) at row
2's shapes and ranks (``14``, ``14:r128``, ``14:r256``), whose digests equal
row 2's when the two give the same outputs bit for bit. A quick A/B of the two kernels without the whole
``chip_smoke.py``: run it in two trees, in turns, and compare the digests.

    python -m nunchaku_tpu_torch.tools.time_chain [ROW ...]

One line per row: ``<row> <ms> int_mm <ms> bound <ms> (<by>) <share>% sha
<digest>``; the digest is a SHA-256 of the outputs' bytes (the producer's
qout, qscales and lora_next; the consumer's bf16 output) on inputs drawn
from a seed on the card, so two builds whose digests agree give the same
outputs bit for bit. ``--split`` adds each device kernel's ms a call (the
profiler over five calls), e.g. the producer's GEMM kernel and its
requantize kernel. A ROW argument selects that row, or every
``ROW:<variant>`` row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib

import torch

from ..ops import checks
from ..ops.gemm import gemm_w8a8_grouped, gemm_w8a8_rank1, svdq_gemm_w8a8_gelu_quant
from ..ops.reference import int8_matmul
from .probe_common import bound, nvidia_smi, time_ms

DIM, HID, S_IMG, S_TXT = 3072, 12288, 4096, 512  # FLUX.1-dev: fc1 (DIM -> HID), fc2 (HID -> DIM)
GROUPS = HID // 1536  # the producer's scale groups: the consumer's K groups
ITERS = 20  # timed calls a row
PIPE_RANKS = {"14": 32, "14:r128": 128, "14:r256": 256}  # the pipelined producer's rows, at row 2's shapes


def digest(out) -> str:
    h = hashlib.sha256()
    for t in out if isinstance(out, tuple) else (out,):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def producer_bound(m, k, n, r, groups):
    """qact, ascales, weight, wscales, lora_act, proj_up, bias, rsmooth, proj_down read once; qout, qscales,
    lora_next written once; 2 M N K int8 ops, 4 M N R bf16 (both low-rank products)."""
    nbytes = m * k + 4 * m + k * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n + 4 * n + 2 * n * r
    nbytes += m * n + 4 * groups * m + 4 * m * r
    return bound(nbytes, 2 * m * n * k, 4 * m * n * r)


def consumer_bound(m, k, n, r, groups, res):
    """qact, ascales (G, M), weight, wscales, lora_act, proj_up, bias (and x, gate, extra, extra_la, extra_pu)
    read once; the bf16 output written once; 2 M N K int8 ops, 2 M N R bf16 (4 with the extra's)."""
    nbytes = m * k + 4 * groups * m + k * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n + 2 * m * n
    if res:
        nbytes += 2 * m * n + 4 * n + 2 * m * n + 4 * m * r + 2 * r * n
    return bound(nbytes, 2 * m * n * k, (4 if res else 2) * m * n * r)


def kernel_split(call, calls: int = 5) -> str:
    """Device ms a call of each kernel ``call`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    parts = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            name = evt.key.replace("void ", "").replace("(anonymous namespace)::", "")
            parts.append(f"{name[:48]} {us / 1e3 / calls:.4f}")
    return "; ".join(parts) or "no device time in the trace"


def rows():
    """(row, make) with make() -> (call, the product's operands (qact, weight), bound)."""
    def producer(m, r, stacked=False, ptoken=False, pipelined=None):
        def make():
            qa, asc, w, *rest = checks.gelu_quant_case(m, DIM, HID, r, device="cuda")
            kw = dict(ptoken=ptoken, pipelined=pipelined)
            if stacked:
                stack, ids = checks.stack_case(w)
                kw["layer_idx"] = ids[-1]
                w_run = stack
            else:
                w_run = w
            return (lambda: svdq_gemm_w8a8_gelu_quant(qa, asc, w_run, *rest, **kw), (qa, w),
                    producer_bound(m, DIM, HID, r, 1 if ptoken else GROUPS))
        return make

    def consumer(m, r, res=False, stacked=False, rank1=False):
        def make():
            groups = 1 if rank1 else GROUPS
            case = checks.grouped_res_case if res else checks.grouped_case
            qa, asc, w, ws, la, pu, bias, *residual = case(m, HID, DIM, groups, r, device="cuda")
            residual = residual[0] if residual else None
            kw = {}
            w_run = w
            if stacked:
                w_run, ids = checks.stack_case(w)
                kw["layer_idx"] = ids[-1]
            fn = gemm_w8a8_rank1 if rank1 else gemm_w8a8_grouped
            return (lambda: fn(qa, asc, w_run, ws, la, pu, bias, residual, **kw), (qa, w),
                    consumer_bound(m, HID, DIM, r, groups, res))
        return make

    m = S_IMG + S_TXT
    yield "2", producer(m, 32)
    yield "2:r128", producer(m, 128)
    yield "2:r256", producer(m, 256)
    yield "2:m512", producer(S_TXT, 32)
    yield "2s", producer(m, 32, stacked=True)
    yield "13", producer(m, 32, stacked=True, ptoken=True)
    yield "3", consumer(m, 32)
    yield "3:r128", consumer(m, 128)
    yield "3:m512", consumer(S_TXT, 32)
    yield "3s", consumer(m, 32, stacked=True)
    yield "3'", consumer(m, 32, res=True)
    yield "3':r128", consumer(m, 128, res=True)
    yield "3':m512", consumer(S_TXT, 32, res=True)
    yield "3's", consumer(m, 32, res=True, stacked=True)
    yield "3p", consumer(m, 32, stacked=True, rank1=True)
    yield "3p:res", consumer(m, 32, res=True, stacked=True, rank1=True)
    for row, r in PIPE_RANKS.items():
        yield row, producer(m, r, pipelined=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_chain: no CUDA device")
        return 1
    print(nvidia_smi())
    for row, make in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call, (qa, w), (bnd, by) = make()
        sha = digest(call())
        ms = time_ms(call, ITERS)
        lib = time_ms(lambda: int8_matmul(qa, w), ITERS)
        print(f"{row} {ms:.4f} int_mm {lib:.4f} bound {bnd:.4f} ({by}) {100 * bnd / ms:.1f}% sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call, qa, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
