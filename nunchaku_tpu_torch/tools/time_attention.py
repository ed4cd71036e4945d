"""Times of the attention core's forms, of the wide online kernel (head dims
256 / 512), of the two producers, of the AWQ GEMV and of the bf16 GEMM
probe's six operand forms (the GEMM main loop) at their main-path shapes,
each checked against its plain twin first: a quick A/B of
``csrc/flash_sm90.cuh``, ``csrc/flash_online.cu``, ``csrc/gemv_awq.cu`` and
``csrc/gemm_sm90.cuh`` (run it in two trees, in turns) without the whole
``chip_smoke.py``.

    python -m nunchaku_tpu_torch.tools.time_attention [ROW ...]

One line per row of PERF.md section 6: ``<row> <ms> <check>``, the time a
call (CUDA events) and the check's verdict and detail; a shape the tree's
kernels refuse prints the refusal. Rows 5, 5w, 5h (the VAE's attention) and
9 (the GEMV) add their bound, share of bound and one-call library yardstick
(SDPA; ``torch.matmul`` on the dequantized weight); row 9 also the device
time a call from a CUDA graph of 100 calls replayed, the calls cycling over
four weights (127 MB: each read from device memory, not L2). A ROW argument
selects that row, or every ``ROW:<form>`` row (``22a`` selects the six probe
forms, ``9`` the three GEMV shapes). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops import attention as A
from ..ops import checks, gemm_probe
from ..ops.gemv import awq_dequant, awq_w4a16_linear
from .probe_common import bound, nvidia_smi, time_ms

GEMV_WEIGHTS = 4  # weights a GEMV row cycles over (4 x 31.8 MB at N 18432: more than the 50 MB L2)


def graph_ms(calls, reps: int = 10) -> float:
    """Device ms a call: the callables of ``calls`` captured once into a CUDA
    graph, replayed ``reps`` times (no host work between the kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def gemv_bound(m, k, n):
    """The AWQ GEMV's bound: x, packed weight, scales, zeros and bias read
    once, the f32 output written once; 2 M K N FLOP."""
    return bound(2 * m * k + k // 2 * n + 4 * (k // 64) * n + 2 * n + 4 * m * n, bf16_ops=2 * m * k * n)


def wide_yardstick(q, k, v):
    """Row 5's extras: (bound ms, text of the bound (q, k, v, out read /
    written once; 4 Sq Skv D FLOP a head) and SDPA's time on the same
    inputs)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1 / math.sqrt(d)), 10)
    bnd, by = bound(2 * b * h * (2 * sq + 2 * skv) * d, bf16_ops=4 * b * h * sq * skv * d)
    return bnd, f"bound {bnd:.4f} ms by {by}; SDPA {sdpa:.4f} ms"


def gemv_yardstick(x, qw, ws, wz, bias):
    """Row 9's extras: (bound ms, text of the bound, torch.matmul on the
    dequantized bf16 weight, and the kernel's device time a call from a graph
    of 100 calls over GEMV_WEIGHTS weights)."""
    m, k = x.shape
    n = qw.shape[1]
    w16 = awq_dequant(qw, ws, wz)
    lib = time_ms(lambda: torch.matmul(x, w16), 50)
    del w16
    weights = [(qw, ws, wz, bias)] + [checks.awq_case(m, k, n, seed=s, device="cuda")[1:] for s in
                                      range(1, GEMV_WEIGHTS)]
    dev = graph_ms([lambda w=weights[i % GEMV_WEIGHTS]: awq_w4a16_linear(x, *w) for i in range(100)])
    bnd, by = gemv_bound(m, k, n)
    return bnd, (f"bound {bnd:.4f} ms by {by} ({100 * bnd / dev:.1f}% of it on the device time); "
                 f"matmul {lib:.4f} ms; device {dev:.4f} ms a call (graph)")


def rows():
    """(row, case, check, timed call, iterations[, extras]) of each timed
    form; extras(*case) -> (bound ms, a string of bound and yardsticks)."""
    def fixed(b, h, sq, skv):
        return checks.flash_case(b, h, sq, skv, device="cuda")

    def online(b, h, sq, skv, d):
        return checks.flash_online_case(b, h, sq, skv, d, device="cuda")

    for row, s, d, iters in (("5", 4096, 512, 50), ("5w", 16384, 512, 5), ("5h", 4096, 256, 50)):
        yield (row, lambda s=s, d=d: online(1, 1, s, s, d), checks.check_flash_online,
               lambda q, k, v: A.flash_attention_online(q, k, v), iters, wide_yardstick)
    for row, m, n in (("9:n18432", 1, 18432), ("9:n9216", 1, 9216), ("9:m2", 2, 18432)):
        yield (row, lambda m=m, n=n: checks.awq_case(m, 3072, n, device="cuda"), checks.check_awq,
               awq_w4a16_linear, 200, gemv_yardstick)
    yield ("4", lambda: fixed(1, 24, 4608, 4608), checks.check_flash, lambda q, k, v: A.flash_attention(q, k, v), 20)
    yield ("19u", lambda: fixed(1, 24, 4608, 4608), checks.check_flash_unroll2,
           lambda q, k, v: A.flash_attention_unroll2(q, k, v, scale=1.0, out_bshd=True), 20)
    yield ("20", lambda: checks.flash_i8_case(1, 24, 4608, 4608, device="cuda"), checks.check_flash_i8,
           lambda *i8: A.flash_attention_i8(*i8, out_bshd=True), 20)
    yield ("21", lambda: checks.flash_bshd_case(1, 24, 4608, 4608, device="cuda"), checks.check_flash_bshd,
           lambda q, k, v: A.flash_attention_bshd(q, k, v), 20)
    yield ("5d", lambda: online(1, 10, 4096, 4096, 64), checks.check_flash_online,
           lambda q, k, v: A.flash_attention_online(q, k, v, out_bshd=True), 50)
    yield ("5s", lambda: online(2, 20, 1024, 300, 112), checks.check_flash_online,
           lambda q, k, v: A.flash_attention_online(q, k, v, out_bshd=True), 50)
    for row, on in (("4m", False), ("5m", True)):
        yield (row, lambda: checks.flash_masked_case(2, 24, 211, 4096, (211, 97), device="cuda"),
               lambda q, k, v, m, on=on: checks.check_flash_masked(q, k, v, m, on),
               lambda q, k, v, m, on=on: checks.run_flash_masked(q, k, v, m, on), 20)
    yield ("19", lambda: fixed(1, 24, 16896, 16896), checks.check_flash_denom,
           lambda q, k, v: A.flash_attention_denom(q, k, v, scale=1.0), 5)
    for row, fx in (("16", True), ("17", False)):
        yield (row, lambda: checks.block_sparse_case(1, 24, 16896, 0.5, device="cuda"),
               lambda q, k, v, i, bq, bkv, fx=fx: checks.check_block_sparse(q, k, v, i, bq, bkv, fx),
               lambda q, k, v, i, bq, bkv, fx=fx: checks.run_block_sparse(q, k, v, i, bq, bkv, fx), 10)
    for r in (32, 128):
        yield (f"7 R{r}", lambda r=r: checks.qkv_rope_case(1, (4608,), 24, 128, r, device="cuda"),
               checks.check_qkv_rope,
               lambda st, cos, sin: checks.run_qkv_rope(A.qkv_rope_producer, st, cos, sin), 50)
    for a_form, w_form, scaled in gemm_probe.BF16_FORMS:  # bench_gemm_variants' shape
        kw = dict(a_form=a_form, w_form=w_form)
        yield (f"22a:{a_form}_{w_form}{'_scaled' if scaled else ''}",
               lambda f=(a_form, w_form, scaled): checks.probe_bf16_case(4608, 3072, 12288, *f, device="cuda"),
               lambda *ops, kw=kw: checks.check_probe_bf16(*ops, **kw),
               lambda *ops, kw=kw: gemm_probe.gemm_probe_bf16(*ops, **kw), 20)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi())
    for row, case, check, call, iters, *extras in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        operands = case()
        try:
            _, ok, detail = check(*operands)
            ms = time_ms(lambda: call(*operands), iters)
            more = ""
            if extras:
                bnd, text = extras[0](*operands)
                more = f"; {text}; {100 * bnd / ms:.1f}% of bound"
            print(f"{row} {ms:.4f} {'PASS' if ok else 'FAIL'} {detail}{more}", flush=True)
        except ValueError as e:  # a shape this tree's kernels refuse
            print(f"{row} refused: {e}", flush=True)
        del operands
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
