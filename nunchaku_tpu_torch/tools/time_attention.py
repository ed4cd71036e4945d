"""Times of the attention core's forms, of the two producers and of the bf16
GEMM probe's six operand forms (the GEMM main loop) at their main-path
shapes, each checked against its plain twin first: a quick A/B of
``csrc/flash_sm90.cuh`` and ``csrc/gemm_sm90.cuh`` (run it in two trees, in
turns) without the whole ``chip_smoke.py``.

    python -m nunchaku_tpu_torch.tools.time_attention [ROW ...]

One line per row of PERF.md section 6: ``<row> <ms> <check>``, the time a
call (CUDA events) and the check's verdict and detail; a shape the tree's
kernels refuse prints the refusal. A ROW argument selects that row, or every
``ROW:<form>`` row (``22a`` selects the six probe forms). Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import attention as A
from ..ops import checks, gemm_probe
from .probe_common import nvidia_smi, time_ms


def rows():
    """(row, case, check, timed call, iterations) of each timed form."""
    def fixed(b, h, sq, skv):
        return checks.flash_case(b, h, sq, skv, device="cuda")

    def online(b, h, sq, skv, d):
        return checks.flash_online_case(b, h, sq, skv, d, device="cuda")

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
    for row, case, check, call, iters in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        operands = case()
        try:
            _, ok, detail = check(*operands)
            print(f"{row} {time_ms(lambda: call(*operands), iters):.4f} {'PASS' if ok else 'FAIL'} {detail}",
                  flush=True)
        except ValueError as e:  # a shape this tree's kernels refuse
            print(f"{row} refused: {e}", flush=True)
        del operands
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
