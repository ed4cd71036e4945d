"""Times and output digests of the W4A4 GEMM (``csrc/gemm_w4a4.cu``,
PERF.md rows 8, 8s, 8u, 8n, 8sn) at the shapes PERF.md's table times them,
at the text stream's M 512 and at ranks 128 and 256, each beside three
yardsticks: two on the same operands decoded to bf16 (``torch.matmul``, and
the bf16 GEMM probe's ``k_bf`` form: the repo's own wgmma loop on operands
that are already decoded), and the other design whole (``dec+k_bf``: both
operands decoded to bf16 in global memory by ``nt_w4a4_decode``, the
rank-r term and the bias appended along K, then ``k_bf``); its bound and
its largest error against the plain twin. A quick A/B of the kernel
without the whole ``chip_smoke.py``: run it in two trees, in turns, and
compare the digests.

    python -m nunchaku_tpu_torch.tools.time_w4a4 [--split] [ROW ...]

One line per row: ``<row> <ms> matmul <ms> k_bf <ms> dec+k_bf <ms> (dec
<ms>, err <max abs>) bound <ms> (<by>) <share>% err <max abs> sha
<digest>``; the digest is a SHA-256 of the output's bytes on inputs drawn
from a seed on the card, so two builds whose digests agree give the same
outputs bit for bit. ``--split`` adds each device kernel's ms a call (the
profiler over five calls). A ROW argument selects that row, or every
``ROW:<variant>`` row. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _build, checks
from ..ops.gemm import W4A4_MODES, _ptr, _stream, gemm_w4a4, gemm_w4a4_plain, group_size, w4a4_values
from ..ops.gemm_probe import gemm_probe_bf16
from .probe_common import bound, nvidia_smi, time_ms
from .time_chain import digest, kernel_split

DIM, HID, S_IMG, S_TXT, RANK = 3072, 12288, 4096, 512, 32  # FLUX.1-dev; its joint stream is 4608 rows
ZI_DIM = 3840  # Z-Image's stacked qkv (K 3840, N 11520): rows 8s, 8sn
ITERS = 20  # timed calls a row


def w4a4_bytes(m, k, n, g, r=RANK):
    # qact, ascales, weight, wscales (packed 4-bit, bf16 group scales), lora_act, proj_up, bias -> bf16 out
    return m * k // 2 + 2 * (k // g) * m + k // 2 * n + 2 * (k // g) * n + 4 * m * r + 2 * r * n + 2 * n + 2 * m * n


def w4a4_bound(m, k, n, g, r=RANK, k_ops=None):
    """The least time of one W4A4 call: its operands and output once, 2 M N (K + R) bf16 flop. k_ops: an
    odd-width layer's logical K, whose products alone count; the bytes are the padded buffers'."""
    return bound(w4a4_bytes(m, k, n, g, r), bf16_ops=2 * m * n * ((k if k_ops is None else k_ops) + r))


def decoded(args, kw):
    """The case's two operands as the kernel multiplies them: bf16(code x scale), A (M, K) and W (K, N)."""
    qa, asc, qw, wsc = args[:4]
    precision, unsigned = kw["precision"], kw["act_unsigned"]
    g = 16 if precision == "nvfp4" else 64
    a16 = (w4a4_values(qa, -1, precision=precision, unsigned=unsigned)
           * asc.float().repeat_interleave(g, dim=0).t()).to(torch.bfloat16)
    w16 = (w4a4_values(qw, 0, precision=precision) * wsc.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)
    return a16.contiguous(), w16.contiguous()


def k_bf_ms(a16, w16, iters=ITERS):
    """``k_bf`` (PERF.md row 22a: bf16 x bf16 on gemm_sm90.cuh's loop, 128 x 256 tiles) on the decoded operands;
    None where its tiles do not cover the shape (M % 128)."""
    if a16.shape[0] % 128:
        return None
    a16, w16 = a16.contiguous(), w16.contiguous()
    return time_ms(lambda: gemm_probe_bf16(a16, w16), iters)


def w4a4_decode_bf16(qact, ascales, qweight, wscales, lora_act, proj_up, bias, *, precision, act_unsigned=False):
    """The other design's first half: the W4A4 GEMM's operands decoded to
    bf16 -> a16 (Mp, Kx), w16 (Kx, N), Mp = M rounded up to 128, Kx = K + R
    (+ 1 with a bias) rounded up to 64, so that ``(a16 @ w16)[:M]`` with f32
    sums is :func:`gemm_w4a4`'s function. Each value is bf16(code x scale) in
    logical k order; columns / rows K .. K + R are bf16(lora_act) and
    proj_up, then a column of ones against the bias; the rest zeros. On the
    card ``nt_w4a4_decode`` (csrc/gemm_w4a4.cu) writes them; on the CPU the
    same in torch. Operands as :func:`gemm_w4a4`'s, the weight not a
    stack."""
    m, k, n = qact.shape[0], 2 * qact.shape[1], qweight.shape[1]
    r = 0 if lora_act is None or proj_up is None else lora_act.shape[1]
    mp, kx = -(-m // 128) * 128, k + -(-(r + (bias is not None)) // 64) * 64
    if not qact.is_cuda:
        g = group_size(precision)
        a16 = torch.zeros((mp, kx), dtype=torch.bfloat16)
        w16 = torch.zeros((kx, n), dtype=torch.bfloat16)
        a16[:m, :k] = (w4a4_values(qact, -1, precision=precision, unsigned=act_unsigned)
                       * ascales.float().repeat_interleave(g, dim=0).t()).to(torch.bfloat16)
        w16[:k] = (w4a4_values(qweight, 0, precision=precision)
                   * wscales.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)
        if r:
            a16[:m, k:k + r] = lora_act.to(torch.bfloat16)
            w16[k:k + r] = proj_up.to(torch.bfloat16)
        if bias is not None:
            a16[:m, k + r] = 1
            w16[k + r] = bias.to(torch.bfloat16)
        return a16, w16
    _build.require(qact.is_contiguous() and qweight.t().is_contiguous() and ascales.is_contiguous()
                   and wscales.is_contiguous() and k % 256 == 0 and qact.data_ptr() % 16 == 0
                   and qweight.data_ptr() % 16 == 0,
                   "w4a4_decode_bf16: contiguous qact and scales, a K-contiguous weight, 16-byte aligned codes, "
                   "K % 256 == 0")
    la = None if not r else lora_act.float().contiguous()
    pu = None if not r else proj_up.to(torch.bfloat16).contiguous()
    b = None if bias is None else bias.to(torch.bfloat16).contiguous()
    a16 = torch.empty((mp, kx), dtype=torch.bfloat16, device=qact.device)
    w16 = torch.empty((kx, n), dtype=torch.bfloat16, device=qact.device)
    _build.check(_build.library().nt_w4a4_decode(
        qact.data_ptr(), ascales.data_ptr(), qweight.data_ptr(), wscales.data_ptr(), _ptr(la), _ptr(pu), _ptr(b),
        a16.data_ptr(), w16.data_ptr(), m, mp, n, k, r, kx, W4A4_MODES[(precision, bool(act_unsigned))][0],
        _stream(qact)), "w4a4_decode")
    return a16, w16


def dec_k_bf(args, kw, iters=ITERS):
    """The other design timed whole: (ms of the decode and k_bf, ms of the decode alone, its largest error
    against the plain twin); None where k_bf's 256-column tiles do not cover N."""
    if args[2].shape[1] % 256:
        return None
    run = lambda: gemm_probe_bf16(*w4a4_decode_bf16(*args, **kw))  # noqa: E731
    err = (run()[:args[0].shape[0]].float() - gemm_w4a4_plain(*args, **kw).float()).abs().max().item()
    return time_ms(run, iters), time_ms(lambda: w4a4_decode_bf16(*args, **kw), iters), err


def rows():
    """(row, make) with make() -> (call, args, kw, bound)."""
    def case(m, k, n, precision="int4", unsigned=False, r=RANK, stacked=False):
        def make():
            args, kw = checks.w4a4_case(m, k, n, precision, unsigned, r, device="cuda")
            if stacked:
                stack, ids = checks.stack_case(args[2])
                run = (args[0], args[1], stack) + args[3:]
                call = lambda: gemm_w4a4(*run, **kw, layer_idx=ids[-1])  # noqa: E731
            else:
                call = lambda: gemm_w4a4(*args, **kw)  # noqa: E731
            return call, args, kw, w4a4_bound(m, k, n, 16 if precision == "nvfp4" else 64, r)
        return make

    m = S_IMG + S_TXT
    yield "8", case(m, DIM, HID)
    yield "8:m512", case(S_TXT, DIM, HID)
    yield "8:r128", case(S_IMG, DIM, 3 * DIM, r=128)  # Qwen-Image's qkv at rank 128
    yield "8:r256", case(m, ZI_DIM, 3 * ZI_DIM, r=256)  # Z-Image's qkv at rank 256 (two chunks of 128)
    yield "8s", case(m, ZI_DIM, 3 * ZI_DIM, stacked=True)
    yield "8u", case(m, HID, DIM, unsigned=True)
    yield "8u:r128", case(S_IMG, HID, DIM, unsigned=True, r=128)
    yield "8n", case(m, DIM, HID, "nvfp4")
    yield "8n:m512", case(S_TXT, DIM, 3 * DIM, "nvfp4")
    yield "8n:r128", case(S_IMG, DIM, 3 * DIM, "nvfp4", r=128)
    yield "8sn", case(m, ZI_DIM, 3 * ZI_DIM, "nvfp4", stacked=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_w4a4: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(nvidia_smi())
    for row, make in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call, case_args, kw, (bnd, by) = make()
        out = call()
        sha = digest(out)
        err = (out.float() - gemm_w4a4_plain(*case_args, **kw).float()).abs().max().item()
        ms = time_ms(call, ITERS)
        a16, w16 = decoded(case_args, kw)
        lib = time_ms(lambda: torch.matmul(a16, w16), ITERS)
        kbf = k_bf_ms(a16, w16)
        del a16, w16
        dec = dec_k_bf(case_args, kw)
        dec = "n/a" if dec is None else f"{dec[0]:.4f} (dec {dec[1]:.4f}, err {dec[2]:.3e})"
        print(f"{row} {ms:.4f} matmul {lib:.4f} k_bf {'n/a' if kbf is None else f'{kbf:.4f}'} dec+k_bf {dec} "
              f"bound {bnd:.4f} ({by}) {100 * bnd / ms:.1f}% err {err:.3e} sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call, case_args, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
