"""Times and output digests of the qkv / RoPE producer
(``csrc/qkv_rope_producer.cu``) at the shapes its model paths call: PERF.md
row 7 at FLUX.1-dev's single block (S 4608, H 24, R 32), the dual block's
two calls into one shared buffer (the image stream's 4096 rows at row 512,
then the text stream's 512 rows at row 0), the rank-128 and rank-256 files'
calls (``7:r128``, ``7:r256``), Z-Image's call without low-rank operands (H
30, S 4096: ``7:r0``), and row 18 (``qkv_prepare``, the same kernel's
prepare form, S 4608, H 24). Beside each row with a low-rank term,
``torch.matmul(bf16(lora_act), proj_up)``: a yardstick for the low-rank
product alone, not the same function (no RMSNorm, RoPE or head split). A
quick A/B of the kernel without the whole ``chip_smoke.py``: run it in two
trees, in turns, and compare.

    python -m nunchaku_tpu_torch.tools.time_qkv [--split] [ROW ...]

One line per row: ``<row> <ms> graph <ms> host <ms> [lowrank_matmul <ms>]
bound <ms> (<by>) <share>% sha <digest>``. ``ms`` is a call's time back to
back (CUDA events over warm calls); ``graph`` the device's alone, from a
CUDA graph of the same calls replayed (no host work between the kernels),
and the share of the bound is of it; ``host`` the host's time to enqueue
one call (the least of five runs): a row whose ms is no more than that is
bound by the host. The digest is a SHA-256 of q, k and v (the whole shared
buffers, zeroed before the first call) on inputs drawn from a seed on the
card, so two builds whose digests agree give the same outputs bit for bit. ``--split`` adds
each device kernel's ms a call (the profiler over five calls; run it apart
from an A/B, as the profiler slows the host's later launches). A ROW
argument selects that row, or every ``ROW:<variant>`` row. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from ..ops import checks
from ..ops.attention import qkv_prepare, qkv_rope_producer
from .probe_common import bound, nvidia_smi, time_ms
from .time_attention import graph_ms
from .time_chain import digest, kernel_split

HD, HEADS, S_IMG, S_TXT, RANK = 128, 24, 4096, 512, 32  # FLUX.1-dev at 1024px
ZI_HEADS, ZI_S = 30, 4096  # Z-Image-Turbo (dim 3840) at 1024px
Q_SCALE = 1.4426950408889634 / math.sqrt(HD)  # log2(e) / sqrt(D): the flash kernels' exp2 domain
ITERS = 50  # timed calls a row
GRAPH_CALLS = 20  # calls a row's CUDA graph holds


def rope_bytes(s, r, heads=HEADS):
    """qkv bf16, cos + sin f32, the two norm weights and, with a low-rank term, lora_act f32 and proj_up read
    once; q, k, v bf16 written once."""
    n3 = 3 * heads * HD
    return 2 * s * n3 + 8 * s * HD + 4 * HD + 4 * s * r + 2 * r * n3 + 2 * s * n3


def rope_bound(s, r, heads=HEADS):
    """The call's bound: its bytes, and 2 S 3HD R bf16 operations of the low-rank product."""
    return bound(rope_bytes(s, r, heads), bf16_ops=2 * s * 3 * heads * HD * r)


def host_ms(call, batches: int = 5) -> float:
    """The host's ms to enqueue one call: the least mean over ``batches`` runs of ITERS calls (the host's clock
    varies more than the card's: a one-card machine shares its host's cores)."""
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            call()
        best = min(best, (time.perf_counter() - t0) * 1e3 / ITERS)
    torch.cuda.synchronize()
    return best


def rows():
    """(row, make) with make() -> (call, (bf16(lora_act), proj_up) | None, bound)."""
    def producer(seqs, heads, r, which=None):
        """The streams of one shared buffer set; ``which`` picks one stream's call (by its index in the
        model's call order, image first), else every call."""
        def make():
            streams, cos, sin = checks.qkv_rope_case(1, seqs, heads, HD, r, device="cuda")
            out = tuple(torch.zeros((1, heads, sum(seqs), HD), dtype=torch.bfloat16, device="cuda")
                        for _ in range(3))
            picked = streams if which is None else [streams[which]]

            def call():
                for qkv, nq, nk, la, pu, off in picked:
                    s = qkv.shape[1]
                    qkv_rope_producer(qkv, cos[off:off + s], sin[off:off + s], nq, nk, q_scale=Q_SCALE,
                                      lora_act=la, proj_up=pu, out=out, s_offset=off)
                return out

            s = picked[0][0].shape[1]
            lowrank = (picked[0][3].to(torch.bfloat16), picked[0][4]) if r else None
            return call, lowrank, rope_bound(s, r, heads)
        return make

    def prepare(s):
        def make():
            streams, cos, sin = checks.qkv_rope_case(1, (s,), HEADS, HD, 0, device="cuda")
            qkv, nq, nk = streams[0][:3]
            return (lambda: qkv_prepare(qkv, cos, sin, nq, nk, heads=HEADS, head_dim=HD, q_scale=Q_SCALE), None,
                    rope_bound(s, 0))
        return make

    s = S_IMG + S_TXT
    yield "7", producer((s,), HEADS, RANK)
    yield "7:img", producer((S_TXT, S_IMG), HEADS, RANK, 0)  # 4096 rows at row 512 of the joint buffer
    yield "7:txt", producer((S_TXT, S_IMG), HEADS, RANK, 1)  # 512 rows at row 0
    yield "7:r128", producer((s,), HEADS, 128)
    yield "7:r256", producer((s,), HEADS, 256)
    yield "7:r0", producer((ZI_S,), ZI_HEADS, 0)
    yield "18", prepare(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*", help="rows to run (default: all)")
    ap.add_argument("--split", action="store_true", help="each device kernel's ms a call (profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_qkv: no CUDA device")
        return 1
    print(nvidia_smi())
    for row, make in rows():
        if args.rows and not any(row == r or row.startswith(r + ":") for r in args.rows):
            continue
        call, lowrank, (bnd, by) = make()
        sha = digest(call())
        ms = time_ms(call, ITERS)
        host = host_ms(call)
        dev = graph_ms([call] * GRAPH_CALLS)
        yard = ""
        if lowrank is not None:
            la16, pu = lowrank
            yard = f" lowrank_matmul {time_ms(lambda: torch.matmul(la16, pu), ITERS):.4f}"
        print(f"{row} {ms:.4f} graph {dev:.4f} host {host:.4f}{yard} bound {bnd:.4f} ({by}) "
              f"{100 * bnd / dev:.1f}% sha {sha}", flush=True)
        if args.split:
            print(f"  {row} kernels: {kernel_split(call)}", flush=True)
        del call, lowrank
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
