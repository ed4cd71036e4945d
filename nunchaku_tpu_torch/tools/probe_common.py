"""What the four GEMM probe tools share with each other and with
``chip_smoke.py``: the card's peak rates and the bound they give, the
timer, the card's name line, and the tools' conversion of their numpy draws.

On the card a call is timed with CUDA events over ``iters`` launches after
``warmup`` untimed ones; on the CPU (``device="cpu"``, the tests) with the
host clock, and the wrappers run their plain versions there, so a CPU time
is no measure of a kernel.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..ops.gemm_probe import I8_BUILT, I8_TILES

# NVIDIA H100 SXM data sheet (dense rates, 700 W)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_INT8 = 1979e12  # int8 tensor-core ops/s
PEAK_BF16 = 989e12  # bf16 tensor-core FLOP/s

I32_TILES = I8_BUILT[("i32", False)]  # the card tiles the int32 sweeps walk
RANK1_TILES = I8_BUILT[("f32", True)]  # those of the f32-accumulating rank-1 sweep


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them: every time
    is read beside them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy draw as a ``dtype`` tensor on ``device`` (integers cast on
    the host, so only the narrow copy crosses to the card)."""
    if dtype in (torch.int8, torch.int32):
        return torch.from_numpy(np.asarray(x).astype(np.int8 if dtype == torch.int8 else np.int32)).to(device)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device=device, dtype=dtype)


def k_contiguous(w: torch.Tensor) -> torch.Tensor:
    """The (..., K, N) weight as a view of a (..., N, K)-contiguous copy: the
    layout the int8 kernel and ``torch._int_mm`` read (the port's linears
    hold their int8 weights so)."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def tile_fits(tile: str, m: int, k: int, n: int) -> bool:
    _, bm, bn, bk = I8_TILES[tile]
    return m % bm == 0 and n % bn == 0 and k % bk == 0


def tile_label(tile: str, sep: str) -> str:
    """``"128x256x128s4"`` -> ``"128<sep>256<sep>128s4"`` (the JAX lines'
    tile spelling, the ring's stages after ``s``); the chain kernels' own
    instantiation stays ``"chain"``."""
    return tile if tile == "chain" else sep.join(tile.split("x"))


def time_ms(fn, iters: int, device="cuda", warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, int8_ops: float = 0.0, bf16_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: bytes
    over its memory rate or operations over its peak for their type,
    whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def row(name: str, ms: float | None, flops: float, bnd: float | None, device, note: str = "") -> dict:
    """One line of a tool: its time, rate and share of the card's bound
    (the share on the card only). ``ms`` None: the line does not run here,
    ``note`` says why."""
    on_card = torch.device(device).type == "cuda"
    return dict(name=name, ms=ms, tflops=None if ms is None else flops / (ms * 1e-3) / 1e12, bound_ms=bnd,
                of_bound=(bnd / ms if (on_card and ms and bnd) else None), device=str(device), note=note)


def share(r: dict) -> str:
    return "" if r["of_bound"] is None else f", {100 * r['of_bound']:.1f}% of bound"
