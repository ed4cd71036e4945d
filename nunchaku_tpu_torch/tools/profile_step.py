"""Where one FLUX.1-dev w4a8 denoise step spends its time on the card.

    python -m nunchaku_tpu_torch.tools.profile_step [--turbo] [--out TABLE.txt]

Builds the full-width, full-depth model from random weights (with
``--turbo``: switched to the bf16-stream configuration with the fused qkv
prologue, as ``bench.py`` serves it), runs one warm 1024x1024 transformer
forward, then traces one more with ``torch.profiler`` (CUDA activity).
Prints the forward's wall time, the device's busy time and idle share,
device time by group (the port's kernels, PyTorch's int8 and float GEMMs,
the rest) and the top kernels; with ``--out``, the full ``key_averages``
table goes to that file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

PORT_KERNELS = ("dequant_w4a8_kernel", "gemm_gelu_kernel", "requant_kernel",
                "gemm_grouped_kernel", "flash_fixed_kernel", "ln_mod_quant_kernel", "qkv_rope_kernel")


def group_of(name: str) -> str:
    for k in PORT_KERNELS:
        if k in name:
            return "port kernel " + k
    low = name.lower()
    if "gemm_s8" in low or "igemm" in low or "int8" in low or "imma" in low:
        return "torch int8 GEMM (_int_mm)"
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "torch float GEMM"
    return "other (elementwise, reductions, copies)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="profile one FLUX.1-dev w4a8 forward")
    ap.add_argument("--out", help="file for the full key_averages table")
    ap.add_argument("--turbo", action="store_true",
                    help="bf16 residual stream + fused qkv prologue (the configuration bench.py serves)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = FluxConfig(precision="w4a8")
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    if args.turbo:
        model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = (
        torch.randn((1, 4096, 64), generator=gen, device=dev).to(torch.bfloat16),
        torch.randn((1, 512, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
        torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
        torch.full((1,), 0.7, device=dev), make_img_ids(64, 64, dev),
        torch.zeros((512, 3), dtype=torch.int32, device=dev), torch.full((1,), 3.5, device=dev),
    )
    with torch.no_grad():
        model(*inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(*inputs)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    groups: dict[str, float] = {}
    kernels: dict[str, tuple[float, int]] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        groups[group_of(ev.name)] = groups.get(group_of(ev.name), 0.0) + us
        t, n = kernels.get(ev.name, (0.0, 0))
        kernels[ev.name] = (t + us, n + 1)
    busy_ms = sum(groups.values()) / 1e3
    lines = [f"card: {smi}; torch {torch.__version__}; "
             f"{'turbo (bf16 stream, fused qkv prologue)' if args.turbo else 'default (f32 stream)'}",
             f"forward wall {wall_plain * 1e3:.1f} ms untraced, {wall * 1e3:.1f} ms traced; "
             f"device busy {busy_ms:.1f} ms (kernel time summed); idle share "
             f"{max(0.0, 1 - busy_ms / (wall * 1e3)):.3f} of the traced forward"]
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  {name}")
    lines.append("top kernels (ms total, calls):")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        lines.append(f"  {us / 1e3:9.2f} ms {n:5d}  {name[:150]}")
    print("\n".join(lines))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="device_time_total", row_limit=80, max_name_column_width=120))
        print(f"full table: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
