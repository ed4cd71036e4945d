"""Where one FLUX.1-dev, Qwen-Image, SDXL, SANA or Z-Image denoise step, or
one VAE decode, spends its time on the card.

    python -m nunchaku_tpu_torch.tools.profile_step [--precision w4a8|nvfp4-a8|int8|int4|nvfp4] [--turbo] [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --precision int4 --size 2048 --sparsity 0.5 [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --model qwenimage [--precision P] [--rank R] \
        [--online-softmax] [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --precision int8 --attn-int8 [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --model sdxl [--size 1024|512] [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --model sana [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --model zimage [--precision P] [--rank R] [--turbo] [--out TABLE.txt]
    python -m nunchaku_tpu_torch.tools.profile_step --decode [--whole] [--out TABLE.txt]

Default: builds the full-width, full-depth model (w4a8, or ``--precision``)
from random weights (with ``--turbo``: switched to the bf16-stream
configuration with the fused qkv prologue, as ``bench.py`` serves it), runs
one warm 1024x1024 (``--size``) transformer forward, then traces one more
with ``torch.profiler`` (CUDA activity). ``--sparsity R``: block-sparse
attention at ratio R (``set_attention_impl("blocksparse")``, FLUX's
2048px path), its kernels a group of their own (``bs_fixed``). At int4 / nvfp4 the torch glue is also
split by caller: the tool wraps the activation quantize and the MLP's GELU
in ``record_function`` ranges (in this process only) and sums the device
kernels each range launched.
The w4a8 route follows the JAX package's switches as the environment sets
them (``NUNCHAKU_TPU_W4A8_XLA``, ``NUNCHAKU_TPU_W4A8_FUSED``; both, as
``XLA=0 FUSED=1``, give the packed-int4 route: the packed GEMM
``gemm_w4a8_kernel`` and the producer's W4 form, a group of their own).
``--precision int8``: FLUX.1-dev at int8 (with ``--turbo``, ``bench.py
--dense``'s configuration), its MLP chains on the int8 stacks; the chain
follows ``NUNCHAKU_TPU_CHAIN_PTOKEN`` (``=1``: the per-token producer and
the rank-1 consumer, the chain kernels' other modes, in the same groups).
Every FLUX
forward prints its launch counts per forward (the stacked modes by their
``*_stacked`` names).
``--model qwenimage``: the full Qwen-Image model (60 joint blocks; int4
unless ``--precision`` says otherwise), one forward at B 1 from a prompt of
97 valid tokens padded to 211 with its mask (the flash kernel's mask form).
``--online-softmax``: every block's attention with ``fixed_softmax =
False`` (the online kernel's forms). ``--rank``: the low-rank width (32,
or 128 as nunchaku's rank-128 Qwen-Image checkpoints have it).
``--model sdxl``: the full SDXL UNet (``SDXLConfig()``: int4, 70
transformer blocks, head dim 64), one forward at B 1 (one of a CFG step's
two) at 1024x1024 (``--size``) from random embeddings (77 x 2048, pooled
1280); its convolutions are a group of their own, and so is the online
flash kernel's D-64 form (``flash_online_d64``).
``--model sana``: the full SANA 1.6B transformer (``SanaConfig()``: int4,
20 blocks, dim 2240), one CFG forward at B 2 at 1024x1024 (32x32 latent
tokens) against 300 random text embeddings; its D-112 online flash
(``flash_online_d112``) is a group of its own, its depthwise convolutions
fall in the convolutions group.
``--model zimage``: the full Z-Image-Turbo transformer (dim 3840, 30 + 2 +
2 blocks; int4 unless ``--precision`` says otherwise, w4a8 following the
route switches), one forward at B 1 at 1024x1024 (4096 image tokens)
against 512 caption tokens, its linears reading their stacks by layer index
(the stacked modes, each a group of its own); ``--turbo``: after
``enable_fused_qkv_prep()`` (the qkv/RoPE producer).
``--attn-int8``: FLUX with ``attn_int8 = True`` on every block (set
through ``set_on_stacks``; ``quantize_qk`` and the int8 form of the
attention core, ``flash_fixed_i8``), in the bf16-stream configuration with
the unfused prologue that the switch needs (``chip_smoke.py``'s
``[flux-attn]`` setup).
``--decode``: the same for one decode of 128x128 latents (a 1024x1024
image) by the full FLUX VAE decoder from random weights, in 64-latent tiles
(``--whole``: in one piece). Prints the wall time, the device's busy time
and idle share, device time by group (the port's kernels, PyTorch's GEMMs
or cuDNN's convolutions, the rest) and the top kernels; with ``--out``,
the full ``key_averages`` table goes to that file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
PORT_KERNELS = ("dequant_w4a8_kernel", "gemm_gelu_kernel", "requant_kernel", "gemm_grouped_kernel",
                "ln_mod_quant_kernel", "qkv_rope_kernel", "flash_wide_kernel",
                "gemm_w4a4_kernel", "gemv_awq_kernel", "gemm_w4a8_kernel")


def _core(policy: int, d: int, form: int) -> str:
    """The pattern of one instantiation flash_sm90_kernel<policy, D, form> of the attention core."""
    arg = r"\s*(?:\(int\))?"
    return rf"flash_sm90_kernel<{arg}{policy},{arg}{d},{arg}{form}\s*>"


# kernels with a group of their own: each form of the attention core (csrc/flash_sm90.cuh) under the launch
# count's name, and the chain producer on packed int4 weights
FORM_KERNELS = {_core(0, 128, 0): "flash_fixed (flash_sm90_kernel)",
                _core(0, 128, 1): "flash_fixed_masked (flash_sm90_kernel, MASK)",
                _core(0, 128, 2): "bs_fixed (flash_sm90_kernel, IDX)",
                _core(0, 128, 3): "flash_fixed_denom (flash_sm90_kernel, DENOM)",
                _core(0, 128, 4): "flash_fixed_unroll2 (flash_sm90_kernel, U2)",
                _core(0, 128, 6): "flash_fixed_i8 (flash_sm90_kernel, I8)",
                _core(1, 64, 0): "flash_online_d64 (flash_sm90_kernel, D 64)",
                _core(1, 112, 0): "flash_online_d112 (flash_sm90_kernel, D 112)",
                _core(1, 128, 0): "flash_online (flash_sm90_kernel, D 128)",
                _core(1, 128, 1): "flash_online_masked (flash_sm90_kernel, MASK)",
                _core(1, 128, 2): "bs_online (flash_sm90_kernel, IDX)",
                _core(1, 128, 5): "flash_online_bshd (flash_sm90_kernel, TOK)",
                r"gemm_gelu_kernel<[^>]*WeightW4": "gemm_w4a8_gelu_quant (gemm_gelu_kernel, W4 form)"}
QUANT_RANGE, GELU_RANGE = "quantize chain (torch ops)", "GELU (torch ops)"


def _ranged(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def glue_by_range(prof) -> dict[str, float]:
    """Device ms of the kernels launched under each ``record_function``
    range (through the CPU ops' linked kernels and their parents)."""
    out: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        p = ev
        while p is not None and p.name not in (QUANT_RANGE, GELU_RANGE):
            p = p.cpu_parent
        if p is None:
            continue
        for k in ev.kernels:
            key = p.name + (", its float GEMM" if group_of(k.name) == "torch float GEMM" else "")
            out[key] = out.get(key, 0.0) + k.duration / 1e3
    return out


def group_of(name: str) -> str:
    for pattern, group in FORM_KERNELS.items():
        if re.search(pattern, name):
            return "port kernel " + group
    for k in PORT_KERNELS:
        if k in name:
            return "port kernel " + k
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "convolution layout conversions (cuDNN NCHW <-> NHWC)"
    if any(k in low for k in ("fprop", "conv", "cudnn")):
        return "convolutions (cuDNN)"
    if "gemm_s8" in low or "igemm" in low or "int8" in low or "imma" in low:
        return "torch int8 GEMM (_int_mm)"
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return "torch float GEMM"
    return "other (elementwise, reductions, copies)"


def decode_group_of(name: str) -> str:
    low = name.lower()
    if "flash_wide_kernel" in low:
        return "port kernel flash_wide_kernel (mid-block attention)"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "convolution layout conversions (cuDNN NCHW <-> NHWC)"
    if any(s in low for s in ("conv", "fprop", "implicit", "xmma", "cudnn", "cutlass", "gemm")):
        return "convolutions (cuDNN)"
    if any(s in low for s in ("welford", "addcmul", "rsqrt", "silu")):
        return "GroupNorm statistics and affine / SiLU"
    if "upsample" in low:
        return "nearest 2x upsample"
    return "casts, bias and residual adds, tile blend, copies (elementwise)"


def conv_flop(vae, z) -> int:
    """2 * Cout * Cin * kh * kw * Hout * Wout summed over every convolution
    one decode of ``z`` runs (counted by forward hooks on a decode)."""
    from nunchaku_tpu_torch.models.autoencoder import Conv2d

    total = [0]

    def hook(mod, _, out):
        cout, cin, kh, kw = mod.weight.shape
        total[0] += 2 * cout * cin * kh * kw * out.shape[0] * out.shape[2] * out.shape[3]

    hooks = [m.register_forward_hook(hook) for m in vae.modules() if isinstance(m, Conv2d)]
    vae.decode(z)
    for h in hooks:
        h.remove()
    return total[0]


def _trace(fn):
    """One warm call, one timed untraced call, one traced call -> (seconds
    untraced, seconds traced, profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall_plain, wall, prof


def _report(header, what, wall_plain, wall, prof, grouping, out, extra=None):
    groups: dict[str, float] = {}
    kernels: dict[str, tuple[float, int]] = {}
    for ev in prof.events():
        # the record_function ranges also appear as device-side annotations: not kernels
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name in (QUANT_RANGE, GELU_RANGE):
            continue
        us = ev.time_range.elapsed_us()
        groups[grouping(ev.name)] = groups.get(grouping(ev.name), 0.0) + us
        t, n = kernels.get(ev.name, (0.0, 0))
        kernels[ev.name] = (t + us, n + 1)
    busy_ms = sum(groups.values()) / 1e3
    lines = [header,
             f"{what} wall {wall_plain * 1e3:.1f} ms untraced, {wall * 1e3:.1f} ms traced; "
             f"device busy {busy_ms:.1f} ms (kernel time summed); idle share "
             f"{max(0.0, 1 - busy_ms / (wall * 1e3)):.3f} of the traced {what}"]
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {us / 1e3:9.2f} ms  {100 * us / 1e3 / busy_ms:5.1f}%  {name}")
    if extra:
        lines.extend(extra(prof))
    lines.append("top kernels (ms total, calls):")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        lines.append(f"  {us / 1e3:9.2f} ms {n:5d}  {name[:150]}")
    print("\n".join(lines))
    if out:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="device_time_total", row_limit=80, max_name_column_width=120))
        print(f"full table: {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="profile one FLUX.1-dev, Qwen-Image, SDXL, SANA or Z-Image forward or "
                                             "one VAE decode")
    ap.add_argument("--out", help="file for the full key_averages table")
    ap.add_argument("--model", choices=("flux", "qwenimage", "sdxl", "sana", "zimage"), default="flux",
                    help="the denoiser: FLUX.1-dev (w4a8 by default), Qwen-Image (int4 by default), the "
                         "SDXL UNet (int4), SANA 1.6B (int4) or Z-Image-Turbo (int4 by default)")
    ap.add_argument("--turbo", action="store_true",
                    help="bf16 residual stream + fused qkv prologue (the configuration bench.py serves)")
    ap.add_argument("--precision", choices=("w4a8", "nvfp4-a8", "int8", "int4", "nvfp4"),
                    help="the model's SVDQuant precision (int4 / nvfp4: AWQ modulation, W4A4 GEMMs; nvfp4-a8: "
                         "w4a8 with e2m1 codes; int8: FLUX only); default w4a8 for FLUX, int4 for Qwen-Image")
    ap.add_argument("--rank", type=int, default=32, help="the low-rank width of every SVDQuant linear")
    ap.add_argument("--size", type=int, default=1024,
                    help="FLUX and SDXL: image side in pixels (FLUX 2048: 16384 image tokens)")
    ap.add_argument("--sparsity", type=float, default=0.0,
                    help="FLUX: block-sparse attention at this ratio (0: dense flash)")
    ap.add_argument("--online-softmax", action="store_true",
                    help="every block's attention with fixed_softmax = False (the online kernel)")
    ap.add_argument("--attn-int8", action="store_true",
                    help="FLUX: attn_int8 on every block (int8 q . k), bf16 stream, unfused prologue")
    ap.add_argument("--decode", action="store_true", help="profile one 1024px VAE decode instead of a forward")
    ap.add_argument("--whole", action="store_true", help="with --decode: one piece instead of 64-latent tiles")
    args = ap.parse_args(argv)
    if args.model == "qwenimage" and (args.turbo or args.size != 1024 or args.sparsity):
        ap.error("--turbo, --size and --sparsity are FLUX options")
    if args.model == "sdxl" and (args.turbo or args.sparsity or args.online_softmax or args.precision
                                 not in (None, "int4")):
        ap.error("SDXL runs int4 with the online softmax (--size only)")
    if args.model == "sana" and (args.turbo or args.sparsity or args.online_softmax or args.size != 1024
                                 or args.precision not in (None, "int4")):
        ap.error("SANA runs int4 at 1024px (no options)")
    if args.model == "zimage" and (args.sparsity or args.online_softmax or args.size != 1024
                                   or args.precision == "nvfp4-a8"):
        ap.error("Z-Image runs at 1024px with the fixed softmax (--precision int4 | nvfp4 | w4a8, --rank, --turbo)")
    if args.turbo and args.sparsity:
        ap.error("block-sparse attention runs with the unfused prologue only (no --turbo)")
    if args.attn_int8 and (args.model != "flux" or args.turbo or args.sparsity or args.online_softmax):
        ap.error("--attn-int8 is a FLUX option with the unfused prologue and dense fixed-shift attention")
    if args.precision == "int8" and args.model != "flux":
        ap.error("--precision int8 is a FLUX option")
    if args.precision is None:
        args.precision = "w4a8" if args.model == "flux" else "int4"
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.decode:
        from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL

        vae = AutoencoderKL.random_init(seed=0, device=dev)
        if not args.whole:
            vae.enable_tiling()
        z = torch.randn((1, 16, 128, 128), generator=gen, device=dev).to(torch.bfloat16)
        flop = conv_flop(vae, z)
        wall_plain, wall, prof = _trace(lambda: vae.decode(z))
        header = (f"card: {smi}; torch {torch.__version__}; FLUX VAE decode of 128x128 latents "
                  f"({'whole image' if args.whole else '3 x 3 tiles of 64 latents'}); convolutions "
                  f"{flop / 1e12:.3f} TFLOP, least time {flop / PEAK_BF16 * 1e3:.2f} ms at 989 TFLOP/s bf16")
        _report(header, "decode", wall_plain, wall, prof, decode_group_of, args.out)
        return 0

    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    if args.model == "sdxl":
        from nunchaku_tpu_torch.models import linear, unet_sdxl

        cfg = unet_sdxl.SDXLConfig()
        model = unet_sdxl.SDXLUNet2DConditionModel.random_init(cfg, seed=0, device=dev)
        side = args.size // 8
        inputs = (torch.randn((1, 4, side, side), generator=gen, device=dev).to(torch.bfloat16),
                  torch.full((1,), 500.0, device=dev),
                  torch.randn((1, 77, cfg.cross_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((1, 1280), generator=gen, device=dev).to(torch.bfloat16),
                  torch.tensor([[args.size, args.size, 0, 0, args.size, args.size]], dtype=torch.float32, device=dev))
        # the SVDQ linears' quantize and the GEGLU-fused one of each feed-forward
        linear.quantize_w4a4_act_fuse_lora = _ranged(linear.quantize_w4a4_act_fuse_lora, QUANT_RANGE)
        unet_sdxl.quantize_w4a4_act_fuse_lora = _ranged(unet_sdxl.quantize_w4a4_act_fuse_lora, QUANT_RANGE)

        def extra(prof):
            return ["torch glue by caller (device ms, inside the groups above):"] + [
                f"  {ms:9.2f} ms  {name}" for name, ms in sorted(glue_by_range(prof).items())]
        with torch.no_grad():
            wall_plain, wall, prof = _trace(lambda: model(*inputs))
        header = (f"card: {smi}; torch {torch.__version__}; SDXL UNet int4 (70 transformer blocks, head dim 64) at "
                  f"{args.size}px ({side}x{side} latents), B 1, 77 text tokens")
        _report(header, "forward", wall_plain, wall, prof, group_of, args.out, extra)
        return 0

    if args.model == "sana":
        from nunchaku_tpu_torch.models import linear, transformer_sana

        cfg = transformer_sana.SanaConfig()
        model = transformer_sana.SanaTransformer2DModel.random_init(cfg, seed=0, device=dev)
        inputs = (torch.randn((2, 1024, cfg.in_channels), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((2, 300, cfg.caption_channels), generator=gen, device=dev).to(torch.bfloat16),
                  torch.full((2,), 0.5, device=dev))
        linear.quantize_w4a4_act_fuse_lora = _ranged(linear.quantize_w4a4_act_fuse_lora, QUANT_RANGE)
        transformer_sana.quantize_w4a4_act_fuse_lora = _ranged(transformer_sana.quantize_w4a4_act_fuse_lora,
                                                               QUANT_RANGE)

        def extra(prof):
            return ["torch glue by caller (device ms, inside the groups above):"] + [
                f"  {ms:9.2f} ms  {name}" for name, ms in sorted(glue_by_range(prof).items())]
        with torch.no_grad():
            wall_plain, wall, prof = _trace(lambda: model(*inputs))
        header = (f"card: {smi}; torch {torch.__version__}; SANA 1.6B int4 (20 blocks, dim 2240) at 1024px "
                  f"(32x32 latent tokens), B 2 (one CFG step), 300 text tokens")
        _report(header, "forward", wall_plain, wall, prof, group_of, args.out, extra)
        return 0

    if args.model == "zimage":
        from nunchaku_tpu_torch.models import linear, transformer_zimage
        from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

        cfg = transformer_zimage.ZImageConfig(dim=3840, num_layers=30, num_refiner_layers=2, num_attention_heads=30,
                                              cap_feat_dim=2560, precision=args.precision, rank=args.rank)
        model = transformer_zimage.ZImageTransformer2DModel.random_init(cfg, seed=0, device=dev)
        if args.turbo:
            model.enable_fused_qkv_prep()
        inputs = (torch.randn((1, 4096, 64), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((1, 512, cfg.cap_feat_dim), generator=gen, device=dev).to(torch.bfloat16),
                  torch.full((1,), 0.5, device=dev), make_img_ids(64, 64, dev),
                  torch.zeros((512, 3), dtype=torch.int32, device=dev))
        linear.quantize_w4a4_act_fuse_lora = _ranged(linear.quantize_w4a4_act_fuse_lora, QUANT_RANGE)
        transformer_zimage.quantize_w4a4_act_fuse_lora = _ranged(transformer_zimage.quantize_w4a4_act_fuse_lora,
                                                                 QUANT_RANGE)

        def extra(prof):
            with torch.no_grad():
                reset_launch_counts()
                model(*inputs)
            ran = {k: v for k, v in launch_counts().items() if v}
            return ([f"launches per forward: {ran}", "torch glue by caller (device ms, inside the groups above):"]
                    + [f"  {ms:9.2f} ms  {name}" for name, ms in sorted(glue_by_range(prof).items())])
        with torch.no_grad():
            wall_plain, wall, prof = _trace(lambda: model(*inputs))
        what = f"Z-Image-Turbo {args.precision} rank {args.rank} (30 + 2 + 2 blocks, dim 3840, stacked)"
        if args.precision == "w4a8":
            from nunchaku_tpu_torch.ops.gemm import w4a8_use_xla

            what += f", w4a8 route NUNCHAKU_TPU_W4A8_XLA={'1' if w4a8_use_xla() else '0'}"
        header = (f"card: {smi}; torch {torch.__version__}; {what}{', fused qkv prep' if args.turbo else ''} at 1024px "
                  f"(4096 image tokens), B 1, 512 caption tokens")
        _report(header, "forward", wall_plain, wall, prof, group_of, args.out, extra)
        return 0

    if args.model == "qwenimage":
        from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel

        cfg = QwenImageConfig(precision=args.precision, rank=args.rank)
        model = QwenImageTransformer2DModel.random_init(cfg, seed=0, device=dev)
        s_txt = 211
        inputs = (torch.randn((1, 4096, 64), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((1, s_txt, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                  torch.full((1,), 0.7, device=dev), make_img_ids(64, 64, dev))
        kw = dict(encoder_hidden_states_mask=torch.arange(s_txt, device=dev)[None, :] < 97)
        what = (f"Qwen-Image {args.precision} rank {args.rank} (60 joint blocks), B 1, 97 of 211 text tokens valid "
                f"(masked)")
    else:
        from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel

        cfg = FluxConfig(precision=args.precision, rank=args.rank)
        model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
        if args.turbo:
            model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        if args.sparsity:
            model.set_attention_impl("blocksparse", sparsity_ratio=args.sparsity)
        if args.attn_int8:
            model.set_stream_dtype(torch.bfloat16).set_on_stacks("attn", attn_int8=True)
        side = args.size // 16  # latent tokens per side (VAE stride 8, 2x2 patches)
        inputs = (
            torch.randn((1, side * side, 64), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, 512, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.full((1,), 0.7, device=dev), make_img_ids(side, side, dev),
            torch.zeros((512, 3), dtype=torch.int32, device=dev), torch.full((1,), 3.5, device=dev),
        )
        kw = {}
        config = ("turbo (bf16 stream, fused qkv prologue)" if args.turbo else
                  "bf16 stream, unfused prologue" if args.attn_int8 else "default (f32 stream)")
        what = (f"FLUX.1-dev {args.precision} at {args.size}px ({side * side} image + 512 text tokens), {config}, "
                f"{f'block-sparse attention at {args.sparsity}' if args.sparsity else 'dense attention'}"
                f"{', attn_int8 (int8 q . k)' if args.attn_int8 else ''}")
    if args.online_softmax:
        model.set_on_stacks("attn", fixed_softmax=False)
        what += ", fixed_softmax False"
    if args.precision == "int8":
        from nunchaku_tpu_torch.ops.gemm import chain_ptoken

        what += f", chain NUNCHAKU_TPU_CHAIN_PTOKEN={'1 (per-token)' if chain_ptoken() else '0 (grouped)'}"
    if args.precision in ("w4a8", "nvfp4-a8"):
        from nunchaku_tpu_torch.ops.gemm import w4a8_fused, w4a8_use_xla

        what += (f", w4a8 route NUNCHAKU_TPU_W4A8_XLA={'1' if w4a8_use_xla() else '0'} "
                 f"NUNCHAKU_TPU_W4A8_FUSED={'1' if w4a8_fused() else '0'}")
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    glue = args.precision in ("int4", "nvfp4")
    if glue:
        from nunchaku_tpu_torch.models import attention, linear

        linear.quantize_w4a4_act_fuse_lora = _ranged(linear.quantize_w4a4_act_fuse_lora, QUANT_RANGE)
        attention.gelu_jax = _ranged(attention.gelu_jax, GELU_RANGE)

    def extra(prof):
        with torch.no_grad():
            reset_launch_counts()
            model(*inputs, **kw)
        lines = [f"launches per forward: { {k: v for k, v in launch_counts().items() if v} }"]
        if glue:
            lines += ["torch glue by caller (device ms, inside the groups above):"] + [
                f"  {ms:9.2f} ms  {name}" for name, ms in sorted(glue_by_range(prof).items())]
        return lines
    with torch.no_grad():
        wall_plain, wall, prof = _trace(lambda: model(*inputs, **kw))
    header = f"card: {smi}; torch {torch.__version__}; {what}"
    _report(header, "forward", wall_plain, wall, prof, group_of, args.out, extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
