#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nunchaku_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Phases, each fatal on failure:
  1. device    -- the card's name, count, and nvidia-smi's name and power limit;
  2. build     -- nvcc builds every kernel in nunchaku_tpu_torch/csrc for sm_90a;
                  each kernel on the attention core (flash_sm90.cuh) and each
                  instantiation of the GEMM main loop (gemm_sm90.cuh: the bf16
                  probe's, the int8 chain kernels' and the int8 probe's s8 ones,
                  the int8 probe's persistent form), each of the
                  W4A4 GEMM's nine instantiations and each of the LN
                  producer's eight must show wgmma (HGMMA /
                  IGMMA) and TMA-load (UTMALDG) instructions in cuobjdump
                  -sass, the dequant's two TMA loads and stores (UTMALDG,
                  UTMASTG) and no type conversion (I2F, F2I), and the sources
                  in PTXAS_CLEAN build without spills or serialized wgmma;
  3. kernels   -- each kernel against its plain PyTorch twin at FLUX.1-dev
                  main-path shapes, its time (CUDA events over warm launches),
                  the plain twin's time, a one-call PyTorch yardstick where one
                  exists, and the least time the card could take (H100 SXM data
                  sheet: 3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s bf16); the W4A4
                  GEMM once per mode (int4, int4 with unsigned activations,
                  nvfp4; beside torch.matmul also k_bf, the bf16 GEMM probe,
                  on the decoded operands), the AWQ GEMV at both modulation widths; the kv-mask
                  forms of both flash kernels at Qwen-Image's 1024px shapes (B 2,
                  24 heads, 211 text + 4096 image tokens, batch row 1 keeping 97
                  text keys), with SDPA under the same additive mask as yardstick;
                  the block-sparse forms of both (bs_fixed, bs_online) at FLUX
                  2048px (S 16384 + 512, select_blocks at 0.5: 5 of 11 kv blocks
                  of 1536) and at a ragged 1536px shape, with SDPA under the
                  equivalent bool mask and the dense kernel at the same S; the
                  dequant's e2m1 form (nvfp4-a8) at K 3072 / N 12288 and K 12288 /
                  N 3072, bit-exact; both chain kernels at rank 128 on the fc1 / fc2
                  shapes and the W4A4 GEMM (int4, both modes) at rank 128 on
                  Qwen-Image's shapes, logged beside the rank-32 rows; the
                  packed-int4 w4a8 route's kernels: gemm_w4a8 (rank-1) at the
                  qkv and out-projection shapes, gemm_w4a8_gelu_quant at fc1,
                  gemm_w4a8_grouped at fc2, each also at rank 128 and 256, with
                  torch._int_mm of the product on the dequantized weight as
                  yardstick; every kernel that runs its rank term in chunks of
                  128 at rank 256 (rows *_r256: the LN producer single and dual,
                  the qkv/RoPE producer, the int8 chain producer and consumer and
                  the pipelined producer, the packed GEMM at Z-Image's qkv and
                  the packed chain, each against its twin); the online flash kernel at head dim 64
                  (flash_online_d64) on SDXL's 1024px shapes: self-attention
                  at H 10, S 4096 (the row) and H 20, S 1024, and both levels'
                  cross-attention against 77 text keys, SDPA as yardstick; the
                  online flash kernel at head dim 112 (flash_online_d112) on
                  SANA's cross-attention (B 2, H 20, Sq 1024, Skv 300; B 3
                  logged) and the W4A4 GEMM at SANA's padded qkv and point
                  shapes; the stacked (layer-index) modes at Z-Image's qkv
                  (M 4608, K 3840, N 11520): the W4A4 GEMM at int4 and nvfp4,
                  the dequant and the packed w4a8 GEMM (R 32 and 256; R 128 logged),
                  each bit for bit the non-stacked kernel on every layer of a
                  3-layer stack and timed beside it; the chain modes FLUX.1-dev's
                  stacks reach (the int8 producer stacked, its per-token mode,
                  the consumer grouped, grouped with the residual, rank-1 and
                  rank-1 with the residual, the packed producer and grouped
                  consumer, all stacked) at FLUX's fc1 / fc2, the same way;
                  the fixed-shift kernel's denominator form at FLUX's 2048px S
                  16896 (o within 1e-2, l within 1e-5 relative, o bit for bit
                  the one-tile kernel's), its two-tile and int8 forms at S 4608,
                  and the ring's combine of the denominator kernel over 4 kv
                  shards in one process against the dense kernel (5e-3
                  absolute); the four op-level kernels no model path calls:
                  the dual LN producer at FLUX's single block (S 4608, K 3072,
                  R 32 + 32), each head bit for bit a row-6 launch, beside the
                  two row-6 launches' time, F.layer_norm as yardstick;
                  qkv_prepare (S 4608, H 24) bit for bit the qkv producer
                  without low-rank operands, beside its time; token-major
                  flash (B 1, S 4608, H 24, D 128) within 1e-2 of its twin at
                  the kernel's tile and bit for bit the online kernel on the
                  transposed tensors, beside that kernel plus the transposed
                  copies, SDPA on the transposed views as yardstick; the
                  pipelined chain producer at fc1 (R 32 and 256; R 128 logged) bit for
                  bit the ordinary producer kernel, beside its time,
                  torch._int_mm as yardstick; the two GEMM probe kernels of
                  the ported tools at bench_gemm_variants' shape (M 4608, K
                  3072, N 12288): the int8 one with int32 or f32 accumulation
                  and the cast, and f32 with the rank-1 epilogue, bit for bit
                  at every built tile (the chain kernels' own s8 instantiation,
                  tile "chain", the row; the other tiles logged with their
                  share of the bound and their ratio to torch._int_mm),
                  torch._int_mm as yardstick;
                  the bf16-operand one in its six operand forms within one
                  bf16 step up to the f32 sums' order (a limit the same
                  product summed in bf16 must exceed), torch.matmul of the
                  decoded operands as yardstick; last, the kernels of the
                  image-conditioned paths at the shapes those give them
                  (FLUX.1-Kontext at 1024px: S 512 + 4096 + 4096, and the
                  1008px reference's 512 + 4096 + 3969), each against its
                  twin with its row's tolerance (logged, no new row); the
                  kernels a LoRA'd FLUX.1-dev runs at its ranks, rows *_lora48
                  and *_lora80 (the LN producer, the qkv/RoPE producer, the
                  chain producer and residual consumer, the W4A4 GEMM int4 and
                  unsigned at R 48 and 80, FLUX's shapes), each against its
                  twin with its rank-32 row's tolerance;
  4. reference -- a small FLUX model (1 + 1 blocks, 6 heads) through the pipeline
                  on the card (kernels) and on the CPU (plain twins), same weights
                  and noise, in the default (f32 stream) and the turbo (bf16
                  stream, fused qkv prologue) configuration; the latents must agree.
                  Then the turbo model with the double first-block cache (hit
                  ratio 0.5) and a small VAE whose 512-wide mid block takes the
                  online flash kernel, at 512x512: cache hits equal, latents and
                  images (whole, and tiled in 3 x 3 tiles) must agree. Last, the
                  small model at int4 and at nvfp4 (AdaLN modulation damped, see
                  checks.damp_modulation), card against CPU, and each modulation
                  linear alone; the undamped model's error and that of four wrong
                  modulations are reported (each wrong one must fail the
                  linear-level check). Then the small w4a8 model on the packed
                  route (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1),
                  default and turbo, card against CPU, launches exact. Then a
                  2-block Qwen-Image model (2 heads,
                  joint 320) through QwenImagePipeline with true CFG and padded
                  prompts at B 2, card against CPU: w4a8, int4 (damped, modulation
                  linears checked alone), int4 under fixed_softmax = False. Then
                  the small FLUX model under blocksparse 0.5 at w4a8 and int4
                  (damped) at S 1600 + 64, card against CPU, selections equal;
                  a small T5 (AWQ) and a small CLIP, card against CPU. Last, tiny
                  synthesized checkpoints loaded on the card and on the CPU (a
                  1 + 1-block FLUX nvfp4 file at w4a8, i.e. nvfp4-a8, and a 2-block
                  Qwen-Image int4 rank-128 file at w4a8): every buffer equal bit for
                  bit, 2-step latents within 2e-2. Then the small SDXL UNet (11
                  blocks, head dim 64) card against CPU: int4 one forward and 2
                  unguided steps (1e-1), int8 one forward (3e-2) and 2 CFG steps
                  (7e-2), launches exact. Last, the small SANA (2 blocks, dim
                  224, cross head dim 112, PAG on block 1) card against CPU:
                  int4 forward with and without PAG (4e-2), int8 2-step CFG
                  pipeline (4.5e-2), launches exact. Last, the small Z-Image
                  (dim 512, 4 blocks, its adaLN damped) card against CPU: int4,
                  int4 fused, nvfp4, w4a8 and w4a8 packed forwards within the
                  CPU tests' bounds, launches exact, and a 2-step int8 CFG
                  pipeline. Last, the image-conditioned requests on small
                  models card against CPU (reference_conditioning): a small
                  VAE's encode at 512px (flash_online in its mid block; max
                  2e-2 / mean 5e-3 of max |ref|), Kontext with a 240px
                  reference on the small turbo model with double_fb, Fill at
                  in_channels 384 (mask channels equal), Qwen-Image Edit-2509
                  with two references at B 2 (2e-2);
  5. slice     -- T5-XXL (AWQ W4A16, 24 layers) and CLIP-L from random weights;
                  full-width, full-depth FLUX.1-dev w4a8 (19 dual + 38 single
                  blocks, random weights from a seed) through FluxPipeline at
                  1024x1024: first the default configuration (one request of
                  min(3, --steps) steps, no VAE), then the same model switched to
                  the turbo configuration serves 2 requests of --steps steps (no
                  VAE), then bench.py's image path: the prompt's T5-XXL encode
                  from token ids inside each timed request (bench.py:159), the
                  full FLUX VAE (tiled decode) and cache="double_fb",
                  cache_hit_ratio=0.5, 2 requests
                  of --steps steps to (1, 1024, 1024, 3) images; one tiled and one
                  whole-image decode of the last latents are timed alone. Then the
                  w4a8 model is freed; [packed]: a new w4a8 model, the same
                  object on the dequant route and on the packed-int4 route (both
                  switches) in turns A B B A of min(3, --steps) steps, default
                  then turbo configuration, launches exact and peak memory per
                  run, then one turbo request of min(4, --steps) steps on the
                  packed route to an image through the tiled VAE. Then the int4
                  model (default configuration,
                  AWQ modulation) serves 2 requests of min(4, --steps) steps to
                  images through the tiled VAE, and the nvfp4 model 1 request of
                  min(2, --steps) steps to latents. Each path first runs one
                  untimed 1-step request (first-use work), then its counts are
                  reset; its launch counts must match the path (a cached request:
                  the misses' full forwards, the hits' dual and single block 0;
                  9 flash_online per tiled decode), the outputs must be finite
                  (images in [0, 1]); each path reports its peak memory.
  5a. kontext  -- image-conditioned FLUX on the slice's models: one 1024px
                  encode timed alone (one flash_online); on the w4a8 turbo
                  model the FLUX.1-Kontext request as bench.py serves its image
                  path (T5-XXL encode, double_fb 0.5, tiled decode) with a
                  1024px reference encoded inside the request, guidance 2.5,
                  min(4, --steps) steps, then a 1008px reference (3969
                  tokens) 1 step to latents; on the int4 model Kontext with
                  TeaCache ("flux-kontext", 0.6), min(8, --steps) steps to an
                  image (hits printed; a hit launches block 0's norm1 alone),
                  and the 1008px reference; then FLUX.1-Fill from a
                  synthesized Fill-layout file (int4, in_channels 384,
                  prepare_fill inside the request, min(2, --steps) steps to an
                  image) and Canny / Depth (in_channels 128 on the Fill blocks,
                  prepare_control inside, min(2, --steps) steps to latents).
                  Launch counts exact per forward, plus one flash_online per
                  encode.
  5b. flux-int8 -- the small 2 + 3-block int8 model on its stacks, card vs CPU
                  with the grouped and the per-token chain (2e-2, launches exact);
                  then FLUX.1-dev int8 at full width and depth on stacks
                  (bench.py --dense's configuration): one forward per chain
                  (grouped; NUNCHAKU_TPU_CHAIN_PTOKEN=1) in the default and the
                  turbo configuration, and one turbo request of min(4, --steps)
                  steps with the T5-XXL encode, cache="double_fb" at 0.5 and the
                  tiled VAE to an image; launch counts exact (76 stacked chain
                  producers and 76 consumers a forward).
  5c. rank128  -- FLUX.1-dev at full width with rank-128 low-rank branches in
                  the turbo configuration, depth cut to 2 dual + 4 single
                  blocks: one int8 and one w4a8 (dequant route) 1024px forward;
                  the LN and qkv/RoPE producers at R 128; output finite, launch
                  counts exact (the rows ln_mod_quant_int8_r128 and
                  qkv_rope_producer_r128 count these launches);
  5d. rank256  -- the same at rank 256: int8 (the chain kernels, the LN and
                  qkv/RoPE producers at R 256) and w4a8 on the packed route
                  (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1: the packed
                  GEMM and chain at R 256); the *_r256 rows count these
                  launches, the last-ops chain's at R 256 and zimage-r256's;
  6. highres  -- FLUX.1-dev int4 (default configuration) under
                  set_attention_impl("blocksparse", sparsity_ratio=0.5) at
                  2048x2048 from prompts: a stand-in tokenizer, T5-XXL + CLIP-L
                  inside each request, 2 requests of min(4, --steps) steps to
                  images through the tiled VAE (25 tiles); then 1-step requests:
                  block-sparse, block-sparse under fixed_softmax = False, dense.
                  Counts exact per forward (bs_fixed 57, gemm_w4a4_int4 228,
                  unsigned 76, gemv_awq 76; 25 flash_online per decode).
  7. qwen      -- after the FLUX models are freed, full-width, full-depth
                  Qwen-Image int4 (60 joint blocks, dim 3072, joint 3584, AWQ
                  modulation) at 1024x1024 through QwenImagePipeline: request A,
                  true CFG 4.0 at B 2 (prompts of 211 and 97 valid tokens padded to
                  211, negatives of 12), min(4, --steps) steps, decoded by the tiled
                  FLUX VAE; request D, the same model under fixed_softmax = False
                  (the online kernel's mask form), B 1, min(2, --steps) steps;
                  request B, after enable_fused_qkv_prep(), lightning-4step at B 1;
                  request C, cache="fb" (fn_blocks 8, threshold 0.12) with true CFG
                  at B 1, min(8, --steps) steps. Each request first runs untimed
                  once; its launch counts must be exact per forward (a cache hit
                  runs blocks 0-7 only).
  7a. qwen-edit -- between requests D and B, on the same model: Qwen-Image-Edit
                  with true CFG 4.0 over a padded prompt (150 of 211 tokens) at
                  B 1, a 1024px reference (frame 1) encoded inside, min(2,
                  --steps) steps to an image; Edit-2509's two 512px references
                  (frames 1, 2), 1 step; cache="fb" with the 1024px reference,
                  min(4, --steps) steps; each after an untimed 1-step run,
                  launch counts exact.
  8. checkpoint -- synthesized full-size files in a temporary directory
                  (removed at the end): FLUX.1-dev nvfp4 rank 32 (nunchaku's v1
                  schema, 19 + 38 blocks), T5-XXL TinyChat W4, CLIP-L and the FLUX
                  VAE. Each file's write and load time; the transformer at
                  precision="w4a8" (nvfp4-a8) serves one 1024px request from
                  prompt ids (min(4, --steps) steps, both encoders inside, tiled
                  decode), then one step each: nvfp4-a8, the same file at nvfp4,
                  and nvfp4-a8 after w4a8_cache_dequant(model, 4.0) (its block-0
                  fc1 codes equal to the dequant kernel's, its forward within 2e-2
                  of the undialed model's). Launch counts exact per forward (the
                  e2m1 dequant 304).
  9. checkpoint-qwen -- a synthesized Qwen-Image int4 rank-128 file (v2
                  schema, 60 blocks, dim 3072, joint 3584) loaded at int4 and at
                  w4a8, one B 1 step to latents each (the W4A4 GEMM, the chain
                  kernels at rank 128), and the w4a8 step once more on the
                  packed route (the packed kernels at rank 128), counts exact.
 10. sdxl     -- full-width, full-depth SDXL int4 (SDXLConfig(): 70 transformer
                  blocks, head dim 64) from random weights with the SDXL VAE
                  (latent 4, scaling 0.13025, tiled decode) through SDXLPipeline:
                  request A, 1024x1024, CFG 5.0 with negative embeddings,
                  min(4, --steps) of the default 30 steps, to images; request B,
                  the SDXL-Turbo preset (512x512, 4 steps, guidance 0), to
                  images; 2 timed requests each after an untimed one. Counts
                  exact per UNet forward (flash_online_d64 140, gemm_w4a4_int4
                  420; two forwards a CFG step; 9 flash_online per 1024px
                  decode, 1 at 512px).
 11. sana     -- full-width, full-depth SANA 1.6B int4 (SanaConfig(): 20
                  blocks, dim 2240, PAG projections on block 8) from random
                  weights, Gemma-2-2B at full size from random weights behind
                  a stand-in tokenizer (vocab 256000), and the DC-AE f32c32
                  from synthesize_dcae_state_dict(DCAEConfig()), through
                  SanaPipeline from prompts at 1024x1024: request A, CFG 4.5
                  (B 2), min(4, --steps) of the default 20 steps; B, PAG 2.0 +
                  CFG 4.5 (B 3), 2 steps; C, cache="fb" at guidance 1, min(8,
                  --steps) steps (hits read from the counts); D, a synthesized
                  svdq-int4_r32-sana1.6b file through load_sana_transformer,
                  one step; each to images, after an untimed run. Counts exact
                  per forward (flash_online_d112 20, gemm_w4a4_int4 120, plus 2
                  per PAG layer under PAG; a cache hit 1 and 6).
 12. zimage   -- Z-Image-Turbo's transformer at full width and depth (dim
                  3840, 30 + 2 + 2 blocks, 30 heads of 128, caption 2560) through
                  ZImagePipeline at 1024x1024 from prompt embeddings, its three
                  stacks held as (L, ...) tensors and every 4-bit linear reading
                  its layer by a device-resident index (the stacked modes):
                  request A, int4 r32 from random weights, the Turbo preset
                  (min(8, --steps) steps, guidance 0) to images through the tiled
                  FLUX VAE; B, after enable_fused_qkv_prep(), CFG 4.0 with
                  negative embeddings, 2 steps to latents; C, a synthesized
                  int4 r128 v2 file at int4, w4a8 and w4a8 under
                  NUNCHAKU_TPU_W4A8_XLA=0, 1 step each; D, a synthesized nvfp4
                  r32 file at nvfp4 and at w4a8 (which loads int8), 1 step each.
                  Counts exact per forward (136 stacked launches of the active
                  mode, 34 flash_fixed, 34 producers under B; 9 flash_online per
                  tiled decode).
 12b. zimage-r256 -- upstream's svdq-int4_r256-z-image-turbo layout at full
                  width and depth, synthesized, loaded at w4a8 and served on
                  the packed route (the configuration the port refused before
                  its kernels took ranks above 128): one 1-step request to
                  latents, 136 gemm_w4a8_stacked launches at R 256.
 13. sp       -- an NCCL process group of one rank (the machine has one card):
                  FLUX.1-dev w4a8 (default configuration) at 2048x2048 through
                  parallelize_sequence against the plain forward of the same
                  model (bit for bit), a 2-step request through the SP forward
                  to latents; Qwen-Image int4 and Z-Image-Turbo int4 at 1024px,
                  global txt_ids, SP forward against plain (bit for bit). Every
                  SP forward's attention is the ring's one step, the
                  denominator kernel: flash_fixed_denom 57 / 60 / 34 a forward.
 14. flux-attn -- FLUX.1-dev int8 on stacks, bf16 stream, unfused prologue:
                  one 1024px forward each with the default attention,
                  attn_kv_unroll = 2 (flash_fixed_unroll2 57) and attn_int8
                  (flash_fixed_i8 57), their distance from the default forward
                  within ATTN_TOL.
 15. last-ops -- the path to the four op-level kernels, their public entry
                  points (ln_mod_quant_int8_dual, svdq_gemm_w8a8_gelu_quant(...,
                  pipelined=True), qkv_prepare, flash_attention_bshd) chained as
                  a FLUX.1-dev single block's pieces meet, at full width (S
                  4608, dim 3072, 24 heads, fc1 12288, random int8 linears):
                  one launch of each, both ends within 2e-2 of the twins' chain,
                  at R 32 and again at R 256 (counted apart: the *_r256 rows).
                  Every earlier phase's count check reads 0 launches of these
                  four kernels (no model path changed).
 16. gemm-probes -- the path to the two GEMM probe kernels: the four ported
                  TPU probe tools (nunchaku_tpu_torch/tools: bench_gemm_variants,
                  probe_int8_mxu, probe_m512, tune_gemm_impl) once each at their
                  JAX scripts' sizes and iteration counts, every line logged;
                  every built instantiation launches, no other kernel but V3's
                  W4A4 GEMM; every model phase reads 0 probe launches.
 17. lora     -- LoRA on FLUX.1-dev at full width and depth, int4 (default
                  configuration) and w4a8 turbo: a synthesized rank-16 kohya
                  LoRA on every leaf of all 57 blocks (every low-rank branch R
                  48; the AWQ modulation's side branch rank 16) and the
                  composed pair of it and a rank-32 one at 0.5 (R 80), from
                  update_lora_params on the base model; each 3 timed 1024px
                  forwards in rounds with the base's: launch counts equal to the
                  base's, finite, moved by the LoRA; set_lora_strength(0)'s
                  distance from the base; the update / set times; one LoRA'd
                  Kontext request (int4, 1024px reference encoded inside,
                  min(2, --steps) steps to latents). Rows *_lora48 / *_lora80
                  count the rank-16 / pair models' forwards.
 18. offload  -- utils/offload.py at full size: FLUX.1-dev int4 resident
                  against OffloadedFluxForward at lookahead 1 and 2, timed in
                  rounds (outputs bit for bit, launches the resident's under the non-stacked
                  names, peak allocated below the resident's by at least the
                  block weights less lookahead + 1 blocks), a copy-only pass
                  (host-to-card GB/s), OffloadedCachedFluxForward (a miss bit
                  for bit the resident forward, then two hits); Qwen-Image
                  int4 (60 blocks) through OffloadedCachedQwenImageForward
                  (fn_blocks 8) against qwenimage_fb_cached_forward on the
                  resident model, 3 steps, outputs and hits equal.
FLUX and Qwen-Image hold their blocks as stacks, so their 4-bit GEMMs and
dequants count under the stacked modes' names (mode + "_stacked"); a kernel
row counts every launch of its mode, a *_stacked row the stacked ones alone
(row_launches).
The last lines are the kernels' JSON record, nvidia-smi's name and power limit,
and {"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import shutil
import sys
import time

import torch

# the card's peak rates, the least time they allow, the CUDA-event timer and the nvidia-smi line, shared with the
# port's probe tools
from nunchaku_tpu_torch.tools.probe_common import bound, nvidia_smi, time_ms
# the GEMV's bound and the device time a call from a CUDA graph, shared with the timing tool
from nunchaku_tpu_torch.tools.time_attention import GEMV_WEIGHTS, gemv_bound, graph_ms
# the W4A4 GEMM's bound and its k_bf yardstick (the bf16 probe on the decoded operands), shared with its timing tool
from nunchaku_tpu_torch.tools.time_w4a4 import decoded, k_bf_ms, w4a4_bound

# FLUX.1-dev at 1024x1024: 4096 image tokens, 512 text tokens
S_IMG, S_TXT, DIM, HEADS, HD, HID, RANK = 4096, 512, 3072, 24, 128, 12288, 32
# its VAE's mid-block attention: one head of 512 over a 64x64-latent tile or the whole 128x128 latent
VAE_D, VAE_TILE_S, VAE_WHOLE_S, VAE_TILES = 512, 64 * 64, 128 * 128, 9
# FLUX.1-Kontext at 1024x1024: a 1024px reference adds 4096 tokens (rope frame 1); a 1008px one 63 x 63 = 3969
KONTEXT_REF, KONTEXT_S_COND, ODD_REF, ODD_S_COND = 1024, 4096, 1008, 63 * 63
# Qwen-Image at 1024x1024: prompts padded to 211 tokens (211 and 97 valid), negatives of 12
QWEN_S_TXT, QWEN_VALID, QWEN_NEG = 211, (211, 97), 12
# FLUX.1-dev at 2048x2048 (examples/flux_highres_sparse.py): 16384 image + 512 text tokens, block-sparse
# attention at sparsity 0.5 over query blocks of 768 and kv blocks of 1536; 1536px as the ragged check
HR_SIZE, HR_S, HR_SPARSITY, HR_TILES, RAGGED_S = 2048, 16384 + 512, 0.5, 25, 9216 + 512
# the text encoders (bench.py:85-88): T5-XXL with AWQ W4A16 linears, CLIP-L (openai/clip-vit-large-patch14)
T5_XXL = dict(vocab=32128, d_model=4096, d_ff=10240, d_kv=64, heads=64, layers=24, quantized=True)
CLIP_L = dict(vocab=49408, d=768, heads=12, layers=12, max_pos=77)
T5_EOS, CLIP_EOS = 1, 2
# SDXL (SDXLConfig(): channels 320 / 640 / 1280, transformer layers 0 / 2 / 10, i.e. 70 blocks, head dim 64)
# at 1024px: level 1 attends over 64x64 = 4096 tokens at 10 heads (10 blocks), level 2 over 32x32 = 1024 at
# 20 heads (60 blocks), each block's cross-attention against 77 text tokens; the turbo preset at 512px
SDXL_D, SDXL_CTX, SDXL_TURBO = 64, 77, 512
SDXL_LEVELS = ((640, 10, 10), (1280, 20, 60))  # (width, heads, blocks) of the two attention levels
SDXL_VAE_TILES = {1024: 9, 512: 1}  # flash_online launches of a tiled decode at each size
# SANA 1.6B (SanaConfig(): dim 2240, 20 blocks, cross-attention 20 heads of 112) at 1024px: 32x32 = 1024 image
# tokens (DC-AE f32), prompts padded to 300 Gemma-2 tokens; CFG doubles the batch, CFG + PAG triples it
SANA_D, SANA_S, SANA_TXT, SANA_HEADS, SANA_DIM, SANA_HID = 112, 1024, 300, 20, 2240, 5600
SANA_PAG_LAYERS = (8,)
GEMMA_VOCAB, GEMMA_EOS = 256000, 1
# Z-Image-Turbo (the public Tongyi-MAI/Z-Image-Turbo transformer/config.json): dim 3840, 30 layers, 2 + 2 refiner
# layers, 30 heads of 128, caption features 2560 (the Qwen3-4B hidden size), axes (32, 48, 48), FFN 10240; at
# 1024px 4096 image tokens and prompts of 512 caption tokens (the joint stream 4608); the Turbo preset 8 steps,
# guidance 0, shift 3.0. 30 + 2 + 2 = 34 blocks of four 4-bit linears each
ZIMAGE = dict(dim=3840, num_layers=30, num_refiner_layers=2, num_attention_heads=30, in_channels=16, patch_size=2,
              cap_feat_dim=2560, axes_dims_rope=(32, 48, 48), norm_eps=1e-5)
ZI_DIM, ZI_CAP, ZI_HEADS = ZIMAGE["dim"], ZIMAGE["cap_feat_dim"], ZIMAGE["num_attention_heads"]
ZI_FFN, ZI_TXT, ZI_BLOCKS = 10240, 512, 34  # ZImageConfig.inner_ffn at dim 3840; caption tokens; 30 + 2 + 2
# the stacked mode each Z-Image precision's linears launch (int8: the layer's own weights, torch._int_mm)
ZI_MODES = {"int4": "gemm_w4a4_int4_stacked", "nvfp4": "gemm_w4a4_nvfp4_stacked", "w4a8": "dequant_w4a8_stacked",
            "w4a8 packed": "gemm_w4a8_stacked", "int8": None}
# sequence parallelism (examples/flux_multichip_sp.py): FLUX.1-dev w4a8 at 2048x2048 (16384 image + 512 text tokens,
# the default configuration) through parallelize_sequence on one rank of an NCCL group, Qwen-Image and Z-Image int4
# at 1024px through theirs; the in-process shard check splits the 2048px kv sequence into 4 shards of 4224
SP_SIZE, SP_S, SP_SHARDS, SP_STEPS = 2048, 16384 + 512, 4, 2
# FLUX.1-dev's two attention alternatives (tools/ablate_kv_unroll.py): int8 on stacks, bf16 stream, unfused prologue
ATTN_FORMS = {"default": ({}, "flash_fixed"), "kv_unroll2": ({"attn_kv_unroll": 2}, "flash_fixed_unroll2"),
              "int8": ({"attn_int8": True}, "flash_fixed_i8")}
# rel max distance from the default forward: twice the spread measured on the H100 (1.45e-2 and 1.80e-2: other sums
# and int8 logits move bf16 attention outputs by a step, and 57 blocks of int8 codes amplify the flips)
ATTN_TOL = {"kv_unroll2": 3e-2, "int8": 4e-2}
# the kernels on the Hopper attention core (csrc/flash_sm90.cuh): row -> (policy, head dim, form) of its
# instantiation flash_sm90_kernel<policy, D, form> (policy 0 fixed shift, 1 online; forms PLAIN 0, MASK 1, IDX 2,
# DENOM 3, U2 4, TOK 5, I8 6); the online D 128 plain form (FLUX under fixed_softmax = False) counts as flash_online
CORE_ROWS = {"flash_fixed": (0, 128, 0), "flash_fixed_masked": (0, 128, 1), "bs_fixed": (0, 128, 2),
             "flash_fixed_denom": (0, 128, 3), "flash_fixed_unroll2": (0, 128, 4), "flash_fixed_i8": (0, 128, 6),
             "flash_online_d64": (1, 64, 0), "flash_online_d112": (1, 112, 0), "flash_online (D 128)": (1, 128, 0),
             "flash_online_masked": (1, 128, 1), "bs_online": (1, 128, 2), "flash_online_bshd": (1, 128, 5)}
# the bf16 GEMM probe's instantiations of the GEMM main loop (csrc/gemm_sm90.cuh): its source in the demangled
# name (template arguments without casts, bools as 0 / 1) -> the row; Decoded<a form, w form, scaled> with forms
# 1 int8, 2 packed int4
PROBE_SASS = {"TmaBf16": "gemm_probe_bf16_bf16_bf16", "Decoded<1, 1, 0>": "gemm_probe_bf16_i8_i8",
              "Decoded<2, 2, 0>": "gemm_probe_bf16_p4_p4", "Decoded<1, 1, 1>": "gemm_probe_bf16_i8_i8_scaled",
              "Decoded<2, 1, 1>": "gemm_probe_bf16_p4_i8_scaled", "Decoded<2, 2, 1>": "gemm_probe_bf16_p4_p4_scaled"}
# sources whose every kernel must build without spills and without a ptxas "Potential Performance Loss" (C7512,
# C7515: wgmma serialized)
PTXAS_CLEAN = ("flash_fixed_i8.cu", "gemm_probe_bf16.cu", "flash_online.cu", "gemv_awq.cu", "gemm_w8a8_gelu_quant.cu",
               "gemm_w8a8_grouped.cu", "gemm_w4a4.cu", "gemm_w4a8.cu", "ln_mod_quant.cu", "qkv_rope_producer.cu",
               "dequant_w4a8.cu", "gemm_w8a8_gelu_quant_pipe.cu", "gemm_probe_i8.cu")
# the dequant's instantiations dequant_w4a8_kernel<e2m1> (rows 1, 1s, 1e): TMA loads and stores, and no type
# conversion (I2F, F2I) anywhere in them
DEQ_SASS = {0: "dequant_w4a8 (rows 1, 1s)", 1: "dequant_w4a8_e2m1 (row 1e)"}
# the LN producer's instantiations ln_mod_quant_kernel<vectors a lane (12: K 3072; 0: any K), dual, width>: register-A
# wgmma on TMA-fed stages (rows 6, 15)
LN_SASS = [(nv, dual, w) for nv in (0, 12) for dual in (0, 1) for w in (32, 64)]
# the qkv / RoPE producer's instantiations qkv_rope_kernel<k steps of the low-rank product>: 0 (R 0 and the prepare
# form, rows 7 at R 0 and 18: TMA-fed x tiles), 2 (R <= 32) and 8 (chunks of 128 ranks): wgmma on TMA-fed stages
QKV_SASS = (0, 2, 8)
# the qkv producer's dual-block calls (the image stream's 4096 rows, then the text stream's 512) as the earlier
# WMMA kernel ran them: ms a call back to back (tools/time_qkv.py rows 7:img, 7:txt; H100 80GB HBM3, 700 W)
ROW7_DUAL_BEFORE = (0.1404, 0.0396)
# the W4A4 GEMM's instantiations gemm_w4a4_kernel<mode, k steps of the rank-r term>: modes 0 int4, 1 int4 with
# unsigned activations, 2 nvfp4; 0 (no low rank), 2 (R <= 32), 8 (R <= 128) steps
W4A4_SASS = [(mode, steps) for mode in (0, 1, 2) for steps in (0, 2, 8)]
# the int8 chain kernels' s8 instantiations of the GEMM main loop: the epilogue in the demangled name (bools as
# 0 / 1) -> the rows that run it
CHAIN_SASS = {"GeluEpi": "gemm_w8a8_gelu_quant (rows 2, 2s, 13)", "GroupedEpi<0>": "gemm_w8a8_grouped (rows 3, 3s, 3p)",
              "GroupedEpi<1>": "gemm_w8a8_grouped_res (rows 3', 3's, 3p residual)"}
# the packed-int4 w4a8 kernels: gemm_sm90.cuh's warpgroup-0 decoding form gemm_w4_kernel<Epi> (W4Src), the same
# epilogues: the epilogue in the demangled name -> the rows that run it
W4_SASS = {"GeluEpi": "gemm_w4a8_gelu_quant (rows 12, 12s)", "GroupedEpi<0>": "gemm_w4a8 (rows 10, 11, 11s, 11g, 11gs)"}
# the wide online kernel (csrc/flash_online.cu, head dims 256 and 512: the VAE's mid-block attention): its
# instantiations flash_wide_kernel<D>, wgmma + TMA like the core
WIDE_DIMS = (256, 512)
# [rank128] / [rank256]: FLUX.1-dev at full width with rank-128 / rank-256 low-rank branches, depth cut to 2 dual +
# 4 single blocks (the kernels take ranks above 128 in chunks of 128: upstream's svdq-int4_r256-z-image-turbo)
R128_LAYERS = (2, 4)
RANK_HI = 256
# turbo launches of one FLUX w4a8 dual and one single block (the dequant route)
W4A8_TURBO_DUAL = {"dequant_w4a8_stacked": 8, "ln_mod_quant_int8": 4, "qkv_rope_producer": 2,
                   "gemm_w8a8_gelu_quant": 2, "gemm_w8a8_grouped_res": 2, "flash_fixed": 1}
W4A8_TURBO_SINGLE = {"dequant_w4a8_stacked": 4, "ln_mod_quant_int8": 2, "qkv_rope_producer": 1,
                     "gemm_w8a8_gelu_quant": 1, "gemm_w8a8_grouped_res": 1, "flash_fixed": 1}
PROMPTS = ("an aerial photograph of a coastal city at dawn", "a red bicycle leaning on a brick wall in the rain",
           "a bowl of ramen on a wooden table, studio light")


def row_launches(name: str, counts: dict) -> int:
    """A kernel row's launches: every launch of its mode, whether on a
    layer's own weight or on a stack (``name + "_stacked"``: the same
    kernel, its weight pointer moved), or at any of its tiles (``name +
    "@" + tile``: the int8 GEMM probe's instantiations); a ``*_stacked`` row
    counts the stacked launches alone."""
    return (counts.get(name, 0) + counts.get(name + "_stacked", 0)
            + sum(v for k, v in counts.items() if k.startswith(name + "@")))


def log(msg: str) -> None:
    print(msg, flush=True)


def deq_bytes(k, n, g=64):
    # packed codes, bf16 rescales of g-row groups -> int8 weight
    return k // 2 * n + 2 * (k // g) * n + k * n


def gemm_bytes(m, k, n, r, out_bytes):
    # qact, ascales, weight, wscales, lora_act, proj_up, bias -> output(s)
    return m * k + 4 * m + k * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n + out_bytes


def ln_bytes(m, k, r, batch=1):
    # x bf16, mod scale + shift f32, smooth, proj_down -> q int8, ascale, lora_act
    return 2 * m * k + 8 * batch * k + 2 * k + 2 * k * r + m * k + 4 * m + 4 * m * r


def rope_bytes(s, r=RANK):
    # qkv bf16, cos + sin f32, two norm weights, lora_act, proj_up -> q, k, v bf16
    n3 = 3 * HEADS * HD
    return 2 * s * n3 + 8 * s * HD + 4 * HD + 4 * s * r + 2 * r * n3 + 2 * s * n3


def res_bytes(m, n, batch, r2):
    # the residual operands: x, gate[, extra, extra_la, extra_pu]
    return 2 * m * n + 4 * batch * n + (2 * m * n + 4 * m * r2 + 2 * r2 * n if r2 else 0)


def w4a8_bytes(m, k, n, r=RANK, groups=1, out_bytes=None):
    # qact, ascales (groups, M), packed int4 weight, bf16 rescales of 64-row groups, wscales, lora_act,
    # proj_up, bias -> output(s) (bf16 (M, N) unless given)
    return (m * k + 4 * groups * m + k // 2 * n + 2 * (k // 64) * n + 4 * n + 4 * m * r + 2 * r * n + 2 * n
            + (2 * m * n if out_bytes is None else out_bytes))


def gelu_quant_out_bytes(m, n, r=RANK):
    # the producer's qout int8, qscales f32 per bn = 1536 columns, lora_next f32 (and rsmooth, proj_down read)
    return m * n + 4 * (n // 1536) * m + 4 * m * r + 4 * n + 2 * n * r


@contextlib.contextmanager
def switches(**values):
    """The JAX package's route switches set to ``values`` inside, as they
    were after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def packed_route():
    """The w4a8 route switches set to the packed-int4 route
    (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1)."""
    return switches(NUNCHAKU_TPU_W4A8_XLA="0", NUNCHAKU_TPU_W4A8_FUSED="1")


def chain_ptoken(on: bool):
    """The int8 chain's per-token switch (NUNCHAKU_TPU_CHAIN_PTOKEN) set."""
    return switches(NUNCHAKU_TPU_CHAIN_PTOKEN="1" if on else "0")


def bs_bound(idx, sq, skv, bq, bkv):
    """Least time of one block-sparse call with these ids (B, H, nq, kk):
    4 * D flop for each (query row, selected valid column) pair; q and the
    output once, the k and v rows of every block some query block selected
    once, the ids once."""
    b, h, nq, _ = idx.shape
    ids = idx.long().cpu()
    nk = -(-skv // bkv)
    rows = torch.clamp(sq - torch.arange(nq) * bq, max=bq)
    cols = torch.clamp(skv - torch.arange(nk) * bkv, max=bkv)
    flop = 4 * HD * int((rows[None, None, :, None] * cols[ids]).sum())
    used = torch.zeros((b, h, nk)).scatter_(-1, ids.reshape(b, h, -1), 1.0)
    kv_rows = int((used * cols).sum())
    return bound(2 * 2 * b * h * sq * HD + 2 * 2 * kv_rows * HD + 4 * idx.numel(), bf16_ops=flop)


def stand_in_tokenizer(vocab: int, eos: int):
    """A deterministic stand-in for a tokenizer (the repo holds no
    vocabulary): each word -> 3 + crc32(word) % (vocab - 3), then ``eos``,
    padded with 0 to ``max_length`` -> (B, max_length) int32 ids."""
    import zlib

    def tokenize(prompts, max_length):
        ids = torch.zeros((len(prompts), max_length), dtype=torch.int32)
        for i, p in enumerate(prompts):
            toks = [3 + zlib.crc32(w.encode()) % (vocab - 3) for w in p.split()][:max_length - 1] + [eos]
            ids[i, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
        return ids
    return tokenize


def kernel_phase(dev):
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import (
        flash_attention, flash_attention_online, flash_attention_online_plain, flash_attention_plain,
        qkv_rope_producer, qkv_rope_producer_plain)
    from nunchaku_tpu_torch.ops.gemm import (
        dequant_w4a8, dequant_w4a8_plain, gemm_w4a4, gemm_w4a4_plain, gemm_w8a8_grouped, gemm_w8a8_grouped_plain,
        gemm_w8a8_grouped_res, svdq_gemm_w8a8_gelu_quant, svdq_gemm_w8a8_gelu_quant_plain)
    from nunchaku_tpu_torch.ops.gemv import awq_dequant, awq_w4a16_linear, awq_w4a16_linear_plain
    from nunchaku_tpu_torch.ops.quantize import ln_mod_quant_int8, ln_mod_quant_int8_plain
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    rows = {}
    failed = []

    def record(name, source, replaces, shape, ok, err, detail, ms, plain_ms, bnd, lib_ms, k_bf=None, lowrank=None):
        # k_bf: the W4A4 rows' second yardstick, the bf16 GEMM probe on the decoded operands (key k_bf_ms);
        # lowrank: the qkv producer rows' yardstick for the low-rank product alone, torch.matmul(bf16(lora_act),
        # proj_up) (key lowrank_matmul_ms; not the same function, so library_ms stays null)
        bound_ms, bound_by = bnd
        log(f"[kernel] {name} @ {shape}: {'PASS' if ok else 'FAIL'} {detail}; "
            f"{ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}"
            f"{'' if k_bf is None else f', k_bf {k_bf:.4f} ms'}"
            f"{'' if lowrank is None else f', the low-rank product alone (torch.matmul) {lowrank:.4f} ms'}, "
            f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% of bound)")
        if not ok:
            failed.append(name)
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms, shape=shape)
        if k_bf is not None:
            rows[name]["k_bf_ms"] = k_bf
        if lowrank is not None:
            rows[name]["lowrank_matmul_ms"] = lowrank

    # 1. dequant: the fc1 weight (K 3072 -> N 12288)
    k, n = DIM, HID
    qw, rs = checks.dequant_case(k, n, device=dev)
    err, ok, detail = checks.check_dequant(qw, rs)
    record("dequant_w4a8", "nunchaku_tpu_torch/csrc/dequant_w4a8.cu", "nunchaku_tpu/ops/gemm.py:1074",
           f"K={k} N={n}", ok, err, detail,
           time_ms(lambda: dequant_w4a8(qw, rs), 50), time_ms(lambda: dequant_w4a8_plain(qw, rs), 5),
           bound(deq_bytes(k, n)), None)
    del qw, rs

    # 1e. the dequant's e2m1 form (nvfp4-a8): the fc1 weight (K 3072, N 12288) is the row; fc2's (K 12288,
    # N 3072) is checked and timed too
    res = {}
    for k2, n2 in ((DIM, HID), (HID, DIM)):
        qw, rs = checks.dequant_case(k2, n2, codes="e2m1", device=dev)
        res[k2] = (checks.check_dequant(qw, rs, "e2m1"), time_ms(lambda: dequant_w4a8(qw, rs, "e2m1"), 50),
                   time_ms(lambda: dequant_w4a8_plain(qw, rs, "e2m1"), 5), bound(deq_bytes(k2, n2, 16)))
        del qw, rs
    (err2, ok2, detail2), ms2, plain2, bnd2 = res[HID]
    log(f"[kernel] dequant_w4a8_e2m1 @ K={HID} N={DIM}: {'PASS' if ok2 else 'FAIL'} {detail2}; {ms2:.4f} ms "
        f"(plain {plain2:.4f} ms, bound {bnd2[0]:.4f} ms by {bnd2[1]}, {100 * bnd2[0] / ms2:.1f}% of bound)")
    (err, ok, detail), ms, plain, bnd = res[DIM]
    record("dequant_w4a8_e2m1", "nunchaku_tpu_torch/csrc/dequant_w4a8.cu", "nunchaku_tpu/ops/gemm.py:1074",
           f"K={DIM} N={HID} e2m1", ok and ok2, max(err, err2), detail + f"; K {HID} N {DIM}: {detail2}",
           ms, plain, bnd, None)

    # 2. GELU -> requantize producer: single-block fc1 (M 4608, K 3072, N 12288)
    m, k, n = S_IMG + S_TXT, DIM, HID
    args = checks.gelu_quant_case(m, k, n, RANK, device=dev)
    err, ok, detail = checks.check_gelu_quant(*args)
    qa, w = args[0], args[2]
    nj = n // 1536
    record("gemm_w8a8_gelu_quant", "nunchaku_tpu_torch/csrc/gemm_w8a8_gelu_quant.cu",
           "nunchaku_tpu/ops/gemm.py:460", f"M={m} K={k} N={n} R={RANK}", ok, err, detail,
           time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*args), 20),
           time_ms(lambda: svdq_gemm_w8a8_gelu_quant_plain(*args), 3),
           bound(gemm_bytes(m, k, n, RANK, m * n + 4 * nj * m + 4 * m * RANK) + 4 * n + 2 * n * RANK,
                 2 * m * n * k, 4 * m * n * RANK),
           time_ms(lambda: int8_matmul(qa, w), 20))
    del args, qa, w

    # 3. grouped consumer: single-block fc2 (M 4608, K 12288 in 8 groups, N 3072)
    m, k, n, g = S_IMG + S_TXT, HID, DIM, HID // 1536
    args = checks.grouped_case(m, k, n, g, RANK, device=dev)
    err, ok, detail = checks.check_grouped(*args)
    qa, w = args[0], args[2]
    record("gemm_w8a8_grouped", "nunchaku_tpu_torch/csrc/gemm_w8a8_grouped.cu",
           "nunchaku_tpu/ops/gemm.py:344", f"M={m} K={k} N={n} G={g} R={RANK}", ok, err, detail,
           time_ms(lambda: gemm_w8a8_grouped(*args), 20), time_ms(lambda: gemm_w8a8_grouped_plain(*args), 3),
           bound(gemm_bytes(m, k, n, RANK, 2 * m * n) + 4 * g * m, 2 * m * n * k, 2 * m * n * RANK),
           time_ms(lambda: int8_matmul(qa, w), 20))
    del args, qa, w

    # 4. fixed-shift flash: the joint sequence, 24 heads of 128
    s = S_IMG + S_TXT
    q, kk, v = checks.flash_case(1, HEADS, s, s, HD, device=dev)
    err, ok, detail = checks.check_flash(q, kk, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    record("flash_fixed", "nunchaku_tpu_torch/csrc/flash_fixed.cu", "nunchaku_tpu/ops/attention.py:403",
           f"B=1 H={HEADS} S={s} D={HD}", ok, err, detail,
           time_ms(lambda: flash_attention(q, kk, v), 20),
           time_ms(lambda: flash_attention_plain(q, kk, v), 3),
           bound(4 * s * HEADS * HD * 2, bf16_ops=4 * s * s * HD * HEADS),
           time_ms(lambda: sdpa(q, kk, v, scale=math.log(2.0)), 20))
    del q, kk, v

    # 5. LN + modulate + quantize producer: a single block's (M 4608, K 3072, R 32) is the row; the dual
    # block's image (M 4096) and text (M 512) streams are checked and timed too
    k = DIM
    for m in (S_TXT, S_IMG, S_IMG + S_TXT):
        args = checks.ln_mod_quant_case(1, m, k, RANK, device=dev)
        err, ok, detail = checks.check_ln_mod_quant(*args)
        x = args[0]
        ms = time_ms(lambda: ln_mod_quant_int8(*args), 50)
        bnd = bound(ln_bytes(m, k, RANK), bf16_ops=2 * m * k * RANK)
        if m == S_IMG + S_TXT:
            record("ln_mod_quant_int8", "nunchaku_tpu_torch/csrc/ln_mod_quant.cu", "nunchaku_tpu/ops/quantize.py:149",
                   f"M={m} K={k} R={RANK}", ok, err, detail, ms, time_ms(lambda: ln_mod_quant_int8_plain(*args), 5),
                   bnd, time_ms(lambda: torch.nn.functional.layer_norm(x, (k,), eps=1e-6), 50))
        else:
            log(f"[kernel] ln_mod_quant_int8 @ M={m} K={k} R={RANK}: {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms "
                f"(F.layer_norm {time_ms(lambda: torch.nn.functional.layer_norm(x, (k,), eps=1e-6), 50):.4f} ms, "
                f"bound {bnd[0]:.4f} ms by {bnd[1]})")
            if not ok:
                failed.append(f"ln_mod_quant_int8@M{m}")
        del args, x

    # 6. qkv / RoPE producer with the low-rank term: the single block's call
    # (S 4608) is the timed row; the dual block's two shared-buffer calls
    # (4096 img rows at 512, then 512 txt rows at 0) are checked and each timed
    # beside the earlier kernel's time
    streams, cos, sin = checks.qkv_rope_case(1, (S_TXT, S_IMG), HEADS, HD, RANK, device=dev)
    err2, ok2, detail2 = checks.check_qkv_rope(streams, cos, sin)
    out = tuple(torch.empty((1, HEADS, S_TXT + S_IMG, HD), dtype=torch.bfloat16, device=dev) for _ in range(3))
    each = []
    for qkv, nq, nk, la, pu, off in streams:
        s = qkv.shape[1]
        c, sn = cos[off:off + s], sin[off:off + s]
        each.append(time_ms(lambda: qkv_rope_producer(qkv, c, sn, nq, nk, lora_act=la, proj_up=pu, out=out,
                                                      s_offset=off), 50))
    log(f"[kernel] qkv_rope_producer, dual block (S_img {S_IMG} at row {S_TXT}, then S_txt {S_TXT} at row 0, one "
        f"buffer): {'PASS' if ok2 else 'FAIL'} {detail2}; image call {each[0]:.4f} ms (earlier kernel "
        f"{ROW7_DUAL_BEFORE[0]:.4f}), text call {each[1]:.4f} ms (earlier {ROW7_DUAL_BEFORE[1]:.4f}), bounds "
        f"{bound(rope_bytes(S_IMG))[0]:.4f} / {bound(rope_bytes(S_TXT))[0]:.4f} ms")
    del out
    del streams, cos, sin
    s = S_IMG + S_TXT
    streams, cos, sin = checks.qkv_rope_case(1, (s,), HEADS, HD, RANK, device=dev)
    err, ok, detail = checks.check_qkv_rope(streams, cos, sin)
    qkv, la, pu = streams[0][0], streams[0][3], streams[0][4]
    la16 = la.to(torch.bfloat16)
    record("qkv_rope_producer", "nunchaku_tpu_torch/csrc/qkv_rope_producer.cu",
           "nunchaku_tpu/ops/attention.py:158", f"B=1 S={s} H={HEADS} D={HD} R={RANK}", ok and ok2,
           max(err, err2), detail + f"; dual block: {detail2}",
           time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer, streams, cos, sin), 50),
           time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer_plain, streams, cos, sin), 5),
           bound(rope_bytes(s), bf16_ops=2 * s * 3 * HEADS * HD * RANK), None,
           lowrank=time_ms(lambda: torch.matmul(la16, pu), 50))
    del streams, cos, sin, qkv, la, pu, la16
    producer_rank_rows(dev, record, failed)

    # 3'. grouped consumer, gated-residual mode with extra and extra low-rank:
    # single-block fc2 (M 4608, K 12288 in 8 groups, N 3072)
    m, k, n, g = S_IMG + S_TXT, HID, DIM, HID // 1536
    args = checks.grouped_res_case(m, k, n, g, RANK, device=dev)
    err, ok, detail = checks.check_grouped_res(*args)
    qa, w = args[0], args[2]
    record("gemm_w8a8_grouped_res", "nunchaku_tpu_torch/csrc/gemm_w8a8_grouped.cu",
           "nunchaku_tpu/ops/gemm.py:395", f"M={m} K={k} N={n} G={g} R={RANK} +x,gate,extra,extra_lora",
           ok, err, detail,
           time_ms(lambda: gemm_w8a8_grouped_res(*args), 20),
           time_ms(lambda: gemm_w8a8_grouped_plain(*args), 3),
           bound(gemm_bytes(m, k, n, RANK, 2 * m * n) + 4 * g * m + res_bytes(m, n, 1, RANK),
                 2 * m * n * k, 4 * m * n * RANK),
           time_ms(lambda: int8_matmul(qa, w), 20))
    del args, qa, w

    # 2', 3' at rank 128 (nunchaku's rank-128 checkpoints): the same FLUX fc1 / fc2 shapes, logged beside the
    # rank-32 rows
    m = S_IMG + S_TXT
    for name, (k, n), case, check, fn, plain_fn in (
            ("gemm_w8a8_gelu_quant", (DIM, HID), checks.gelu_quant_case, checks.check_gelu_quant,
             svdq_gemm_w8a8_gelu_quant, svdq_gemm_w8a8_gelu_quant_plain),
            ("gemm_w8a8_grouped", (HID, DIM), lambda m_, k_, n_, r_, device: checks.grouped_case(
                m_, k_, n_, HID // 1536, r_, device=device), checks.check_grouped, gemm_w8a8_grouped,
             gemm_w8a8_grouped_plain)):
        args = case(m, k, n, 128, device=dev)
        _, ok2, detail = check(*args)
        ms = time_ms(lambda: fn(*args), 20)
        plain = time_ms(lambda: plain_fn(*args), 3)
        if name == "gemm_w8a8_gelu_quant":
            bnd = bound(gemm_bytes(m, k, n, 128, m * n + 4 * (n // 1536) * m + 4 * m * 128) + 4 * n + 2 * n * 128,
                        2 * m * n * k, 4 * m * n * 128)
        else:
            bnd = bound(gemm_bytes(m, k, n, 128, 2 * m * n) + 4 * (HID // 1536) * m, 2 * m * n * k, 2 * m * n * 128)
        log(f"[kernel] {name} @ M={m} K={k} N={n} R=128: {'PASS' if ok2 else 'FAIL'} {detail}; {ms:.4f} ms "
            f"(plain {plain:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
        if not ok2:
            failed.append(f"{name}@R128")
        del args

    packed_kernel_rows(dev, record, failed)

    # 8. online flash: the VAE mid block of one 64x64-latent tile (S 4096, one
    # head of 512); also checked at a whole 1024px image's S 16384 and a ragged S
    s = VAE_TILE_S
    q, kk, v = checks.flash_online_case(1, 1, s, s, VAE_D, device=dev)
    err, ok, detail = checks.check_flash_online(q, kk, v)
    for s2 in (VAE_WHOLE_S, 1000):
        args = checks.flash_online_case(1, 1, s2, s2, VAE_D, seed=1, device=dev)
        err2, ok2, detail2 = checks.check_flash_online(*args)
        extra = ""
        if s2 == VAE_WHOLE_S:
            extra = (f"; {time_ms(lambda: flash_attention_online(*args), 5):.4f} ms (plain "
                     f"{time_ms(lambda: flash_attention_online_plain(*args), 1, warmup=1):.4f} ms, SDPA "
                     f"{time_ms(lambda: sdpa(*args, scale=1 / math.sqrt(VAE_D)), 5):.4f} ms, bound "
                     f"{bound(4 * s2 * VAE_D * 2, bf16_ops=4 * s2 * s2 * VAE_D)[0]:.4f} ms)")
        log(f"[kernel] flash_online @ B=1 H=1 S={s2} D={VAE_D}: {'PASS' if ok2 else 'FAIL'} {detail2}{extra}")
        ok, err = ok and ok2, max(err, err2)
        del args
    # the wide kernel's D 256 instantiation (no model path at this head dim): checked and timed at a tile's S
    args = checks.flash_online_case(1, 1, s, s, 256, seed=2, device=dev)
    err2, ok2, detail2 = checks.check_flash_online(*args)
    log(f"[kernel] flash_online @ B=1 H=1 S={s} D=256: {'PASS' if ok2 else 'FAIL'} {detail2}; "
        f"{time_ms(lambda: flash_attention_online(*args), 50):.4f} ms (SDPA "
        f"{time_ms(lambda: sdpa(*args, scale=1 / 16), 50):.4f} ms, bound "
        f"{bound(4 * s * 256 * 2, bf16_ops=4 * s * s * 256)[0]:.4f} ms)")
    ok, err = ok and ok2, max(err, err2)
    del args
    record("flash_online", "nunchaku_tpu_torch/csrc/flash_online.cu", "nunchaku_tpu/ops/attention.py:607",
           f"B=1 H=1 S={s} D={VAE_D}", ok, err, detail,
           time_ms(lambda: flash_attention_online(q, kk, v), 50),
           time_ms(lambda: flash_attention_online_plain(q, kk, v), 3),
           bound(4 * s * VAE_D * 2, bf16_ops=4 * s * s * VAE_D),
           time_ms(lambda: sdpa(q, kk, v, scale=1 / math.sqrt(VAE_D)), 50))
    del q, kk, v

    # 11. the kv-mask forms of both flash kernels: Qwen-Image's joint
    # sequence at B 2, batch row 1 keeping 97 of its 211 text keys
    from nunchaku_tpu_torch.ops.attention import kv_bias

    b, s = 2, QWEN_S_TXT + S_IMG
    q, kk, v, mask = checks.flash_masked_case(b, HEADS, QWEN_S_TXT, S_IMG, QWEN_VALID, device=dev)
    nat = (kv_bias(mask, b, s) * math.log(2.0)).to(torch.bfloat16)[:, None, None, :]  # the mask in nats
    lib_ms = time_ms(lambda: sdpa(q, kk, v, attn_mask=nat, scale=math.log(2.0)), 20)
    for name, online, src, line in (("flash_fixed_masked", False, "flash_fixed.cu", 403),
                                    ("flash_online_masked", True, "flash_online.cu", 607)):
        err, ok, detail = checks.check_flash_masked(q, kk, v, mask, online)
        record(name, f"nunchaku_tpu_torch/csrc/{src}", f"nunchaku_tpu/ops/attention.py:{line}",
               f"B={b} H={HEADS} S={s} (S_txt {QWEN_S_TXT}, valid {QWEN_VALID}) D={HD} mask", ok, err, detail,
               time_ms(lambda: checks.run_flash_masked(q, kk, v, mask, online), 20),
               time_ms(lambda: checks.run_flash_masked(q, kk, v, mask, online, plain=True), 3),
               bound(4 * b * s * HEADS * HD * 2 + 4 * b * s, bf16_ops=4 * b * HEADS * s * s * HD), lib_ms)
    del q, kk, v, mask, nat
    torch.cuda.empty_cache()

    # 9. W4A4 GEMM, one row per mode: single-block fc1 (M 4608, K 3072, N
    # 12288) for int4 and nvfp4, single-block fc2 (K 12288, N 3072) for the
    # unsigned post-GELU activations of int4
    for name, (m, k, n), precision, unsigned in (
            ("gemm_w4a4_int4", (S_IMG + S_TXT, DIM, HID), "int4", False),
            ("gemm_w4a4_int4_unsigned", (S_IMG + S_TXT, HID, DIM), "int4", True),
            ("gemm_w4a4_nvfp4", (S_IMG + S_TXT, DIM, HID), "nvfp4", False)):
        args, kw = checks.w4a4_case(m, k, n, precision, unsigned, device=dev)
        err, ok, detail = checks.check_w4a4(args, kw)
        g = 16 if precision == "nvfp4" else 64
        a16, w16 = decoded(args, kw)
        record(name, "nunchaku_tpu_torch/csrc/gemm_w4a4.cu", "nunchaku_tpu/ops/gemm.py:125",
               f"M={m} K={k} N={n} R={RANK} {precision}{' unsigned' if unsigned else ''}", ok, err, detail,
               time_ms(lambda: gemm_w4a4(*args, **kw), 20), time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3),
               w4a4_bound(m, k, n, g), time_ms(lambda: torch.matmul(a16, w16), 20), k_bf_ms(a16, w16))
        del args, a16, w16
    # the int4 modes at rank 128 on Qwen-Image's shapes (4096 image rows; qkv, fc2 with unsigned activations)
    for (m, k, n), unsigned in (((S_IMG, DIM, 3 * DIM), False), ((S_IMG, HID, DIM), True)):
        args, kw = checks.w4a4_case(m, k, n, "int4", unsigned, r=128, device=dev)
        _, ok2, detail = checks.check_w4a4(args, kw)
        ms = time_ms(lambda: gemm_w4a4(*args, **kw), 20)
        plain = time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3)
        a16, w16 = decoded(args, kw)
        lib = time_ms(lambda: torch.matmul(a16, w16), 20)
        bnd = w4a4_bound(m, k, n, 64, r=128)
        name = "gemm_w4a4_int4" + ("_unsigned" if unsigned else "")
        log(f"[kernel] {name} @ M={m} K={k} N={n} R=128 (Qwen-Image r128): {'PASS' if ok2 else 'FAIL'} {detail}; "
            f"{ms:.4f} ms (plain {plain:.4f} ms, library {lib:.4f} ms, k_bf {k_bf_ms(a16, w16):.4f} ms, bound "
            f"{bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
        if not ok2:
            failed.append(f"{name}@R128")
        del args, a16, w16

    # 10. AWQ GEMV: the dual block's AdaLN modulation (M 1, K 3072, N 18432),
    # also checked and timed at the single block's N 9216
    timed = {}
    for n in (6 * DIM, 3 * DIM):
        args = checks.awq_case(1, DIM, n, device=dev)
        w16 = awq_dequant(*args[1:4])
        timed[n] = (checks.check_awq(*args), time_ms(lambda: awq_w4a16_linear(*args), 200),
                    time_ms(lambda: awq_w4a16_linear_plain(*args), 20), gemv_bound(1, DIM, n),
                    time_ms(lambda: torch.matmul(args[0], w16), 200))
        del args, w16
    (err2, ok2, detail2), ms2, plain2, bnd2, lib2 = timed[3 * DIM]
    log(f"[kernel] gemv_awq @ M=1 K={DIM} N={3 * DIM}: {'PASS' if ok2 else 'FAIL'} {detail2}; {ms2:.4f} ms "
        f"(plain {plain2:.4f} ms, library {lib2:.4f} ms, bound {bnd2[0]:.4f} ms by {bnd2[1]})")
    # the device time a call, without the host's pace: a CUDA graph of 100 calls over four weights (each read
    # from device memory, not L2), at both N and at M 2 (Qwen-Image's CFG batch)
    for m, n in ((1, 6 * DIM), (1, 3 * DIM), (2, 6 * DIM)):
        cases = [checks.awq_case(m, DIM, n, seed=i, device=dev) for i in range(GEMV_WEIGHTS)]
        dev_ms = graph_ms([lambda c=cases[i % GEMV_WEIGHTS]: awq_w4a16_linear(*c) for i in range(100)])
        bnd_m = gemv_bound(m, DIM, n)[0]
        log(f"[kernel] gemv_awq @ M={m} K={DIM} N={n}: device {dev_ms:.4f} ms a call (graph of 100 calls), "
            f"{100 * bnd_m / dev_ms:.1f}% of its {bnd_m:.4f} ms bound")
        del cases
    (err, ok, detail), ms, plain, bnd, lib = timed[6 * DIM]
    record("gemv_awq", "nunchaku_tpu_torch/csrc/gemv_awq.cu", "nunchaku_tpu/ops/gemv.py:25",
           f"M=1 K={DIM} N={6 * DIM}", ok and ok2, max(err, err2), detail + f"; N {3 * DIM}: {detail2}",
           ms, plain, bnd, lib)
    torch.cuda.empty_cache()
    bs_kernel_rows(dev, record)
    sdxl_kernel_rows(dev, record, failed)
    sana_kernel_rows(dev, record, failed)
    zimage_kernel_rows(dev, record, failed)
    flux_int8_kernel_rows(dev, record, failed)
    flux_int8_kernel_rows(dev, record, failed, RANK_HI, R256_CHAIN_MODES, f"_r{RANK_HI}")
    fixed_form_kernel_rows(dev, record, failed)
    last_op_kernel_rows(dev, record, failed)
    probe_kernel_rows(dev, record, failed)
    conditioning_kernel_checks(dev, failed)
    lora_kernel_rows(dev, record)
    return rows, failed


def producer_rank_rows(dev, record, failed):
    """6r, 7r. The LN producer and the qkv/RoPE producer at rank 128
    (nunchaku's rank-128 checkpoints) and 256 (upstream's r256 Z-Image
    checkpoint; the kernels run ranks above 128 in chunks of 128) at
    FLUX.1-dev's shapes (M 4608, K 3072; S 4608, H 24, D 128): each within
    its rank-32 row's bounds of the twin and bit for bit its rank-32 launch
    on the shared columns (checks.check_ln_rank, check_qkv_rank; the qkv
    producer's rank 128 zero-padded to 256 bit for bit rank 128 too),
    F.layer_norm / the low-rank matmul as yardstick; R 48 checked and
    logged; the dual producer at R 128 + 128 (each head bit for bit a
    single-mode launch) logged beside two rank-128 row-6 launches, and at
    256 + 256 a row of its own."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import qkv_rope_producer, qkv_rope_producer_plain
    from nunchaku_tpu_torch.ops.quantize import (ln_mod_quant_int8, ln_mod_quant_int8_dual,
                                                 ln_mod_quant_int8_dual_plain, ln_mod_quant_int8_plain)

    m = s = S_IMG + S_TXT
    for r in (48, 128, RANK_HI):
        args = checks.ln_mod_quant_case(1, m, DIM, r, device=dev)
        err, ok, detail = checks.check_ln_rank(*args)
        ms = time_ms(lambda: ln_mod_quant_int8(*args), 50)
        bnd = bound(ln_bytes(m, DIM, r), bf16_ops=2 * m * DIM * r)
        if r >= 128:
            x = args[0]
            record(f"ln_mod_quant_int8_r{r}", "nunchaku_tpu_torch/csrc/ln_mod_quant.cu",
                   "nunchaku_tpu/ops/quantize.py:149", f"M={m} K={DIM} R={r}", ok, err, detail, ms,
                   time_ms(lambda: ln_mod_quant_int8_plain(*args), 5), bnd,
                   time_ms(lambda: torch.nn.functional.layer_norm(x, (DIM,), eps=1e-6), 50))
        else:
            log(f"[kernel] ln_mod_quant_int8 @ M={m} K={DIM} R={r}: {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms "
                f"(bound {bnd[0]:.4f} ms by {bnd[1]})")
            if not ok:
                failed.append(f"ln_mod_quant_int8@R{r}")
        del args

    for r in (128, RANK_HI):
        args = checks.ln_dual_case(1, m, DIM, r, r, device=dev)
        err, ok, detail = checks.check_ln_dual(*args)
        x, sc, sh, sma, pda, smb, pdb = args
        ms = time_ms(lambda: ln_mod_quant_int8_dual(*args), 50)
        two = time_ms(lambda: (ln_mod_quant_int8(x, sc, sh, sma, pda), ln_mod_quant_int8(x, sc, sh, smb, pdb)), 50)
        plain = time_ms(lambda: ln_mod_quant_int8_dual_plain(*args), 5)
        bnd = bound(dual_bytes(m, DIM, r, r), bf16_ops=2 * m * DIM * 2 * r)
        log(f"[kernel] ln_mod_quant_dual @ B=1 S={m} K={DIM} R={r}+{r}: {'PASS' if ok else 'FAIL'} {detail}; "
            f"{ms:.4f} ms against two rank-{r} row-6 launches {two:.4f} ms (plain {plain:.4f} ms, bound {bnd[0]:.4f} "
            f"ms by {bnd[1]})")
        if r == RANK_HI:
            record(f"ln_mod_quant_dual_r{r}", "nunchaku_tpu_torch/csrc/ln_mod_quant.cu",
                   "nunchaku_tpu/ops/quantize.py:265", f"B=1 S={m} K={DIM} R={r}+{r}", ok, err, detail, ms, plain,
                   bnd, time_ms(lambda: torch.nn.functional.layer_norm(x, (DIM,), eps=1e-6), 50))
        elif not ok:
            failed.append(f"ln_mod_quant_dual@R{r}")
        del args, x, sc, sh, sma, pda, smb, pdb

    for r in (48, 128, RANK_HI):
        streams, cos, sin = checks.qkv_rope_case(1, (s,), HEADS, HD, r, device=dev)
        err, ok, detail = checks.check_qkv_rank(streams, cos, sin)
        if r > 128:
            _, ok128, detail128 = checks.check_qkv_rank(streams, cos, sin, r_small=128)
            ok, detail = ok and ok128, f"{detail}; {detail128.split('; ')[-1]}"
        ms = time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer, streams, cos, sin), 50)
        bnd = bound(rope_bytes(s, r), bf16_ops=2 * s * 3 * HEADS * HD * r)
        if r >= 128:
            la16, pu = streams[0][3].to(torch.bfloat16), streams[0][4]
            record(f"qkv_rope_producer_r{r}", "nunchaku_tpu_torch/csrc/qkv_rope_producer.cu",
                   "nunchaku_tpu/ops/attention.py:158", f"B=1 S={s} H={HEADS} D={HD} R={r}", ok, err, detail, ms,
                   time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer_plain, streams, cos, sin), 5), bnd, None,
                   lowrank=time_ms(lambda: torch.matmul(la16, pu), 50))
            del la16, pu
        else:
            log(f"[kernel] qkv_rope_producer @ B=1 S={s} H={HEADS} D={HD} R={r}: {'PASS' if ok else 'FAIL'} {detail}; "
                f"{ms:.4f} ms (bound {bnd[0]:.4f} ms by {bnd[1]})")
            if not ok:
                failed.append(f"qkv_rope_producer@R{r}")
        del streams, cos, sin


def rank_phase(dev, rank=128):
    """[rank128] / [rank256] FLUX.1-dev at full width (dim 3072, 24 heads)
    with rank-``rank`` low-rank branches in the turbo configuration, depth
    cut to R128_LAYERS (the kernels' work per block does not depend on the
    depth): one 1024px forward at int8 (the chain kernels on stacks) and one
    at w4a8, each untimed once first; the LN producer and the qkv/RoPE
    producer run at the rank. At rank 128 w4a8 takes the dequant route; at
    256 the packed route (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1:
    the packed GEMM and chain at rank 256, refused before the kernels ran
    ranks above 128 in chunks). Output finite, launch counts exact. -> (ok,
    counts of the timed forwards, per-forward counts)."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    L, Ls = R128_LAYERS
    tag = f"rank{rank}"
    ok, total, paths = True, {}, {}
    for precision in ("int8", "w4a8"):
        packed = precision == "w4a8" and rank > 128
        cfg = FluxConfig(precision=precision, rank=rank, num_layers=L, num_single_layers=Ls)
        model = FluxTransformer2DModel.random_init(cfg, seed=16, device=dev)
        model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        key = f"{precision}{' packed' if packed else ''} r{rank} turbo"
        if precision == "int8":
            paths[key] = int8_per_forward(L, Ls, True, False)
        elif packed:
            paths[key] = packed_per_forward(L, Ls, True)
        else:
            paths[key] = {k: L * W4A8_TURBO_DUAL[k] + Ls * W4A8_TURBO_SINGLE[k] for k in W4A8_TURBO_DUAL}
        gen = torch.Generator(device=dev).manual_seed(17)
        inputs = (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                  torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
                  torch.tensor([1.0], device=dev), make_img_ids(math.isqrt(S_IMG), math.isqrt(S_IMG), dev),
                  torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))
        with torch.no_grad(), packed_route() if packed else contextlib.nullcontext():
            model(*inputs)  # first use, untimed
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = model(*inputs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        finite = tuple(out.shape) == (1, S_IMG, 64) and bool(torch.isfinite(out.float()).all())
        log(f"[{tag}] FLUX.1-dev {precision}{' (packed route)' if packed else ''} rank {rank}, turbo, {L} dual + "
            f"{Ls} single blocks at dim {cfg.dim}: one 1024px forward {dt:.4f} s, output {tuple(out.shape)} "
            f"finite={finite}")
        ok = check_counts(key, counts, paths[key], 1, tag=tag) and finite and ok
        del model, out
        torch.cuda.empty_cache()
    return ok, total, paths


def zimage_r256_phase(dev):
    """[zimage-r256] The configuration the port refused before its kernels
    ran ranks above 128: upstream's svdq-int4_r256-z-image-turbo layout
    (synth_checkpoint.zimage_state at Z-Image-Turbo's full width and depth,
    34 blocks, dim 3840, rank 256, v2 schema), loaded at w4a8 and served on
    the packed route (NUNCHAKU_TPU_W4A8_XLA=0: every 4-bit linear the packed
    GEMM's stacked rank-1 mode at R 256) through ZImagePipeline at 1024x1024
    from prompt embeddings, one untimed 1-step request, then one timed, to
    latents. Latents finite, launch counts exact. The file lives in a
    temporary directory, deleted after. -> (ok, counts, per-forward
    counts)."""
    import tempfile

    from nunchaku_tpu_torch import ZImagePipeline, load_zimage_transformer
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    t_phase = time.perf_counter()
    name = f"svdq-int4_r{RANK_HI}-z-image-turbo"
    key = "zimage r256 w4a8 packed"
    per = zimage_per_forward(ZI_MODES["w4a8 packed"])
    gen = torch.Generator(device=dev).manual_seed(8)
    pe = torch.randn((1, ZI_TXT, ZI_CAP), generator=gen, device=dev).to(torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="nunchaku_zimage_r256_") as tmp:
        path = f"{tmp}/{name}.safetensors"
        _write(synth, path, lambda: synth.zimage_state(rank=RANK_HI, precision="int4", seed=6, device=dev),
               f"{name} (v2 schema)", tag="zimage-r256")
        model, _ = _load(f"{name} at precision='w4a8'", lambda: load_zimage_transformer(path, precision="w4a8",
                                                                                        device=dev),
                         tag="zimage-r256")
        ok = model.cfg.precision == "w4a8" and model.cfg.rank == RANK_HI
        log(f"[zimage-r256] loaded as {model.cfg.precision} rank {model.cfg.rank}, {model.cfg.num_layers} + "
            f"{model.cfg.num_refiner_layers} + {model.cfg.num_refiner_layers} blocks, dim {model.cfg.dim}: "
            f"{'PASS' if ok else 'FAIL'}")
        pipe = ZImagePipeline(model)
        with packed_route(), torch.no_grad():
            pipe(pe, num_inference_steps=1, seed=99, guidance_scale=0.0)  # first use, untimed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = pipe(pe, num_inference_steps=1, seed=0, guidance_scale=0.0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        counts = launch_counts()
    lat = out.latents.float()
    good = tuple(lat.shape) == (1, S_IMG, 64) and bool(torch.isfinite(lat).all())
    log(f"[zimage-r256] {name} served at w4a8 on the packed route, 1 step to latents: {sec:.4f} s, latents "
        f"{tuple(lat.shape)} |lat| mean {lat.abs().mean().item():.4f}, finite {good}; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    ok = check_counts(key, counts, per, 1, tag="zimage-r256") and good and ok
    del pipe, model, out, lat
    torch.cuda.empty_cache()
    log(f"[zimage-r256] phase {time.perf_counter() - t_phase:.1f} s (the file, its load, 2 requests)")
    return ok, counts, {key: per}


def core_sass(path) -> bool:
    """Each kernel on the attention core and each instantiation of the GEMM
    main loop in the built library: its wgmma (HGMMA bf16, IGMMA int8) and
    TMA-load (UTMALDG) instruction counts in cuobjdump -sass; False if one is
    missing or a count it needs is 0 (the int8 attention form needs IGMMA for
    q . k and HGMMA for p . v; the coded GEMM forms copy by TMA, decode, and
    run HGMMA; the int8 chain kernels' s8 instantiations and the packed w4a8
    kernels' (gemm_w4_kernel) run IGMMA; each W4A4 instantiation and each
    of the LN producer's (ln_mod_quant_kernel) copies by TMA and runs
    register-A HGMMA; each of the qkv producer's (qkv_rope_kernel) copies
    by TMA, and runs HGMMA where it has a low-rank term)."""
    from nunchaku_tpu_torch.ops import _build

    # demangled template arguments as plain numbers: "(int)1" -> "1", "(bool)0" / "false" -> "0"
    sass = {re.sub(r"\((?:int|bool)\)", "", name).replace("false", "0").replace("true", "1"): c
            for name, c in _build.sass_counts(path).items()}
    ok = True

    def show(c):
        return ", ".join(f"{op} {n}" for op, n in c.items())

    for row, (policy, d, form) in CORE_ROWS.items():
        found = [c for name, c in sass.items()
                 if f"flash_sm90_kernel<{policy}, {d}, {form}>" in name]
        good = (len(found) == 1 and found[0]["HGMMA"] > 0 and found[0]["UTMALDG"] > 0
                and (form != 6 or found[0]["IGMMA"] > 0))
        log(f"[build] {row}: flash_sm90_kernel<{policy}, {d}, {form}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    for d in WIDE_DIMS:
        found = [c for name, c in sass.items() if f"flash_wide_kernel<{d}>" in name]
        good = len(found) == 1 and found[0]["HGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] flash_online (D {d}): flash_wide_kernel<{d}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    for key, row in PROBE_SASS.items():
        found = [c for name, c in sass.items() if "gemm_sm90_kernel<" in name and f"::{key}" in name]
        good = len(found) == 1 and found[0]["HGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] {row}: gemm_sm90_kernel<Bf16, BN, 4, {key}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    for key, row in CHAIN_SASS.items():
        found = [c for name, c in sass.items() if "gemm_sm90_kernel<" in name and f"::{key}" in name
                 and "ProbeEpi<" not in name]
        good = len(found) == 1 and found[0]["IGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] {row}: gemm_sm90_kernel<S8, 128, 4, TmaS8<128>, {key}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    # the int8 probe (gemm_probe_i8.cu): its s8 instantiations gemm_sm90_kernel<S8, BN, ST, TmaS8<BN>,
    # ProbeEpi<f32, rank1>> and its persistent form probe_i8_persistent_kernel<BN, ST, ProbeEpi<..>>, one a built
    # (acc, epilogue, tile)
    from nunchaku_tpu_torch.ops.gemm_probe import I8_BUILT

    built = sum(len(tiles) for tiles in I8_BUILT.values())
    probe = {name: c for name, c in sass.items() if "ProbeEpi<" in name
             and ("gemm_sm90_kernel<" in name or "probe_i8_persistent_kernel<" in name)}
    for name, c in probe.items():
        good = c["IGMMA"] > 0 and c["UTMALDG"] > 0
        short = name.replace("(anonymous namespace)::", "").replace("gemm90::", "").split("(")[0]
        log(f"[build] gemm_probe_i8: {short} {show(c)}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    good = len(probe) == built
    log(f"[build] gemm_probe_i8: {len(probe)} s8 instantiations in the library, {built} built modes and tiles: "
        f"{'PASS' if good else 'FAIL'}")
    ok = ok and good
    for key, row in W4_SASS.items():  # s8 wgmma (IGMMA) on TMA-fed stages, W decoded by warpgroup 0
        found = [c for name, c in sass.items() if "gemm_w4_kernel<" in name and f"::{key}" in name]
        good = len(found) == 1 and found[0]["IGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] {row}: gemm_w4_kernel<{key}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    for mode, steps in W4A4_SASS:  # register-A wgmma (HGMMA) on TMA-fed stages
        found = [c for name, c in sass.items() if f"gemm_w4a4_kernel<{mode}, {steps}>" in name]
        good = len(found) == 1 and found[0]["HGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] gemm_w4a4 (mode {mode}, {steps} low-rank k steps): gemm_w4a4_kernel<{mode}, {steps}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    for steps in QKV_SASS:  # the qkv producer: TMA-fed x tiles; with a low-rank term, wgmma (HGMMA)
        found = [c for name, c in sass.items() if f"qkv_rope_kernel<{steps}>" in name]
        good = len(found) == 1 and found[0]["UTMALDG"] > 0 and (steps == 0 or found[0]["HGMMA"] > 0)
        log(f"[build] qkv_rope_producer (rows 7, 18): qkv_rope_kernel<{steps}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    conv = {re.sub(r"\((?:int|bool)\)", "", name).replace("false", "0").replace("true", "1"): c
            for name, c in _build.sass_counts(path, ("I2F", "F2I", "UTMALDG", "UTMASTG")).items()}
    for e2m1, row in DEQ_SASS.items():  # the dequant: TMA both ways, no conversion instruction
        found = [c for name, c in conv.items() if f"dequant_w4a8_kernel<{e2m1}>" in name]
        good = (len(found) == 1 and found[0]["UTMALDG"] > 0 and found[0]["UTMASTG"] > 0
                and found[0]["I2F"] == 0 and found[0]["F2I"] == 0)
        log(f"[build] {row}: dequant_w4a8_kernel<{e2m1}> "
            f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    found = [c for name, c in sass.items() if "gemm_gelu_pipe_kernel" in name]  # row 14: the s8 loop's products
    good = len(found) == 1 and found[0]["IGMMA"] > 0 and found[0]["UTMALDG"] > 0
    log(f"[build] gemm_w8a8_gelu_quant_pipe (row 14): gemm_gelu_pipe_kernel "
        f"{show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
    ok = ok and good
    for nv, dual, w in LN_SASS:  # the LN producer's low-rank product: register-A wgmma (HGMMA) on TMA-fed stages
        found = [c for name, c in sass.items() if f"ln_mod_quant_kernel<{nv}, {dual}, {w}>" in name]
        good = len(found) == 1 and found[0]["HGMMA"] > 0 and found[0]["UTMALDG"] > 0
        log(f"[build] ln_mod_quant{'_dual' if dual else ''} (rows {15 if dual else 6}): ln_mod_quant_kernel<{nv}, "
            f"{dual}, {w}> {show(found[0]) if found else 'not in the library'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    return ok


def ptxas_clean(lines) -> bool:
    """The -Xptxas -v output of each source in PTXAS_CLEAN (the build log's
    "[nvcc <source>]" blocks): no spill stores or loads and no "Potential
    Performance Loss" (C7512 / C7515: ptxas serializing wgmma)."""
    ok = True
    for text in lines:
        head = text.splitlines()[0]
        src = head[len("[nvcc "):-1] if head.startswith("[nvcc ") else ""
        if src not in PTXAS_CLEAN:
            continue
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
        loss = re.findall(r"\((C75\d\d)\) Potential Performance Loss", text)
        good = bool(spills) and not any(spills) and not loss
        log(f"[build] {src}: {len(spills) // 2} kernel(s), spill bytes {sum(spills)}, wgmma serialized "
            f"{', '.join(sorted(set(loss))) or 'never'}: {'PASS' if good else 'FAIL'}")
        ok = ok and good
    return ok


def online_bound(b, h, sq, skv, d):
    # q and out (B, H, Sq, D), k and v (B, H, Skv, D) bf16; 4 * Sq * Skv * D flop per head
    return bound(2 * 2 * b * h * sq * d + 2 * 2 * b * h * skv * d, bf16_ops=4 * b * h * sq * skv * d)


def sdxl_kernel_rows(dev, record, failed):
    """13. The online flash kernel at head dim 64 on SDXL's 1024px shapes:
    the row is level 1's self-attention (B 1, H 10, S 4096); level 2's (H
    20, S 1024) and both levels' cross-attention (Skv 77: three kv tiles,
    the last with 13 valid columns) are checked and timed too, each against
    the plain twin on the card, with SDPA as yardstick. Then the W4A4 GEMM
    at SDXL's shapes: level 1's qkv (M 4096, K 640 padded to 768, the
    padded K holding zero codes on both sides and zero activation scales,
    as the quantize and the padded linear leave them; N 1920) and level
    2's ff.out (M 1024, K 5120, N 1280), logged beside torch.matmul."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import flash_attention_online, flash_attention_online_plain
    from nunchaku_tpu_torch.ops.gemm import gemm_w4a4, gemm_w4a4_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    res, oks, errs = {}, [], []
    for (width, h, _), s in zip(SDXL_LEVELS, (64 * 64, 32 * 32)):
        for skv in (s, SDXL_CTX):
            q, k, v = checks.flash_online_case(1, h, s, skv, SDXL_D, device=dev)
            err, ok, detail = checks.check_flash_online(q, k, v)
            ms = time_ms(lambda: flash_attention_online(q, k, v, out_bshd=True), 50)
            plain = time_ms(lambda: flash_attention_online_plain(q, k, v, out_bshd=True), 3)
            lib = time_ms(lambda: sdpa(q, k, v, scale=1 / math.sqrt(SDXL_D)), 50)
            bnd = online_bound(1, h, s, skv, SDXL_D)
            res[(h, s, skv)] = (err, ok, detail, ms, plain, bnd, lib)
            oks.append(ok)
            errs.append(err)
            log(f"[kernel] flash_online_d64 @ B=1 H={h} Sq={s} Skv={skv} D={SDXL_D} ({'self' if skv == s else 'cross'}, "
                f"width {width}): {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms (plain {plain:.4f} ms, SDPA "
                f"{lib:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
            del q, k, v
    _, _, detail, ms, plain, bnd, lib = res[(SDXL_LEVELS[0][1], 4096, 4096)]
    record("flash_online_d64", "nunchaku_tpu_torch/csrc/flash_online.cu", "nunchaku_tpu/ops/attention.py:607",
           f"B=1 H=10 S=4096 D={SDXL_D} (SDXL level 1 self-attention)", all(oks), max(errs),
           detail + "; level 2 and both cross shapes logged above", ms, plain, bnd, lib)

    (w1, _, _), (w2, _, _) = SDXL_LEVELS
    for label, m, k_log, n in (("level 1 qkv", 64 * 64, w1, 3 * w1), ("level 2 ff.out", 32 * 32, 4 * w2, w2)):
        k = k_log + (-k_log) % 256
        args, kw = checks.w4a4_case(m, k, n, "int4", device=dev)
        qa, asc, qw, wsc = args[:4]
        qa[:, k_log // 2:] = 0
        qw[k_log // 2:] = 0
        asc[k_log // 64:] = 0
        _, ok, detail = checks.check_w4a4(args, kw)
        ms = time_ms(lambda: gemm_w4a4(*args, **kw), 20)
        plain = time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3)
        a16, w16 = decoded(args, kw)
        lib = time_ms(lambda: torch.matmul(a16[:, :k_log], w16[:k_log]), 20)
        kbf = k_bf_ms(a16, w16)  # on the padded operands, as the kernel runs
        bnd = w4a4_bound(m, k, n, 64, k_ops=k_log)
        log(f"[kernel] gemm_w4a4_int4 @ M={m} K={k_log}{f' (padded {k})' if k != k_log else ''} N={n} R={RANK} "
            f"(SDXL {label}): {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms (plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"k_bf {'n/a' if kbf is None else f'{kbf:.4f} ms'}, bound {bnd[0]:.4f} ms by {bnd[1]}, "
            f"{100 * bnd[0] / ms:.1f}% of bound)")
        if not ok:
            failed.append(f"gemm_w4a4_int4@SDXL {label}")
        del args, qa, asc, qw, wsc, a16, w16


def packed_kernel_rows(dev, record, failed):
    """10-12. The packed-int4 w4a8 route's kernels: the rank-1 GEMM at the
    single block's qkv (M 4608, K 3072, N 9216; the out projection's N 3072
    checked and timed too), the W4 producer at fc1 and the grouped consumer
    at fc2 (8 groups), each again at rank 128 and 256 (logged). Yardstick:
    torch._int_mm of the product alone on the dequant kernel's weight."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.gemm import (dequant_w4a8, gemm_w4a8, gemm_w4a8_grouped, gemm_w4a8_plain,
                                             svdq_gemm_w4a8_gelu_quant, svdq_gemm_w4a8_gelu_quant_plain)
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    m = S_IMG + S_TXT
    args = checks.w4a8_case(m, DIM, DIM, RANK, seed=1, device=dev)
    _, ok2, detail2 = checks.check_w4a8(*args)
    ms2 = time_ms(lambda: gemm_w4a8(*args), 20)
    bnd2 = bound(w4a8_bytes(m, DIM, DIM), 2 * m * DIM * DIM, 2 * m * DIM * RANK)
    log(f"[kernel] gemm_w4a8 @ M={m} K={DIM} N={DIM} R={RANK} (out projection): {'PASS' if ok2 else 'FAIL'} "
        f"{detail2}; {ms2:.4f} ms (plain {time_ms(lambda: gemm_w4a8_plain(*args), 3):.4f} ms, bound "
        f"{bnd2[0]:.4f} ms by {bnd2[1]}, {100 * bnd2[0] / ms2:.1f}% of bound)")
    if not ok2:
        failed.append("gemm_w4a8@out_projection")
    del args
    for name, case, src, line, fn, plain_fn, yard in (
            ("gemm_w4a8", lambda r: checks.w4a8_case(m, DIM, 3 * DIM, r, device=dev), "gemm_w4a8.cu", 281,
             gemm_w4a8, gemm_w4a8_plain, (DIM, 3 * DIM, 1)),
            ("gemm_w4a8_grouped", lambda r: checks.w4a8_grouped_case(m, HID, DIM, HID // 1536, r, device=dev),
             "gemm_w4a8.cu", 281, gemm_w4a8_grouped, gemm_w4a8_plain, (HID, DIM, HID // 1536)),
            ("gemm_w4a8_gelu_quant", lambda r: checks.w4a8_gelu_quant_case(m, DIM, HID, r, device=dev),
             "gemm_w8a8_gelu_quant.cu", 721, svdq_gemm_w4a8_gelu_quant, svdq_gemm_w4a8_gelu_quant_plain,
             (DIM, HID, 1))):
        k, n, g = yard
        for r in (RANK, 128, RANK_HI):
            args = case(r)
            check = checks.check_w4a8_gelu_quant if name == "gemm_w4a8_gelu_quant" else checks.check_w4a8
            err, ok, detail = check(*args)
            ms = time_ms(lambda: fn(*args), 20)
            plain = time_ms(lambda: plain_fn(*args), 3)
            if name == "gemm_w4a8_gelu_quant":
                bnd = bound(w4a8_bytes(m, k, n, r, out_bytes=gelu_quant_out_bytes(m, n, r)), 2 * m * n * k,
                            4 * m * n * r)
            else:
                bnd = bound(w4a8_bytes(m, k, n, r, g), 2 * m * n * k, 2 * m * n * r)
            shape = f"M={m} K={k} N={n}{f' G={g}' if g > 1 else ''} R={r}"
            if r == RANK:
                qa, w8 = args[0], dequant_w4a8(args[2], args[3])
                record(name, f"nunchaku_tpu_torch/csrc/{src}", f"nunchaku_tpu/ops/gemm.py:{line}", shape, ok, err,
                       detail, ms, plain, bnd, time_ms(lambda: int8_matmul(qa, w8), 20))
                del qa, w8
            else:
                log(f"[kernel] {name} @ {shape}: {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms (plain "
                    f"{plain:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
                if not ok:
                    failed.append(f"{name}@R{r}")
            del args
    torch.cuda.empty_cache()


def bs_kernel_rows(dev, record):
    """12. The block-sparse forms of both flash kernels at FLUX.1-dev
    2048px (B 1, 24 heads, S 16384 + 512, select_blocks at 0.5: 5 of 11 kv
    blocks of 1536 per query block of 768), also checked at 1536px (S 9216 +
    512 = 9728: the tail block holds 512 columns and is selected). Yardsticks:
    SDPA under the equivalent (B, H, S, S) bool mask, and the port's dense
    kernel of the same softmax form at the same S."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import block_sparse_mask, flash_attention, flash_attention_online

    sdpa = torch.nn.functional.scaled_dot_product_attention
    s = HR_S
    q, k, v, idx, bq, bkv = checks.block_sparse_case(1, HEADS, s, HR_SPARSITY, device=dev)
    nk, kk = -(-s // bkv), idx.shape[-1]
    mask = block_sparse_mask(idx, s, s, bq=bq, bkv=bkv)  # 6.9 GB of bool
    lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=math.log(2.0)), 3, warmup=1)
    del mask
    torch.cuda.empty_cache()
    dense_ms = {True: time_ms(lambda: flash_attention(q, k, v), 10),
                False: time_ms(lambda: flash_attention_online(q, k, v, scale=1.0, out_bshd=True), 5)}
    dense_bound = bound(4 * s * HEADS * HD * 2, bf16_ops=4 * s * s * HD * HEADS)[0]
    rq, rk, rv, ridx, rbq, rbkv = checks.block_sparse_case(1, HEADS, RAGGED_S, HR_SPARSITY, seed=1, device=dev)
    tail = -(-RAGGED_S // rbkv) - 1
    tail_rows = int((ridx == tail).any(dim=-1).sum())
    for name, fixed, src, line in (("bs_fixed", True, "flash_fixed.cu", 1109),
                                   ("bs_online", False, "flash_online.cu", 1153)):
        err2, ok2, detail2 = checks.check_block_sparse(rq, rk, rv, ridx, rbq, rbkv, fixed, out_bshd=False)
        log(f"[kernel] {name} @ B=1 H={HEADS} S={RAGGED_S} (1536px), kk {ridx.shape[-1]} of {tail + 1}, tail "
            f"block {tail} ({RAGGED_S - tail * rbkv} columns) selected by {tail_rows} query blocks, (B, H, S, D) out: "
            f"{'PASS' if ok2 else 'FAIL'} {detail2}")
        err, ok, detail = checks.check_block_sparse(q, k, v, idx, bq, bkv, fixed)
        ms = time_ms(lambda: checks.run_block_sparse(q, k, v, idx, bq, bkv, fixed), 10)
        log(f"[kernel] {name}: the dense {'flash_fixed' if fixed else 'flash_online'} kernel at the same S "
            f"{dense_ms[fixed]:.4f} ms (bound {dense_bound:.4f} ms); block-sparse / dense {ms / dense_ms[fixed]:.3f}")
        record(name, f"nunchaku_tpu_torch/csrc/{src}", f"nunchaku_tpu/ops/attention.py:{line}",
               f"B=1 H={HEADS} S={s} D={HD}, kk {kk} of {nk} kv blocks of {bkv} per query block of {bq}",
               ok and ok2, max(err, err2), detail + f"; 1536px: {detail2}", ms,
               time_ms(lambda: checks.run_block_sparse(q, k, v, idx, bq, bkv, fixed, plain=True), 1, warmup=1),
               bs_bound(idx, s, s, bq, bkv), lib_ms)
    del q, k, v, idx, rq, rk, rv, ridx
    torch.cuda.empty_cache()


def per_forward_bounds(cfg) -> dict:
    """Least time per 1024px forward for each kernel, summed over the path's
    shapes (the default and turbo paths' kernels; the 4-bit paths')."""
    L, Ls, T = cfg.num_layers, cfg.num_single_layers, S_IMG + S_TXT

    def deq(k, n, g=64):
        return bound(deq_bytes(k, n, g))[0]

    def chain(m, res=0, nj=HID // 1536):
        """res: 0 none, 1 (x, gate), 2 (x, gate, extra, extra_la, extra_pu);
        nj: scale groups (1: the per-token chain)."""
        prod = bound(gemm_bytes(m, DIM, HID, RANK, m * HID + 4 * nj * m + 4 * m * RANK),
                     2 * m * HID * DIM, 4 * m * HID * RANK)[0]
        extra = 0 if res == 0 else res_bytes(m, DIM, 1, RANK if res == 2 else 0)
        cons = bound(gemm_bytes(m, HID, DIM, RANK, 2 * m * DIM) + 4 * nj * m + extra,
                     2 * m * HID * DIM, (2 + 2 * (res == 2)) * m * DIM * RANK)[0]
        return prod, cons

    def lnq(m):
        return bound(ln_bytes(m, DIM, RANK), bf16_ops=2 * m * DIM * RANK)[0]

    def w4a4_signed(m, g):
        return sum(w4a4_bound(m, DIM, n, g)[0] for n in (3 * DIM, DIM, HID))

    def rope(s):
        return bound(rope_bytes(s), bf16_ops=2 * s * 3 * DIM * RANK)[0]

    def w4a8(m, k, n, groups=1):
        return bound(w4a8_bytes(m, k, n, RANK, groups), 2 * m * n * k, 2 * m * n * RANK)[0]

    def standalone(m):  # the packed route's qkv and out projection of one stream
        return w4a8(m, DIM, 3 * DIM) + w4a8(m, DIM, DIM)

    def w4prod(m):
        return bound(w4a8_bytes(m, DIM, HID, out_bytes=gelu_quant_out_bytes(m, HID)), 2 * m * HID * DIM,
                     4 * m * HID * RANK)[0]

    dual = [chain(S_IMG), chain(S_TXT)]
    single = chain(T)
    return {
        "gemm_w4a8_stacked": L * (standalone(S_IMG) + standalone(S_TXT)) + Ls * standalone(T),
        "gemm_w4a8_gelu_quant_stacked": L * (w4prod(S_IMG) + w4prod(S_TXT)) + Ls * w4prod(T),
        "gemm_w4a8_grouped_stacked": (L * (w4a8(S_IMG, HID, DIM, 8) + w4a8(S_TXT, HID, DIM, 8))
                                      + Ls * w4a8(T, HID, DIM, 8)),
        "dequant_w4a8_stacked": L * 2 * (deq(DIM, 3 * DIM) + deq(DIM, DIM) + deq(DIM, HID) + deq(HID, DIM))
        + Ls * (deq(DIM, 3 * DIM) + deq(DIM, DIM) + deq(DIM, HID) + deq(HID, DIM)),
        "dequant_w4a8_e2m1_stacked": L * 2 * (deq(DIM, 3 * DIM, 16) + deq(DIM, DIM, 16) + deq(DIM, HID, 16)
                                              + deq(HID, DIM, 16))
        + Ls * (deq(DIM, 3 * DIM, 16) + deq(DIM, DIM, 16) + deq(DIM, HID, 16) + deq(HID, DIM, 16)),
        "gemm_w8a8_gelu_quant": L * (dual[0][0] + dual[1][0]) + Ls * single[0],
        "gemm_w8a8_grouped": L * (dual[0][1] + dual[1][1]) + Ls * single[1],
        "flash_fixed": (L + Ls) * bound(4 * T * HEADS * HD * 2, bf16_ops=4 * T * T * HD * HEADS)[0],
        "ln_mod_quant_int8": L * 2 * (lnq(S_IMG) + lnq(S_TXT)) + Ls * 2 * lnq(T),
        "qkv_rope_producer": L * (rope(S_IMG) + rope(S_TXT)) + Ls * rope(T),
        "gemm_w8a8_grouped_res": L * (chain(S_IMG, 1)[1] + chain(S_TXT, 1)[1]) + Ls * chain(T, 2)[1],
        # the int8 model's stacked chain modes (the same work on the layer of a stack)
        "gemm_w8a8_gelu_quant_stacked": L * (dual[0][0] + dual[1][0]) + Ls * single[0],
        "gemm_w8a8_grouped_stacked": L * (dual[0][1] + dual[1][1]) + Ls * single[1],
        "gemm_w8a8_grouped_res_stacked": L * (chain(S_IMG, 1)[1] + chain(S_TXT, 1)[1]) + Ls * chain(T, 2)[1],
        "gemm_w8a8_gelu_quant_ptoken_stacked": (L * (chain(S_IMG, nj=1)[0] + chain(S_TXT, nj=1)[0])
                                                + Ls * chain(T, nj=1)[0]),
        "gemm_w8a8_rank1_stacked": L * (chain(S_IMG, nj=1)[1] + chain(S_TXT, nj=1)[1]) + Ls * chain(T, nj=1)[1],
        "gemm_w8a8_rank1_res_stacked": (L * (chain(S_IMG, 1, 1)[1] + chain(S_TXT, 1, 1)[1])
                                        + Ls * chain(T, 2, 1)[1]),
        # the 4-bit paths: qkv, out projection, fc1 (signed) and fc2 (unsigned at int4) of each
        # stream of a dual block and of a single block
        "gemm_w4a4_int4_stacked": sum(L * w4a4_signed(m, 64) for m in (S_IMG, S_TXT)) + Ls * w4a4_signed(T, 64),
        "gemm_w4a4_int4_unsigned_stacked": (sum(L * w4a4_bound(m, HID, DIM, 64)[0] for m in (S_IMG, S_TXT))
                                            + Ls * w4a4_bound(T, HID, DIM, 64)[0]),
        "gemm_w4a4_nvfp4_stacked": (sum(L * (w4a4_signed(m, 16) + w4a4_bound(m, HID, DIM, 16)[0])
                                        for m in (S_IMG, S_TXT))
                                    + Ls * (w4a4_signed(T, 16) + w4a4_bound(T, HID, DIM, 16)[0])),
        "gemv_awq": 2 * L * gemv_bound(1, DIM, 6 * DIM)[0] + Ls * gemv_bound(1, DIM, 3 * DIM)[0],
    }


def reference_phase(dev):
    """Small model: kernels on the card against the plain twins on the CPU,
    in the default and then the turbo configuration."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6,
                     joint_attention_dim=512, pooled_projection_dim=256, precision="w4a8")
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=3, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(4)
    pe = torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16)
    pooled = torch.randn((1, 256), generator=gen).to(torch.bfloat16)
    lat = torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16)
    kw = dict(height=256, width=256, num_inference_steps=2)
    all_ok = True
    for name in ("default (f32 stream)", "turbo (bf16 stream, fused qkv prologue)"):
        if name.startswith("turbo"):
            for mdl in (cpu_model, gpu_model):
                mdl.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        ref = FluxPipeline(cpu_model)(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat, **kw).latents.float()
        out = FluxPipeline(gpu_model)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                      latents=lat.to(dev), **kw).latents.float().cpu()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= 2e-2
        log(f"[reference] {name}: 1+1-block FLUX (dim 768), 2 steps at 256x256: card vs CPU plain "
            f"latents rel max error {rel:.3e} (tolerance 2e-2): {'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
    image_ok = reference_image_path(cpu_model, gpu_model, dev)
    ok4 = reference_4bit(dev, pe, pooled, lat, kw)
    all_ok = reference_packed(dev, cfg, pe, pooled, lat, kw) and all_ok
    return (all_ok and image_ok and ok4 and reference_qwen(dev) and reference_blocksparse(dev)
            and reference_text_encoders(dev) and reference_checkpoint(dev) and reference_sdxl(dev)
            and reference_sana(dev) and reference_zimage(dev) and reference_conditioning(dev))


SDXL_SMALL = dict(block_out_channels=(128, 256, 512), layers_per_block=1, transformer_layers=(0, 1, 2),
                  cross_attention_dim=256, projection_class_embeddings_input_dim=256 + 6 * 32,
                  addition_time_embed_dim=32)  # tests/test_sdxl.py's TINY: 11 blocks at widths 256 / 512


def reference_sdxl(dev):
    """The small SDXL UNet of the CPU tests (11 transformer blocks, head dim
    64), card against CPU with the same weights and inputs, at the bounds
    the CPU tests hold the port to against JAX (twice the spread of the JAX
    package's own two GEMM routes): int4, one forward (1e-1) and 2 steps of
    SDXLPipeline at 256x256 without guidance (1e-1); int8, one forward
    (3e-2) and 2 steps with CFG 5.0 (7e-2: the guidance multiplies the
    forward's differences; at int4 it multiplies the code flips past any
    useful bound). Every attention on the D-64 kernel (22 a forward), every
    int4 SVDQ linear on the W4A4 kernel (66 a forward)."""
    from nunchaku_tpu_torch import SDXLConfig, SDXLPipeline, SDXLUNet2DConditionModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_sdxl import sdxl_sigmas

    gen = torch.Generator().manual_seed(13)
    pe, ne = (torch.randn((1, 77, 256), generator=gen).to(torch.bfloat16) for _ in range(2))
    pool, npool = (torch.randn((1, 256), generator=gen).to(torch.bfloat16) for _ in range(2))
    lat = torch.randn((1, 4, 32, 32), generator=gen) * float((sdxl_sigmas(2)[0][0] ** 2 + 1.0) ** 0.5)
    kw = dict(height=256, width=256, num_inference_steps=2, guidance_scale=5.0)
    all_ok = True
    for precision, tol_fwd, cfg_on, tol in (("int4", 1e-1, False, 1e-1), ("int8", 3e-2, True, 7e-2)):
        cpu_model = SDXLUNet2DConditionModel.random_init(SDXLConfig(**SDXL_SMALL, precision=precision), seed=14,
                                                          device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        args = (torch.randn((1, 4, 32, 32), generator=gen).to(torch.bfloat16), torch.tensor([500.0]), pe, pool,
                torch.full((1, 6), 512.0))
        with torch.no_grad():
            ref1 = cpu_model(*args).float()
            reset_launch_counts()
            out1 = gpu_model(*[a.to(dev) for a in args]).float().cpu()
            c1 = launch_counts()
        neg = (ne, npool) if cfg_on else (None, None)
        ref = SDXLPipeline(cpu_model)(pe, pool, *neg, latents=lat, **kw).latents
        reset_launch_counts()
        out = SDXLPipeline(gpu_model)(pe.to(dev), pool.to(dev), *[None if t is None else t.to(dev) for t in neg],
                                      latents=lat.to(dev), **kw).latents.cpu()
        c2 = launch_counts()
        rel1 = ((out1 - ref1).abs().max() / ref1.abs().max()).item()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        gemm, fwd = (66 if precision == "int4" else 0), (4 if cfg_on else 2)
        counts_ok = (c1["flash_online_d64"], c1["gemm_w4a4_int4"], c2["flash_online_d64"], c2["gemm_w4a4_int4"]) == (
            22, gemm, fwd * 22, fwd * gemm)
        ok = (bool(torch.isfinite(out).all()) and bool(torch.isfinite(out1).all()) and rel1 <= tol_fwd and rel <= tol
              and counts_ok)
        log(f"[reference] SDXL small UNet (11 blocks, widths 256 / 512) {precision}: one forward card vs CPU rel "
            f"max error {rel1:.3e} (tolerance {tol_fwd:.0e}); 2 steps at 256x256 {'with CFG 5.0' if cfg_on else 'unguided'}"
            f" latents {rel:.3e} (tolerance {tol:.0e}); launches a forward flash_online_d64 {c1['flash_online_d64']} "
            f"(22), gemm_w4a4_int4 {c1['gemm_w4a4_int4']} ({gemm}), the pipeline's {c2['flash_online_d64']} / "
            f"{c2['gemm_w4a4_int4']} ({fwd} forwards): {'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
    return all_ok


def reference_blocksparse(dev):
    """The small FLUX model (1 + 1 blocks, 6 heads) under
    set_attention_impl("blocksparse", 0.5) at w4a8 and at int4 (AdaLN
    modulation damped), 2 steps at 640x640 (S_img 1600 + S_txt 64: query
    blocks of 768 with a ragged third of 128, kv blocks of 1536 and a ragged
    tail of 128, 1 of 2 selected), card against CPU: the latents within
    2e-2, every attention call a bs_fixed launch, and the selections equal
    call for call, except in a query block whose pooled scores are so close
    to a tie that the card's and the CPU's differ by more than the gap
    between the kk-th and the next score (the int4 codes turn sub-ulp
    differences into percent-level ones; such rows are counted and
    reported). The smallest such gap is reported too."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import attention, checks, launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    gen = torch.Generator().manual_seed(13)
    pe = torch.randn((1, 64, 512), generator=gen).to(torch.bfloat16)
    pooled = torch.randn((1, 256), generator=gen).to(torch.bfloat16)
    lat = torch.randn((1, 1600, 64), generator=gen).to(torch.bfloat16)
    kw = dict(height=640, width=640, num_inference_steps=2)
    select = attention.select_blocks
    calls = []

    def recording(q, k, ratio, *, bq, bkv):
        idx = select(q, k, ratio, bq=bq, bkv=bkv)
        calls.append((idx.cpu(), attention.pooled_block_scores(q, k, bq=bq, bkv=bkv).cpu()))
        return idx

    def compare(cpu_calls, gpu_calls):
        """-> (calls with equal ids, query blocks whose ids differ, of them
        the ones not explained by a near tie, smallest CPU top-kk gap)."""
        equal, differ, unexplained, gap_min = 0, 0, 0, math.inf
        for (ic, sc), (ig, sg) in zip(cpu_calls, gpu_calls):
            kk = ic.shape[-1]
            top = sc.sort(dim=-1, descending=True).values
            gap = top[..., kk - 1] - top[..., kk]
            gap_min = min(gap_min, gap.min().item())
            rows = (ic != ig).any(dim=-1)
            equal += int(not rows.any())
            differ += int(rows.sum())
            unexplained += int((rows & (gap > 2 * (sc - sg).abs().amax(dim=-1))).sum())
        return equal, differ, unexplained, gap_min

    all_ok = True
    attention.select_blocks = recording
    try:
        for precision in ("w4a8", "int4"):
            cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6, joint_attention_dim=512,
                             pooled_projection_dim=256, precision=precision)
            cpu_model = FluxTransformer2DModel.random_init(cfg, seed=14, device="cpu")
            if precision == "int4":
                checks.damp_modulation(cpu_model)
            cpu_model.set_attention_impl("blocksparse", sparsity_ratio=HR_SPARSITY)
            gpu_model = copy.deepcopy(cpu_model).to(dev)
            calls.clear()
            ref = FluxPipeline(cpu_model)(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat,
                                          **kw).latents.float()
            cpu_calls = list(calls)
            calls.clear()
            reset_launch_counts()
            out = FluxPipeline(gpu_model)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                          latents=lat.to(dev), **kw).latents.float().cpu()
            c = launch_counts()
            equal, differ, unexplained, gap = compare(cpu_calls, calls)
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ok = (len(calls) == len(cpu_calls) == 4 and unexplained == 0 and rel <= 2e-2
                  and bool(torch.isfinite(out).all()) and c["bs_fixed"] == 4 and c["flash_fixed"] == 0)
            log(f"[reference] blocksparse 0.5, {precision}{' damped' if precision == 'int4' else ''}: 1+1-block FLUX "
                f"(dim 768), 2 steps at 640x640 (S 1600 + 64, kk {cpu_calls[0][0].shape[-1]} of 2 kv blocks, 18 query "
                f"blocks a call): selections card == CPU in {equal} of {len(calls)} calls; {differ} query blocks "
                f"differ, {unexplained} of them not at a near tie (tol 0); smallest top-kk score gap {gap:.4e}; "
                f"latents rel max error {rel:.3e} (tol 2e-2); bs_fixed launches {c['bs_fixed']} (expected 4): "
                f"{'PASS' if ok else 'FAIL'}")
            all_ok = all_ok and ok
    finally:
        attention.select_blocks = select
    return all_ok


def reference_text_encoders(dev):
    """A small T5 with AWQ W4A16 linears (d_model 512, d_ff 1024, 8 heads,
    2 layers; bench.py's tiny one) and a small CLIP (d 128, 2 heads, 2
    layers) on the card against the CPU, 2 rows of 77 token ids: within
    2e-2 of the CPU's max |value|."""
    from nunchaku_tpu_torch.models.text_encoders.clip import CLIPTextModel
    from nunchaku_tpu_torch.models.text_encoders.t5 import T5EncoderModel

    gen = torch.Generator().manual_seed(15)
    ok = True
    t5 = T5EncoderModel.random_init(d_model=512, d_ff=1024, heads=8, layers=2, quantized=True, seed=16, device="cpu")
    clip = CLIPTextModel.random_init(seed=17, device="cpu")
    for name, model, ids in (("T5 (AWQ, d 512, 2 layers)", t5, torch.randint(0, 32128, (2, 77), generator=gen)),
                             ("CLIP (d 128, 2 layers)", clip, torch.randint(3, 1000, (2, 77), generator=gen))):
        if model is clip:
            ids[:, 20] = CLIP_EOS
        with torch.no_grad():
            ref = model(ids)
            out = copy.deepcopy(model).to(dev)(ids.to(dev))
        errs = [((o.float().cpu() - r.float()).abs().max() / r.float().abs().max()).item()
                for o, r in zip(out if model is clip else (out,), ref if model is clip else (ref,))]
        good = max(errs) <= 2e-2
        log(f"[reference] {name}: card vs CPU rel max error {', '.join(f'{e:.3e}' for e in errs)} (tol 2e-2): "
            f"{'PASS' if good else 'FAIL'}")
        ok = ok and good
    return ok


def reference_qwen(dev):
    """The 2-block Qwen-Image model of the CPU tests (2 heads of 128, joint
    320) through QwenImagePipeline at 128x128, true CFG 4.0 with padded
    prompts (24 and 9 valid tokens of 24; negatives of 6, all valid) at B 2,
    2 steps, card against CPU: w4a8; int4 with its AdaLN modulation damped
    (checks.damp_modulation), its modulation linears also held alone; int4
    under fixed_softmax = False (the online kernel's mask form)."""
    from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
    from nunchaku_tpu_torch.ops import checks, launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_qwenimage import QwenImagePipeline

    gen = torch.Generator().manual_seed(11)
    pe = torch.randn((2, 24, 320), generator=gen).to(torch.bfloat16)
    neg = torch.randn((2, 6, 320), generator=gen).to(torch.bfloat16)
    lat = torch.randn((2, 64, 64), generator=gen).to(torch.bfloat16)
    mask = torch.arange(24)[None, :] < torch.tensor([[24], [9]])
    neg_mask = torch.ones((2, 6), dtype=torch.bool)
    kw = dict(height=128, width=128, num_inference_steps=2, true_cfg_scale=4.0)
    all_ok = True
    for precision, online in (("w4a8", False), ("int4", False), ("int4", True)):
        cfg = QwenImageConfig(num_layers=2, num_attention_heads=2, joint_attention_dim=320, precision=precision)
        cpu_model = QwenImageTransformer2DModel.random_init(cfg, seed=12, device="cpu")
        if precision == "int4":
            checks.damp_modulation(cpu_model)
        cpu_model.set_on_stacks("attn", fixed_softmax=not online)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        ref = QwenImagePipeline(cpu_model)(pe, neg, mask, neg_mask, latents=lat, **kw).latents.float()
        reset_launch_counts()
        out = QwenImagePipeline(gpu_model)(pe.to(dev), neg.to(dev), mask.to(dev), neg_mask.to(dev),
                                           latents=lat.to(dev), **kw).latents.float().cpu()
        masked = launch_counts()["flash_online_masked" if online else "flash_fixed_masked"]
        rel = max(((out[i] - ref[i]).abs().max() / ref[i].abs().max()).item() for i in range(2))
        ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= 2e-2 and masked == 8
        label = f"{precision}{', AWQ modulation x ' + str(checks.MOD_DAMP) if precision == 'int4' else ''}" + (
            ", fixed_softmax False" if online else "")
        log(f"[reference] Qwen-Image 2 blocks (dim 256, joint 320) {label}: true CFG 4.0, padded prompts at B 2, "
            f"2 steps at 128x128: card vs CPU plain latents rel max error {rel:.3e} per batch row (tolerance "
            f"2e-2); masked flash launches {masked} (expected 8): {'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
        if precision == "int4" and not online:
            _, mod_ok, detail = checks.check_modulation(cpu_model, gpu_model)
            log(f"[reference] Qwen-Image int4 modulation linears, card vs CPU: {detail}: "
                f"{'PASS' if mod_ok else 'FAIL'}")
            all_ok = all_ok and mod_ok
    return all_ok


def packed_per_forward(L, Ls, turbo) -> dict:
    """Launches per forward of a FLUX w4a8 model of L dual and Ls single
    blocks on the packed route: every standalone linear (qkv and out of
    each stream, qkv and out of a single block) a rank-1 packed GEMM, every
    MLP one packed chain; the fused prologue's producer in turbo, no LN
    producer (the JAX gate), no dequant."""
    per = {"gemm_w4a8_stacked": 4 * L + 2 * Ls, "gemm_w4a8_gelu_quant_stacked": 2 * L + Ls,
           "gemm_w4a8_grouped_stacked": 2 * L + Ls, "flash_fixed": L + Ls}
    return per | {"qkv_rope_producer": 2 * L + Ls} if turbo else per


def reference_packed(dev, cfg, pe, pooled, lat, kw):
    """The small w4a8 model of the reference phase on the packed route
    (both switches), default then turbo configuration: card against CPU
    within 2e-2, the card's launches exactly the packed route's."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=3, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    all_ok = True
    with packed_route():
        for turbo in (False, True):
            if turbo:
                for mdl in (cpu_model, gpu_model):
                    mdl.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
            ref = FluxPipeline(cpu_model)(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat,
                                          **kw).latents.float()
            reset_launch_counts()
            out = FluxPipeline(gpu_model)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                          latents=lat.to(dev), **kw).latents.float().cpu()
            counts = {k: v for k, v in launch_counts().items() if v}
            steps = kw["num_inference_steps"]
            expect = {k: v * steps for k, v in packed_per_forward(cfg.num_layers, cfg.num_single_layers,
                                                                  turbo).items()}
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= 2e-2 and counts == expect
            log(f"[reference] packed route (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1), "
                f"{'turbo' if turbo else 'default'}: 1+1-block FLUX (dim 768), {steps} steps at 256x256: card vs "
                f"CPU plain latents rel max error {rel:.3e} (tolerance 2e-2); launches {counts} (expected "
                f"{expect}): {'PASS' if ok else 'FAIL'}")
            all_ok = all_ok and ok
    return all_ok


def reference_4bit(dev, pe, pooled, lat, kw):
    """The small model at int4 and at nvfp4, its AdaLN modulation damped
    (checks.damp_modulation), card against CPU; every GEMM and modulation
    on the card through its kernel, and each modulation linear alone within
    one bf16 step of the CPU's. Reported, not gated: the undamped model's
    error, and the damped model's with each wrong modulation of
    checks.MOD_MUTATIONS on the card (gated: the linear-level check fails
    each)."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import checks, launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    def rel_err(model, ref):
        out = FluxPipeline(model)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                  latents=lat.to(dev), **kw).latents.float().cpu()
        return ((out - ref).abs().max() / ref.abs().max()).item()

    all_ok = True
    for precision in ("int4", "nvfp4"):
        cfg = FluxConfig(num_layers=1, num_single_layers=1, num_attention_heads=6, joint_attention_dim=512,
                         pooled_projection_dim=256, precision=precision)
        cpu_model = FluxTransformer2DModel.random_init(cfg, seed=3, device="cpu")
        undamped = rel_err(copy.deepcopy(cpu_model).to(dev), FluxPipeline(cpu_model)(
            prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat, **kw).latents.float())
        checks.damp_modulation(cpu_model)
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        ref = FluxPipeline(cpu_model)(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat, **kw).latents.float()
        reset_launch_counts()
        out = FluxPipeline(gpu_model)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                      latents=lat.to(dev), **kw).latents.float().cpu()
        c = launch_counts()
        gemms = {k: v for k, v in c.items() if k.startswith("gemm_w4a4") and v}
        forwards = kw["num_inference_steps"]
        expect = ({"gemm_w4a4_int4_stacked": 9 * forwards, "gemm_w4a4_int4_unsigned_stacked": 3 * forwards}
                  if precision == "int4" else {"gemm_w4a4_nvfp4_stacked": 12 * forwards})
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        ok = (out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= 2e-2 and gemms == expect
              and c["gemv_awq"] == 3 * forwards)
        log(f"[reference] {precision} (f32 stream, AWQ modulation x {checks.MOD_DAMP}): 1+1-block FLUX (dim 768), "
            f"{forwards} steps at 256x256: card vs CPU plain latents rel max error {rel:.3e} (tolerance 2e-2; "
            f"undamped, not gated: {undamped:.3e}); launches {gemms}, gemv_awq {c['gemv_awq']}: "
            f"{'PASS' if ok else 'FAIL'}")
        _, mod_ok, detail = checks.check_modulation(cpu_model, gpu_model)
        log(f"[reference] {precision} modulation linears, card vs CPU: {detail}: {'PASS' if mod_ok else 'FAIL'}")
        all_ok = all_ok and ok and mod_ok
        for name in checks.MOD_MUTATIONS:
            wrong = copy.deepcopy(gpu_model)
            checks.mutate_modulation(wrong, name)
            _, caught, detail = checks.check_modulation(cpu_model, wrong)
            log(f"[reference] {precision} with a wrong modulation ({name}): latents rel max error "
                f"{rel_err(wrong, ref):.3e} (reported); linear-level check {detail}: "
                f"{'PASS (caught)' if not caught else 'FAIL (missed)'}")
            all_ok = all_ok and not caught
    return all_ok


def reference_image_path(cpu_model, gpu_model, dev):
    """The turbo model with the double FB cache and a small VAE (mid block
    512 wide, so the card takes the online flash kernel at 64x64 = 4096
    tokens whole and 32x32 = 1024 tokens in each of 3 x 3 tiles), 4 steps at
    512x512, on the card against the CPU. The resnet branches' second convs
    are damped (x 0.25) as in tests/test_torch_vae.py, so bf16 rounding
    flips do not grow through the random decoder beyond a trained one's."""
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline, unpack_latents

    cpu_vae = AutoencoderKL.random_init(seed=5, block_out_channels=(32, 32, 32, 512), layers_per_block=1,
                                        device="cpu")
    for name, buf in cpu_vae.named_buffers():
        if name.endswith("conv2.weight"):
            buf.mul_(0.25)
    gpu_vae = copy.deepcopy(cpu_vae).to(dev)
    gen = torch.Generator().manual_seed(6)
    pe = torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16)
    pooled = torch.randn((1, 256), generator=gen).to(torch.bfloat16)
    lat = torch.randn((1, 1024, 64), generator=gen).to(torch.bfloat16)
    kw = dict(height=512, width=512, num_inference_steps=4, cache="double_fb", cache_hit_ratio=0.5)
    ref = FluxPipeline(cpu_model, vae=cpu_vae)(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat, **kw)
    reset_launch_counts()
    out = FluxPipeline(gpu_model, vae=gpu_vae)(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev),
                                               latents=lat.to(dev), **kw)
    whole_launches = launch_counts()["flash_online"]
    rel = ((out.latents.float().cpu() - ref.latents.float()).abs().max() / ref.latents.float().abs().max()).item()
    img_err = (out.images.cpu() - ref.images).abs().max().item()
    for vae in (cpu_vae, gpu_vae):
        vae.enable_tiling(tile_latent_size=32)
    ref_t = cpu_vae.decode(unpack_latents(ref.latents, 64, 64))
    reset_launch_counts()
    out_t = gpu_vae.decode(unpack_latents(out.latents, 64, 64))
    tiled_launches = launch_counts()["flash_online"]
    tiled_err = (out_t.cpu() - ref_t).abs().max().item()
    ok = (out.cache_hits == ref.cache_hits == 2 and rel <= 2e-2 and img_err <= 2e-2 and tiled_err <= 2e-2
          and whole_launches == 1 and tiled_launches == 9 and tuple(out.images.shape) == (1, 512, 512, 3)
          and bool(torch.isfinite(out.images).all()) and bool(torch.isfinite(out_t).all()))
    log(f"[reference] turbo + double_fb (ratio 0.5, 4 steps) + VAE (32, 32, 32, 512) at 512x512: cache hits "
        f"card {out.cache_hits} / CPU {ref.cache_hits}; latents rel max error {rel:.3e} (tol 2e-2); images "
        f"max abs error whole {img_err:.3e}, tiled {tiled_err:.3e} (tol 2e-2); flash_online launches whole "
        f"{whole_launches}, tiled {tiled_launches} (expected 1, 9): {'PASS' if ok else 'FAIL'}")
    return ok


def embeds_request(cfg, dev):
    """Requests from random prompt embeddings made from the seed (the
    transformer paths): seed -> a function giving the pipeline's prompt
    arguments inside the timed request."""
    def make(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        pe = torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16)
        pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16)
        return lambda: dict(prompt_embeds=pe, pooled_prompt_embeds=pooled)
    return make


def t5_request(cfg, dev, t5):
    """bench.py's image request (bench.py:140-159): the prompt's T5-XXL
    encode from 512 token ids runs inside the timed request; the pooled
    embedding is random (bench.py passes zeros; it runs no CLIP)."""
    tokenize = stand_in_tokenizer(T5_XXL["vocab"], T5_EOS)

    def make(seed):
        ids = tokenize([PROMPTS[seed % len(PROMPTS)]], S_TXT).to(dev).long()
        gen = torch.Generator(device=dev).manual_seed(seed)
        pooled = torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16)
        return lambda: dict(prompt_embeds=t5(ids), pooled_prompt_embeds=pooled)
    return make


def prompt_request(seed):
    """A prompt string: the pipeline tokenizes it and runs both encoders."""
    return lambda: dict(prompt=PROMPTS[seed % len(PROMPTS)])


def serve(pipe, dev, steps, requests, label, request, size=1024, tag="slice", **call_kw):
    """Requests through the pipeline at ``size`` x ``size``, their prompt
    arguments from ``request(seed)`` (made inside the timed request), after
    one untimed 1-step request that takes the path's first-use work, with
    the launch counts reset just before the timed ones; -> (outputs finite
    (images in [0, 1]), seconds per request, counts, peak GiB, cache hits per
    request, last latents)."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    with torch.no_grad():
        pipe(**request(requests)(), height=size, width=size, num_inference_steps=1, seed=requests, **call_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    req_s, hits, finite = [], [], True
    for seed in range(requests):
        prompt = request(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = pipe(**prompt(), height=size, width=size, num_inference_steps=steps, seed=seed, **call_kw)
        torch.cuda.synchronize()
        req_s.append(time.perf_counter() - t0)
        lat = out.latents
        ok = tuple(lat.shape) == (1, (size // 16) ** 2, 64) and bool(torch.isfinite(lat.float()).all())
        what = f"latents {tuple(lat.shape)} finite={ok}, |lat| mean {lat.float().abs().mean().item():.4f}"
        if out.images is not None:
            img = out.images
            img_ok = (tuple(img.shape) == (1, size, size, 3) and img.dtype == torch.float32
                      and bool(torch.isfinite(img).all()) and img.min().item() >= 0.0 and img.max().item() <= 1.0)
            ok = ok and img_ok
            what += (f"; images {tuple(img.shape)} finite and in [0, 1]={img_ok} (min {img.min().item():.4f}, "
                     f"max {img.max().item():.4f}, mean {img.mean().item():.4f})")
        if out.cache_hits is not None:
            hits.append(out.cache_hits)
            what += f"; cache_hits {out.cache_hits}"
        finite = finite and ok
        log(f"[{tag}] {label} request seed={seed}: {req_s[-1]:.3f} s ({req_s[-1] / steps:.4f} s/step), {what}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] {label}: {requests} request(s) x {steps} steps; s/request {[round(x, 3) for x in req_s]}, "
        f"s/step (last request) {req_s[-1] / steps:.4f}; peak allocated {peak:.2f} GiB")
    return finite, req_s, counts, peak, hits, lat


def check_counts(label, counts, per_forward, forwards, extra=None, tag="slice"):
    """counts == per_forward x forwards (+ extra, a dict of whole counts)."""
    extra = extra or {}
    expected = {k: per_forward.get(k, 0) * forwards + extra.get(k, 0) for k in counts}
    ok = counts == expected
    log(f"[{tag}] {label} launches {counts}; expected {expected} "
        f"(per forward {per_forward}{f', plus {extra}' if extra else ''}): {'PASS' if ok else 'FAIL'}")
    return ok


def decode_alone(vae, lat, dev):
    """One tiled, then one whole-image decode of the last request's
    latents, each timed alone with its flash_online launches and peak."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import unpack_latents

    z = unpack_latents(lat, 128, 128)
    ok = True
    for label, tiles in (("tiled", VAE_TILES), ("whole-image", 1)):
        if tiles == 1:
            vae.disable_tiling()
            vae.decode(z)  # first use of the whole-image shapes, untimed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        img = vae.decode(z)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = launch_counts()["flash_online"]
        good = n == tiles and tuple(img.shape) == (1, 1024, 1024, 3) and bool(torch.isfinite(img).all())
        ok = ok and good
        log(f"[slice] {label} decode of 128x128 latents: {sec:.4f} s, flash_online launches {n} (expected "
            f"{tiles}), peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (transformer "
            f"resident): {'PASS' if good else 'FAIL'}")
    vae.enable_tiling()
    return ok


def slice_phase(dev, steps: int, requests: int, t5, res: dict):
    """The main path (module docstring, phase 5) and, on its models, the
    [kontext] requests (``res["kontext"]``: their verdict and launch
    counts, apart from the slice's); -> (ok, counts, per-forward counts, cfg)."""
    from nunchaku_tpu_torch.caching.fbcache import make_hit_schedule
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    cfg = FluxConfig(precision="w4a8")
    t0 = time.perf_counter()
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    log(f"[slice] FLUX.1-dev w4a8: {cfg.num_layers} dual + {cfg.num_single_layers} single blocks, "
        f"dim {cfg.dim}, {cfg.num_attention_heads} heads; weights {nbytes / 2**30:.2f} GiB, "
        f"random init {time.perf_counter() - t0:.1f} s")
    pipe = FluxPipeline(model, vae=None)
    L, Ls = cfg.num_layers, cfg.num_single_layers
    dual, single = W4A8_TURBO_DUAL, W4A8_TURBO_SINGLE
    paths = {
        "default": {"dequant_w4a8_stacked": 8 * L + 4 * Ls, "gemm_w8a8_gelu_quant": 2 * L + Ls,
                    "gemm_w8a8_grouped": 2 * L + Ls, "flash_fixed": L + Ls},
        "turbo": {k: L * dual[k] + Ls * single[k] for k in dual},
    }
    f32_steps = min(3, steps)
    embeds = embeds_request(cfg, dev)
    finite, _, counts_f32, *_ = serve(pipe, dev, f32_steps, 1, "default (f32 stream)", embeds)
    ok = finite and check_counts("default", counts_f32, paths["default"], f32_steps)
    model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    finite, _, counts_turbo, *_ = serve(pipe, dev, steps, requests, "turbo (bf16 stream, fused prologue)", embeds)
    ok = ok and finite and check_counts("turbo", counts_turbo, paths["turbo"], steps * requests)

    # bench.py's image path: the prompt's T5-XXL encode from token ids, the
    # double FB cache at a forced hit ratio of 0.5, then the full FLUX VAE's
    # tiled decode
    t0 = time.perf_counter()
    vae = AutoencoderKL.random_init(seed=0, device=dev)
    vae.enable_tiling()
    torch.cuda.synchronize()
    log(f"[slice] FLUX VAE decoder: latent 16, blocks (128, 256, 512, 512), 2 layers; weights "
        f"{sum(b.numel() * b.element_size() for b in vae.buffers()) / 2**20:.1f} MiB, random init "
        f"{time.perf_counter() - t0:.1f} s; tiles of 64 latents, overlap 0.25")
    pipe = FluxPipeline(model, vae=vae)
    hits = int(make_hit_schedule(steps, 0.5).sum())
    finite, _, counts_img, _, req_hits, lat = serve(
        pipe, dev, steps, requests, "image path (T5-XXL encode, turbo, double_fb 0.5, tiled VAE)",
        t5_request(cfg, dev, t5), cache="double_fb", cache_hit_ratio=0.5)
    # a hit runs dual block 0 and single block 0; a miss the full forward
    hit_runs = {k: (dual[k] + single[k]) * hits * requests for k in dual}
    ok = ok and finite and req_hits == [hits] * requests and check_counts(
        "image path", counts_img, paths["turbo"], (steps - hits) * requests,
        hit_runs | {"flash_online": VAE_TILES * requests})
    log(f"[slice] image path cache hits per request {req_hits} (expected {hits} of {steps} steps)")
    ok = decode_alone(vae, lat, dev) and ok
    kontext_turbo(dev, steps, model, vae, t5, cfg, paths, res)
    del pipe, model
    torch.cuda.empty_cache()
    okp, counts_p = packed_phase(dev, steps, vae, paths)
    ok4, counts4 = slice_4bit(dev, steps, vae, paths, res)
    fill_control(dev, steps, vae, paths, res)
    counts = {k: counts_f32[k] + counts_turbo[k] + counts_img[k] + counts_p[k] + counts4[k] for k in counts_f32}
    return ok and okp and ok4, counts, paths, cfg


def packed_phase(dev, steps: int, vae, paths):
    """[packed] A new full-size FLUX.1-dev w4a8 model, the same object on
    both routes: the dequant route (switches unset) against the packed-int4
    route (NUNCHAKU_TPU_W4A8_XLA=0, NUNCHAKU_TPU_W4A8_FUSED=1) in turns A B B
    A, min(3, steps) steps each, in the default then the turbo
    configuration, each run's launches exact and its peak memory; then one
    turbo request of min(4, steps) steps on the packed route to an image
    through the tiled VAE. ``paths`` gains the packed paths' per-forward
    counts; -> (ok, launch counts of the image request)."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    cfg = FluxConfig(precision="w4a8")
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    L, Ls = cfg.num_layers, cfg.num_single_layers
    for turbo in (False, True):
        paths["packed " + ("turbo" if turbo else "default")] = packed_per_forward(L, Ls, turbo)
    embeds = embeds_request(cfg, dev)(0)
    pipe = FluxPipeline(model)
    n = min(3, steps)

    def run(route, nsteps):
        with packed_route() if route == "packed" else contextlib.nullcontext(), torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = pipe(**embeds(), height=1024, width=1024, num_inference_steps=nsteps, seed=0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        lat = out.latents.float()
        finite = tuple(lat.shape) == (1, S_IMG, 64) and bool(torch.isfinite(lat).all())
        return sec / nsteps, launch_counts(), torch.cuda.max_memory_allocated() / 2**30, finite

    ok = True
    for config in ("default", "turbo"):
        if config == "turbo":
            model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        for route in ("dequant", "packed"):
            run(route, 1)  # first use of the route, untimed
        res = {"dequant": [], "packed": []}
        for route in ("dequant", "packed", "packed", "dequant"):
            sps, counts, peak, finite = run(route, n)
            res[route].append((sps, peak))
            per = paths[config] if route == "dequant" else paths[f"packed {config}"]
            ok = check_counts(f"{config} {route}", counts, per, n, tag="packed") and finite and ok
        log(f"[packed] {config}: s/step A B B A (dequant, packed, packed, dequant; {n} steps each) "
            f"{res['dequant'][0][0]:.4f}, {res['packed'][0][0]:.4f}, {res['packed'][1][0]:.4f}, "
            f"{res['dequant'][1][0]:.4f}; packed / dequant "
            f"{sum(x[0] for x in res['packed']) / sum(x[0] for x in res['dequant']):.3f}; peak allocated dequant "
            f"{max(x[1] for x in res['dequant']):.2f} GiB, packed {max(x[1] for x in res['packed']):.2f} GiB")
    with packed_route():
        finite, _, counts, *_ = serve(FluxPipeline(model, vae=vae), dev, min(4, steps), 1,
                                      "packed route turbo (tiled VAE)", embeds_request(cfg, dev), tag="packed")
    ok = check_counts("packed turbo image", counts, paths["packed turbo"], min(4, steps),
                      {"flash_online": VAE_TILES}, tag="packed") and finite and ok
    del pipe, model
    torch.cuda.empty_cache()
    return ok, counts


def slice_4bit(dev, steps: int, vae, paths, res):
    """The int4 model (default configuration, AWQ modulation) through the
    tiled VAE, then the nvfp4 model to latents, at full width and depth;
    ``paths`` gains their per-forward launch counts. The int4 model also
    serves the [kontext] TeaCache requests (``kontext_int4``)."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    ok, total = True, {}
    for precision, requests, nsteps, with_vae in (("int4", 2, min(4, steps), True),
                                                  ("nvfp4", 1, min(2, steps), False)):
        cfg = FluxConfig(precision=precision)
        L, Ls = cfg.num_layers, cfg.num_single_layers
        t0 = time.perf_counter()
        model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
        log(f"[slice] FLUX.1-dev {precision}: {L} dual + {Ls} single blocks, dim {cfg.dim}; weights "
            f"{nbytes / 2**30:.2f} GiB, random init {time.perf_counter() - t0:.1f} s")
        gemm = ({"gemm_w4a4_int4_stacked": 6 * L + 3 * Ls, "gemm_w4a4_int4_unsigned_stacked": 2 * L + Ls}
                if precision == "int4" else {"gemm_w4a4_nvfp4_stacked": 8 * L + 4 * Ls})
        paths[precision] = gemm | {"gemv_awq": 2 * L + Ls, "flash_fixed": L + Ls}
        label = f"{precision} (f32 stream{', tiled VAE' if with_vae else ''})"
        finite, _, counts, _, _, _ = serve(FluxPipeline(model, vae=vae if with_vae else None), dev, nsteps,
                                           requests, label, embeds_request(cfg, dev))
        extra = {"flash_online": VAE_TILES * requests} if with_vae else {}
        counts_ok = check_counts(precision, counts, paths[precision], nsteps * requests, extra)
        ok = ok and finite and counts_ok
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        if precision == "int4":
            kontext_int4(dev, steps, model, vae, cfg, paths, res)
        del model
        torch.cuda.empty_cache()
    return ok, total


def text_encoders(dev):
    """T5-XXL with AWQ W4A16 linears and CLIP-L from random weights made on
    the card from seeds (the JAX random_init distributions)."""
    from nunchaku_tpu_torch.models.text_encoders.clip import CLIPTextModel
    from nunchaku_tpu_torch.models.text_encoders.t5 import T5EncoderModel

    t0 = time.perf_counter()
    t5 = T5EncoderModel.random_init(**T5_XXL, seed=20, device=dev)
    clip = CLIPTextModel.random_init(**CLIP_L, seed=21, device=dev)
    torch.cuda.synchronize()
    gib = [sum(b.numel() * b.element_size() for b in m.buffers()) / 2**30 for m in (t5, clip)]
    log(f"[encoders] T5-XXL AWQ W4A16 (d_model 4096, d_ff 10240, 64 heads of 64, 24 layers) {gib[0]:.2f} GiB, "
        f"CLIP-L (d 768, 12 heads, 12 layers, vocab 49408, 77 positions) {gib[1]:.2f} GiB; random init "
        f"{time.perf_counter() - t0:.1f} s")
    secs = []
    for model, tokenize, n in ((t5, stand_in_tokenizer(T5_XXL["vocab"], T5_EOS), S_TXT),
                               (clip, stand_in_tokenizer(CLIP_L["vocab"], CLIP_EOS), CLIP_L["max_pos"])):
        ids = tokenize([PROMPTS[0]], n).to(dev).long()
        with torch.no_grad():
            model(ids)  # first use
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                model(ids)
            torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) / 3)
    log(f"[encoders] one encode, warm, mean of 3: T5-XXL of {S_TXT} ids {secs[0]:.4f} s, CLIP-L of "
        f"{CLIP_L['max_pos']} ids {secs[1]:.4f} s")
    return t5, clip


def int8_per_forward(L, Ls, turbo, ptoken) -> dict:
    """Launches per forward of a FLUX int8 model of L dual and Ls single
    blocks on its stacks: one stacked producer and one stacked consumer per
    MLP chain (2 a dual block, 1 a single), of the chain's mode (per-token:
    the rank-1 consumer); in turbo the consumer's residual epilogue, the LN
    producer before each linear that takes it (the two qkv projections and
    the two MLPs of a dual block, the qkv and the MLP of a single) and the
    qkv/RoPE producer. The standalone int8 linears take torch._int_mm (no
    count), as JAX's take XLA's dot."""
    chains = 2 * L + Ls
    producer = "gemm_w8a8_gelu_quant_ptoken_stacked" if ptoken else "gemm_w8a8_gelu_quant_stacked"
    consumer = ("gemm_w8a8_rank1" if ptoken else "gemm_w8a8_grouped") + ("_res" if turbo else "") + "_stacked"
    per = {producer: chains, consumer: chains, "flash_fixed": L + Ls}
    if turbo:
        per |= {"ln_mod_quant_int8": 4 * L + 2 * Ls, "qkv_rope_producer": 2 * L + Ls}
    return per


INT8_SMALL = dict(num_layers=2, num_single_layers=3, num_attention_heads=6, joint_attention_dim=512,
                  pooled_projection_dim=256)  # tests/test_torch_stacked_flux.py's depths (dim 768: two scale groups)


def reference_int8(dev):
    """The small int8 model of the CPU tests (2 + 3 blocks on stacks, dim 768)
    in the turbo configuration, one forward with the grouped chain and one
    with the per-token chain, card against the plain twins on the CPU:
    within 2e-2 of the reference's max |value| (the CPU tests' bound),
    launches exact."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    cfg = FluxConfig(precision="int8", **INT8_SMALL)
    cpu_model = FluxTransformer2DModel.random_init(cfg, seed=13, device="cpu")
    cpu_model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator().manual_seed(14)
    args = (torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16),
            torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16),
            torch.randn((1, 256), generator=gen).to(torch.bfloat16),
            torch.tensor([0.6]), make_img_ids(16, 16), torch.zeros((128, 3), dtype=torch.int32), torch.tensor([3.5]))
    all_ok = True
    for ptoken in (False, True):
        with chain_ptoken(ptoken), torch.no_grad():
            ref = cpu_model(*args).float()
            reset_launch_counts()
            out = gpu_model(*[a.to(dev) for a in args]).float().cpu()
        counts = {k: v for k, v in launch_counts().items() if v}
        want = int8_per_forward(cfg.num_layers, cfg.num_single_layers, True, ptoken)
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= 2e-2 and counts == want
        log(f"[flux-int8] reference: 2+3-block int8 FLUX on stacks (dim 768), turbo, "
            f"{'per-token' if ptoken else 'grouped'} chain: card vs CPU plain rel max error {rel:.3e} (tolerance "
            f"2e-2); launches {counts} (expected {want}): {'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
    return all_ok


def flux_int8_phase(dev, steps: int, t5):
    """[flux-int8] FLUX.1-dev at int8 at full width and depth on its stacks,
    bench.py --dense's configuration (bench.py:76-83, 322-333: turbo, 1024px,
    512 text tokens, B 1): the small model card vs CPU first; then one
    transformer forward each in the default configuration (grouped, then
    per-token chain), one timed forward each in the turbo configuration, and
    one turbo request of min(4, steps) steps with the prompt's T5-XXL encode,
    cache="double_fb" at hit ratio 0.5 and the tiled VAE to a 1024x1024
    image. Each forward runs untimed once first; launch counts exact. ->
    (ok, counts summed over the timed runs, per-forward counts)."""
    from nunchaku_tpu_torch.caching.fbcache import make_hit_schedule
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline, make_img_ids

    ok = reference_int8(dev)
    cfg = FluxConfig(precision="int8")
    L, Ls = cfg.num_layers, cfg.num_single_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    log(f"[flux-int8] FLUX.1-dev int8: {L} dual + {Ls} single blocks on stacks, dim {cfg.dim}; weights "
        f"{nbytes / 2**30:.2f} GiB, random init {time.perf_counter() - t0:.1f} s (built into the stacks block by "
        f"block: peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
    paths = {}
    for turbo in (False, True):
        for ptoken in (False, True):
            paths[f"int8 {'turbo' if turbo else 'default'}{' ptoken' if ptoken else ''}"] = int8_per_forward(
                L, Ls, turbo, ptoken)
    gen = torch.Generator(device=dev).manual_seed(5)
    inputs = (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
              torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
              torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
              torch.tensor([1.0], device=dev), make_img_ids(math.isqrt(S_IMG), math.isqrt(S_IMG), dev),
              torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))
    total, step_s = {}, {}
    for turbo in (False, True):
        if turbo:
            model.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        for ptoken in (False, True):
            key = f"int8 {'turbo' if turbo else 'default'}{' ptoken' if ptoken else ''}"
            with chain_ptoken(ptoken), torch.no_grad():
                model(*inputs)  # first use, untimed
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                out = model(*inputs)
                torch.cuda.synchronize()
                step_s[key] = time.perf_counter() - t0
            counts = launch_counts()
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            finite = tuple(out.shape) == (1, S_IMG, 64) and bool(torch.isfinite(out.float()).all())
            log(f"[flux-int8] {key}: one 1024px transformer forward {step_s[key]:.4f} s, output {tuple(out.shape)} "
                f"finite={finite}; peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            ok = check_counts(key, counts, paths[key], 1, tag="flux-int8") and finite and ok
    log(f"[flux-int8] turbo forward: grouped chain {step_s['int8 turbo']:.4f} s, per-token chain "
        f"{step_s['int8 turbo ptoken']:.4f} s (per-token / grouped {step_s['int8 turbo ptoken'] / step_s['int8 turbo']:.3f}); "
        f"default: {step_s['int8 default']:.4f} / {step_s['int8 default ptoken']:.4f} s")
    vae = AutoencoderKL.random_init(seed=3, device=dev)
    vae.enable_tiling()
    n = min(4, steps)
    hits = int(make_hit_schedule(n, 0.5).sum())
    finite, _, counts, _, req_hits, _ = serve(
        FluxPipeline(model, vae=vae), dev, n, 1, "int8 turbo image request (T5-XXL encode, double_fb 0.5, tiled VAE)",
        t5_request(cfg, dev, t5), cache="double_fb", cache_hit_ratio=0.5, tag="flux-int8")
    # a hit runs dual block 0 and single block 0; a miss the full forward
    hit_runs = {k: v * hits for k, v in int8_per_forward(1, 1, True, False).items()}
    ok = finite and req_hits == [hits] and check_counts(
        "int8 image", counts, paths["int8 turbo"], n - hits, {k: hit_runs.get(k, 0) + (VAE_TILES if k == "flash_online"
                                                                                     else 0)
                                                              for k in set(hit_runs) | {"flash_online"}},
        tag="flux-int8") and ok
    log(f"[flux-int8] image request cache hits {req_hits} (expected {hits} of {n} steps)")
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del model, vae
    torch.cuda.empty_cache()
    return ok, total, paths


def highres_phase(dev, steps: int, t5, clip):
    """FLUX.1-dev int4 at full width and depth (default configuration) under
    set_attention_impl("blocksparse", sparsity_ratio=0.5) at 2048x2048 from
    prompts: the stand-in tokenizers, T5-XXL AWQ and CLIP-L inside each
    request, block-sparse attention (5 of 11 kv blocks), the tiled FLUX VAE
    (25 tiles). 2 requests of min(4, steps) steps to images; then 1-step
    requests to latents: block-sparse again, under fixed_softmax = False
    (bs_online), and dense (set_attention_impl("flashattn2")), the step
    times side by side. Each request runs untimed once first; launch counts
    exact per forward. -> (ok, counts summed, per-forward counts)."""
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    cfg = FluxConfig(precision="int4")
    L, Ls = cfg.num_layers, cfg.num_single_layers
    t0 = time.perf_counter()
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    vae = AutoencoderKL.random_init(seed=2, device=dev)
    vae.enable_tiling()
    torch.cuda.synchronize()
    log(f"[highres] FLUX.1-dev int4 ({L} dual + {Ls} single blocks) and the FLUX VAE, random init "
        f"{time.perf_counter() - t0:.1f} s; 2048x2048: {HR_S - S_TXT} image + {S_TXT} text tokens, block-sparse "
        f"attention at {HR_SPARSITY}")
    encoders = dict(text_encoder=clip, text_encoder_2=t5, tokenizer=stand_in_tokenizer(CLIP_L["vocab"], CLIP_EOS),
                    tokenizer_2=stand_in_tokenizer(T5_XXL["vocab"], T5_EOS))
    gemms = {"gemm_w4a4_int4_stacked": 6 * L + 3 * Ls, "gemm_w4a4_int4_unsigned_stacked": 2 * L + Ls,
             "gemv_awq": 2 * L + Ls}
    paths = {"highres": gemms | {"bs_fixed": L + Ls}, "highres online": gemms | {"bs_online": L + Ls},
             "highres dense": gemms | {"flash_fixed": L + Ls}}
    model.set_attention_impl("blocksparse", sparsity_ratio=HR_SPARSITY)
    n = min(4, steps)
    finite, req_s, counts, *_ = serve(FluxPipeline(model, vae=vae, **encoders), dev, n, 2,
                                      f"int4 blocksparse {HR_SPARSITY}, T5-XXL + CLIP-L, tiled VAE", prompt_request,
                                      size=HR_SIZE, tag="highres")
    ok = finite and check_counts("highres", counts, paths["highres"], 2 * n, {"flash_online": HR_TILES * 2})
    total = dict(counts)
    pipe = FluxPipeline(model, **encoders)
    step_s = {}
    for label, impl, fixed in (("highres", "blocksparse", True), ("highres online", "blocksparse", False),
                               ("highres dense", "flashattn2", True)):
        model.set_attention_impl(impl, sparsity_ratio=HR_SPARSITY if impl == "blocksparse" else 0.0)
        model.set_on_stacks("attn", fixed_softmax=fixed)
        finite, req_s, counts, *_ = serve(pipe, dev, 1, 1, f"{label}: 1 step to latents", prompt_request,
                                          size=HR_SIZE, tag="highres")
        ok = finite and check_counts(label, counts, paths[label], 1) and ok
        step_s[label] = req_s[0]
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    log(f"[highres] one 2048px request of 1 step (encoders + 1 forward, no decode): block-sparse "
        f"{step_s['highres']:.4f} s, block-sparse online softmax {step_s['highres online']:.4f} s, dense "
        f"{step_s['highres dense']:.4f} s; sparse saves {step_s['highres dense'] - step_s['highres']:.4f} s a step "
        f"({100 * (1 - step_s['highres'] / step_s['highres dense']):.1f}%)")
    del pipe, model, vae
    torch.cuda.empty_cache()
    return ok, total, paths


def qwen_edit(dev, steps, cfg, request, pipe, paths, block):
    """[qwen-edit] Qwen-Image-Edit on the [qwen] model (int4, 60 blocks, the
    default prologue) through ``pipe`` (the tiled FLUX VAE as encoder and
    decoder), true CFG 4.0 over a padded prompt (150 valid tokens of 211) at
    B 1: one 1024px reference (4096 tokens, rope frame 1), min(2, steps)
    steps to an image; Edit-2509's two 512px references (1024 tokens each,
    frames 1 and 2), 1 step to an image; cache="fb" (fn_blocks 8, threshold
    0.12) with the 1024px reference, min(4, steps) steps. Each after an
    untimed 1-step run; -> (ok, launch counts summed)."""
    L = cfg.num_layers
    total, ok = {}, True

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    ref = reference_image(KONTEXT_REF, 50, dev)
    n = min(2, steps)
    good, counts, _ = request(f"edit: one {KONTEXT_REF}px reference (S_img {S_IMG} + S_cond {KONTEXT_S_COND}), true "
                              f"CFG 4.0, tiled VAE", pipe, (150,), n, 5, warm=1, tag="qwen-edit", image=ref,
                              true_cfg_scale=4.0)
    ok = check_counts("qwen edit", counts, paths["qwen"], 2 * n, {"flash_online": 1 + VAE_TILES},
                      tag="qwen-edit") and good and ok
    add(counts)
    refs = [reference_image(512, 51 + i, dev) for i in range(2)]
    good, counts, _ = request("Edit-2509: two 512px references (S_cond 1024 + 1024, frames 1, 2), true CFG 4.0, "
                              "tiled VAE", pipe, (150,), 1, 6, warm=1, tag="qwen-edit", image=refs,
                              true_cfg_scale=4.0)
    ok = check_counts("qwen edit-2509", counts, paths["qwen"], 2, {"flash_online": 2 + VAE_TILES},
                      tag="qwen-edit") and good and ok
    add(counts)
    n, fn = min(4, steps), 8
    good, counts, out = request(f"edit + cache fb (fn_blocks {fn}, threshold 0.12), one {KONTEXT_REF}px reference, "
                                f"true CFG 4.0, tiled VAE", pipe, (150,), n, 7, warm=1, tag="qwen-edit", image=ref,
                                true_cfg_scale=4.0, cache="fb", fn_blocks=fn)
    forwards, hits = 2 * n, out.cache_hits
    blocks_run = fn * forwards + (L - fn) * (forwards - hits)
    log(f"[qwen-edit] edit + cache fb: {hits} hits of {forwards - 2} possible; {blocks_run} block runs")
    ok = check_counts("qwen edit fb", counts, block, blocks_run, {"flash_online": 1 + VAE_TILES},
                      tag="qwen-edit") and good and ok
    add(counts)
    return ok, total


def qwen_phase(dev, steps: int, res: dict):
    """Full-width, full-depth Qwen-Image int4 at 1024x1024 through
    QwenImagePipeline: requests A, D, B and C (module docstring), each after
    one untimed run of itself, with exact launch counts per forward; between
    D and B the [qwen-edit] requests (``res["qwen-edit"]``: their verdict and
    launch counts); -> (ok, launch counts summed over the requests A-D,
    per-forward counts, cfg)."""
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_qwenimage import QwenImagePipeline

    cfg = QwenImageConfig()
    L = cfg.num_layers
    t0 = time.perf_counter()
    model = QwenImageTransformer2DModel.random_init(cfg, seed=0, device=dev)
    vae = AutoencoderKL.random_init(seed=1, device=dev)
    vae.enable_tiling()
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    log(f"[qwen] Qwen-Image {cfg.precision}: {L} joint blocks, dim {cfg.dim}, {cfg.num_attention_heads} heads, joint "
        f"dim {cfg.joint_attention_dim}, rank {cfg.rank}; weights {nbytes / 2**30:.2f} GiB, random init (with the "
        f"VAE) {time.perf_counter() - t0:.1f} s")
    block = {"gemm_w4a4_int4_stacked": 6, "gemm_w4a4_int4_unsigned_stacked": 2, "gemv_awq": 2, "flash_fixed_masked": 1}
    paths = {"qwen": {k: L * v for k, v in block.items()}}
    paths["qwen online"] = {**{k: L * v for k, v in block.items() if k != "flash_fixed_masked"},
                            "flash_online_masked": L}
    fused_block = {**block, "qkv_rope_producer": 2}
    paths["qwen fused"] = {k: L * v for k, v in fused_block.items()}

    def prompts(b, valid, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        pe = torch.randn((b, QWEN_S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16)
        neg = torch.randn((b, QWEN_NEG, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16)
        mask = torch.arange(QWEN_S_TXT, device=dev)[None, :] < torch.tensor(valid, device=dev)[:, None]
        return pe, neg, mask, torch.ones((b, QWEN_NEG), dtype=torch.bool, device=dev)

    total = {}  # launch counts summed over the timed requests

    def request(label, pipe, valid, nsteps, seed, warm=None, tag="qwen", **kw):
        """One untimed run (of ``warm`` steps, default ``nsteps``), then the
        timed one -> (ok, counts, output); the counts of the [qwen] requests
        go into their total."""
        args = prompts(len(valid), valid, seed)
        pipe(*args, height=1024, width=1024, num_inference_steps=warm or nsteps, seed=0, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe(*args, height=1024, width=1024, num_inference_steps=nsteps, seed=1, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = launch_counts()
        if tag == "qwen":
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        b = len(valid)
        lat = out.latents.float()
        ok = tuple(lat.shape) == (b, S_IMG, 4 * cfg.out_channels) and bool(torch.isfinite(lat).all())
        what = f"latents {tuple(lat.shape)} finite={ok}, |lat| mean {lat.abs().mean().item():.4f}"
        if out.images is not None:
            img = out.images
            img_ok = (tuple(img.shape) == (b, 1024, 1024, 3) and bool(torch.isfinite(img).all())
                      and img.min().item() >= 0.0 and img.max().item() <= 1.0)
            ok = ok and img_ok
            what += (f"; images {tuple(img.shape)} finite and in [0, 1]={img_ok} (min {img.min().item():.4f}, "
                     f"max {img.max().item():.4f}, mean {img.mean().item():.4f})")
        if out.cache_hits is not None:
            what += f"; cache_hits {out.cache_hits}"
        log(f"[{tag}] {label}: {sec:.3f} s/request, {sec / nsteps:.4f} s/step ({nsteps} steps, B {b}); peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {what}")
        return ok, counts, out

    pipe = QwenImagePipeline(model, vae=vae)
    # A: true CFG at B 2 with padded prompts, to images through the tiled VAE
    n = min(4, steps)
    ok, counts, _ = request("request A (true CFG 4.0, B 2, masks, tiled VAE)", pipe, QWEN_VALID, n, 1,
                            true_cfg_scale=4.0)
    ok = check_counts("qwen A", counts, paths["qwen"], 2 * n, {"flash_online": VAE_TILES}) and ok
    # D: the online softmax's mask form, to latents
    model.set_on_stacks("attn", fixed_softmax=False)
    pipe = QwenImagePipeline(model)
    n = min(2, steps)
    okd, counts, _ = request("request D (fixed_softmax False, B 1, mask)", pipe, QWEN_VALID[1:], n, 2,
                             true_cfg_scale=1.0)
    ok = check_counts("qwen D", counts, paths["qwen online"], n) and okd and ok
    model.set_on_stacks("attn", fixed_softmax=True)
    res["qwen-edit"] = qwen_edit(dev, steps, cfg, request, QwenImagePipeline(model, vae=vae), paths, block)
    # B: the fused qkv prologue, lightning-4step at B 1
    model.enable_fused_qkv_prep()
    okb, counts, _ = request("request B (fused prologue, lightning-4step, B 1, mask)", pipe, QWEN_VALID[1:], 4,
                             3, lightning="lightning-4step")
    ok = check_counts("qwen B", counts, paths["qwen fused"], 4) and okb and ok
    # C: the first-8-blocks cache at its natural threshold, true CFG at B 1
    n = min(8, steps)
    fn = 8
    okc, counts, out = request(f"request C (cache fb, fn_blocks {fn}, threshold 0.12, true CFG 4.0, B 1)", pipe,
                               (150,), n, 4, true_cfg_scale=4.0, cache="fb", fn_blocks=fn)
    forwards, hits = 2 * n, out.cache_hits
    blocks_run = fn * forwards + (L - fn) * (forwards - hits)
    log(f"[qwen] request C: {hits} hits of {forwards - 2} possible; {blocks_run} block runs "
        f"({fn} per forward, all {L} on a miss)")
    ok = check_counts("qwen C", counts, fused_block, blocks_run) and okc and ok
    del pipe, model, vae
    torch.cuda.empty_cache()
    return ok, total, paths, cfg


def _gib(model) -> float:
    return sum(b.numel() * b.element_size() for b in model.buffers()) / 2**30


def _write(synth, path, make, label, tag="checkpoint"):
    """Draw a synthesized checkpoint on the card and write it; -> file bytes."""
    t0 = time.perf_counter()
    state = make()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nbytes = synth.write(path, state)
    t2 = time.perf_counter()
    del state
    torch.cuda.empty_cache()
    log(f"[{tag}] wrote {label}: {nbytes / 2**30:.3f} GiB in {t2 - t1:.2f} s ({nbytes / 2**30 / (t2 - t1):.2f} GiB/s; "
        f"drawn on the card in {t1 - t0:.2f} s)")
    return nbytes


def _load(label, fn, tag="checkpoint"):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    log(f"[{tag}] loaded {label} in {sec:.2f} s" + (f"; weights {_gib(out):.2f} GiB" if hasattr(out, "buffers") else ""))
    return out, sec


def _svdq_counts(model) -> dict:
    """Kernel launches per forward of a default-configuration (f32 stream)
    model on its stacks, from its stacked linears (one launch a layer): a
    w4a8 linear's stacked dequant (by code form), one chain producer and
    consumer per layer of an MLP pair whose linears take int8 activations
    and share a precision: stacked on int8 stacks, on the dequantized layer
    at w4a8."""
    from nunchaku_tpu_torch.models.attention import FeedForward, can_chain
    from nunchaku_tpu_torch.models.linear import SVDQW4A4Linear

    c = {}

    def add(key, n):
        c[key] = c.get(key, 0) + n

    for m in model.modules():
        if isinstance(m, SVDQW4A4Linear) and m.precision == "w4a8":
            add("dequant_w4a8_e2m1_stacked" if m.wcodes == "e2m1" else "dequant_w4a8_stacked", m.qweight.shape[0])
    pairs = [(m.fc1, m.fc2) for m in model.modules() if isinstance(m, FeedForward)]
    single = getattr(model, "single_transformer_blocks", None)
    pairs += [] if single is None else [(single.mlp_fc1, single.mlp_fc2)]
    for a, b in pairs:
        if can_chain(a, b):
            suffix = "_stacked" if a.precision == "int8" else ""
            add("gemm_w8a8_gelu_quant" + suffix, a.qweight.shape[0])
            add("gemm_w8a8_grouped" + suffix, a.qweight.shape[0])
    return c


def checkpoint_phase(dev, steps: int):
    """Synthesized full-size checkpoints (tools/synth_checkpoint.py) written to
    a temporary directory, removed at the end: FLUX.1-dev nvfp4 rank 32 (19
    dual + 38 single blocks, nunchaku's v1 schema), T5-XXL TinyChat W4,
    CLIP-L and the FLUX VAE (bf16 HF / diffusers files). The transformer
    loads at precision="w4a8" (nvfp4-a8: e2m1 codes through the dequant
    kernel's e2m1 form and the int8 chain) and serves one 1024px request
    from prompt ids (min(4, steps) steps, both encoders inside, tiled
    decode); the same file at its own precision (nvfp4) and the nvfp4-a8
    model after w4a8_cache_dequant(model, 4.0, inplace=True) each time one
    step, the dialed model's forward held against the undialed one's on the
    same inputs (int8 codes equal to the dequant's). -> (ok, counts summed,
    per-forward counts of each path)."""
    import tempfile

    from nunchaku_tpu_torch import (FluxPipeline, load_autoencoder, load_clip_text, load_flux_transformer,
                                    load_t5_encoder, w4a8_cache_dequant)
    from nunchaku_tpu_torch.ops.gemm import dequant_w4a8
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    ok, total, paths = True, {}, {}
    with tempfile.TemporaryDirectory(prefix="nunchaku_ckpt_") as tmp:
        free = shutil.disk_usage(tmp).free / 2**30
        log(f"[checkpoint] synthesized files in a temporary directory ({free:.0f} GiB free there)")
        files = {name: f"{tmp}/{name}.safetensors" for name in ("flux-nvfp4-r32", "t5-xxl-awq", "clip-l", "flux-vae")}
        _write(synth, files["flux-nvfp4-r32"], lambda: synth.flux_state(precision="nvfp4", rank=RANK, seed=30, device=dev),
               "FLUX.1-dev nvfp4 rank 32 (v1 schema)")
        _write(synth, files["t5-xxl-awq"], lambda: synth.t5_state(seed=31, device=dev), "T5-XXL TinyChat W4 (group 128)")
        _write(synth, files["clip-l"], lambda: synth.clip_state(seed=32, device=dev), "CLIP-L (bf16)")
        _write(synth, files["flux-vae"], lambda: synth.vae_state(seed=33, device=dev), "FLUX VAE decoder (bf16)")
        t5, _ = _load("T5-XXL", lambda: load_t5_encoder(files["t5-xxl-awq"], device=dev))
        clip, _ = _load("CLIP-L", lambda: load_clip_text(files["clip-l"], device=dev))
        vae, _ = _load("FLUX VAE", lambda: load_autoencoder(files["flux-vae"], device=dev))
        vae.enable_tiling()
        model, _ = _load("FLUX.1-dev at precision='w4a8' (nvfp4-a8)",
                         lambda: load_flux_transformer(files["flux-nvfp4-r32"], "w4a8", device=dev))
        cfg = model.cfg
        L, Ls = cfg.num_layers, cfg.num_single_layers
        paths["checkpoint nvfp4-a8"] = _svdq_counts(model) | {"flash_fixed": L + Ls}
        encoders = dict(text_encoder=clip, text_encoder_2=t5, tokenizer=stand_in_tokenizer(CLIP_L["vocab"], CLIP_EOS),
                        tokenizer_2=stand_in_tokenizer(T5_XXL["vocab"], T5_EOS))
        n = min(4, steps)
        finite, _, counts, *_ = serve(FluxPipeline(model, vae=vae, **encoders), dev, n, 1,
                                      "nvfp4-a8 from the nvfp4 file: T5-XXL + CLIP-L from prompt ids, tiled VAE",
                                      prompt_request, tag="checkpoint")
        ok = finite and check_counts("checkpoint nvfp4-a8", counts, paths["checkpoint nvfp4-a8"], n,
                                     {"flash_online": VAE_TILES}, tag="checkpoint")
        total = dict(counts)

        def one_step(mdl, label, path):
            nonlocal ok, total
            finite, req_s, counts, *_ = serve(FluxPipeline(mdl, **encoders), dev, 1, 1, f"{label}: 1 step to latents",
                                              prompt_request, tag="checkpoint")
            ok = finite and check_counts(label, counts, paths[path], 1, tag="checkpoint") and ok
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            return req_s[0]

        step_a8 = one_step(model, "nvfp4-a8", "checkpoint nvfp4-a8")
        gen = torch.Generator(device=dev).manual_seed(34)
        fixed = (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
                 torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                 torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
                 torch.tensor([0.5], device=dev), make_img_ids(64, 64, dev),
                 torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))
        with torch.no_grad():
            ref = model(*fixed).float()

        nv, _ = _load("FLUX.1-dev at its own precision (nvfp4)", lambda: load_flux_transformer(files["flux-nvfp4-r32"],
                                                                                             device=dev))
        paths["checkpoint nvfp4"] = {"gemm_w4a4_nvfp4_stacked": 8 * L + 4 * Ls, "gemv_awq": 2 * L + Ls,
                                     "flash_fixed": L + Ls}
        step_nv = one_step(nv, "nvfp4", "checkpoint nvfp4")
        del nv
        torch.cuda.empty_cache()

        fc1 = model.layer_views()["transformer_blocks"][0].ff.fc1
        want = dequant_w4a8(fc1.qweight, fc1.rescales, fc1.wcodes)  # the step's codes (outside any counted run)
        before = _gib(model)
        t0 = time.perf_counter()
        w4a8_cache_dequant(model, 4.0, inplace=True)
        torch.cuda.synchronize()
        dial_s = time.perf_counter() - t0
        got = model.layer_views()["transformer_blocks"][0].ff.fc1
        codes_ok = got.precision == "int8" and torch.equal(got.qweight, want)
        paths["checkpoint dialed"] = _svdq_counts(model) | {"flash_fixed": L + Ls}
        step_dial = one_step(model, "nvfp4-a8 after w4a8_cache_dequant(4.0)", "checkpoint dialed")
        with torch.no_grad():
            out = model(*fixed).float()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        good = codes_ok and rel <= 2e-2 and bool(torch.isfinite(out).all())
        ok = ok and good
        left = paths["checkpoint dialed"].get("dequant_w4a8_e2m1_stacked", 0)
        log(f"[checkpoint] w4a8_cache_dequant(4.0) in {dial_s:.2f} s: weights {before:.2f} -> {_gib(model):.2f} GiB, "
            f"{paths['checkpoint nvfp4-a8']['dequant_w4a8_e2m1_stacked'] - left} layer linears to int8 ({left} left "
            f"at w4a8); "
            f"block 0 fc1 codes equal to the dequant kernel's: {codes_ok}; forward on fixed inputs against the "
            f"undialed model's: rel max error {rel:.3e} (tolerance 2e-2): {'PASS' if good else 'FAIL'}")
        log(f"[checkpoint] one 1024px step (both encoders + 1 forward, no decode): nvfp4-a8 {step_a8:.4f} s, nvfp4 "
            f"{step_nv:.4f} s, nvfp4-a8 dialed (4.0 GiB) {step_dial:.4f} s")
        del model, t5, clip, vae, fixed, ref, out, want
        torch.cuda.empty_cache()
    return ok, total, paths


def checkpoint_qwen_phase(dev):
    """A synthesized Qwen-Image int4 rank-128 checkpoint (nunchaku's v2
    schema) at full width and depth (60 joint blocks, dim 3072, joint 3584),
    loaded at int4 and at precision="w4a8", each running one B 1 step to
    latents at 1024px with a padded prompt (97 of 211 tokens valid): the
    W4A4 GEMM and the chain kernels at rank 128. -> (ok, counts summed,
    per-forward counts)."""
    import tempfile

    from nunchaku_tpu_torch import QwenImagePipeline, load_qwenimage_transformer
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    ok, total, paths = True, {}, {}
    with tempfile.TemporaryDirectory(prefix="nunchaku_ckpt_") as tmp:
        path = f"{tmp}/qwen-image-int4-r128.safetensors"
        _write(synth, path, lambda: synth.qwen_state(rank=128, precision="int4", seed=40, device=dev),
               "Qwen-Image int4 rank 128 (v2 schema, 60 blocks)", tag="checkpoint-qwen")
        gen = torch.Generator(device=dev).manual_seed(41)
        pe = torch.randn((1, QWEN_S_TXT, 3584), generator=gen, device=dev).to(torch.bfloat16)
        mask = torch.arange(QWEN_S_TXT, device=dev)[None, :] < QWEN_VALID[1]
        for precision in (None, "w4a8"):
            label = precision or "int4"
            model, _ = _load(f"Qwen-Image rank 128 at {label}", lambda: load_qwenimage_transformer(path, precision,
                                                                                                device=dev),
                             tag="checkpoint-qwen")
            L = model.cfg.num_layers
            paths[f"qwen r128 {label}"] = ({"gemm_w4a4_int4_stacked": 6 * L,
                                            "gemm_w4a4_int4_unsigned_stacked": 2 * L, "gemv_awq": 2 * L}
                                           if precision is None else _svdq_counts(model)) | {"flash_fixed_masked": L}
            pipe = QwenImagePipeline(model)
            kw = dict(height=1024, width=1024, num_inference_steps=1, true_cfg_scale=1.0)
            runs = [(label, contextlib.nullcontext)]
            if precision == "w4a8":  # and once on the packed route: 4 packed GEMMs and 2 chains per block
                paths["qwen r128 w4a8 packed"] = {"gemm_w4a8_stacked": 4 * L,
                                                  "gemm_w4a8_gelu_quant_stacked": 2 * L,
                                                  "gemm_w4a8_grouped_stacked": 2 * L, "flash_fixed_masked": L}
                runs.append(("w4a8 packed", packed_route))
            for name, route in runs:
                with route(), torch.no_grad():
                    pipe(pe, None, mask, None, seed=0, **kw)  # first use, untimed
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    out = pipe(pe, None, mask, None, seed=1, **kw)
                    torch.cuda.synchronize()
                    sec = time.perf_counter() - t0
                counts = launch_counts()
                lat = out.latents.float()
                good = tuple(lat.shape) == (1, S_IMG, 64) and bool(torch.isfinite(lat).all())
                log(f"[checkpoint-qwen] rank 128 at {name}: one B 1 step to latents {sec:.4f} s, |lat| mean "
                    f"{lat.abs().mean().item():.4f}, finite {good}; peak allocated "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                ok = check_counts(f"qwen r128 {name}", counts, paths[f"qwen r128 {name}"], 1,
                                  tag="checkpoint-qwen") and good and ok
                total = {k: total.get(k, 0) + v for k, v in counts.items()}
            del pipe, model, out, lat
            torch.cuda.empty_cache()
    return ok, total, paths


def reference_checkpoint(dev):
    """Tiny synthesized checkpoints loaded on the card and on the CPU: a
    1 + 1-block FLUX nvfp4 file at precision="w4a8" (nvfp4-a8) and a
    2-block Qwen-Image int4 rank-128 file at w4a8. Every buffer equal bit for
    bit (the decode runs on the device the model is built on); latents of a
    2-step request within 2e-2 of the CPU's, the e2m1 dequant launched on the
    card."""
    import tempfile

    from nunchaku_tpu_torch import FluxPipeline, QwenImagePipeline, load_flux_transformer, load_qwenimage_transformer
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    def same(a, b):
        ba, bb = dict(a.named_buffers()), dict(b.named_buffers())
        return ba.keys() == bb.keys() and all(
            t.dtype == bb[k].dtype and torch.equal(t.cpu().contiguous().view(torch.uint8),
                                                   bb[k].cpu().contiguous().view(torch.uint8)) for k, t in ba.items())

    all_ok = True
    with tempfile.TemporaryDirectory(prefix="nunchaku_ckpt_") as tmp:
        fpath, qpath = f"{tmp}/flux.safetensors", f"{tmp}/qwen.safetensors"
        synth.write(fpath, synth.flux_state(layers=1, single=1, heads=6, joint=512, pooled=256, precision="nvfp4",
                                            seed=50, device="cpu"))
        synth.write(qpath, synth.qwen_state(layers=2, heads=2, joint=320, rank=128, seed=51, device="cpu"))
        gen = torch.Generator().manual_seed(52)
        pe = torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16)
        pooled = torch.randn((1, 256), generator=gen).to(torch.bfloat16)
        lat = torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16)
        qpe = torch.randn((2, 24, 320), generator=gen).to(torch.bfloat16)
        qneg = torch.randn((2, 6, 320), generator=gen).to(torch.bfloat16)
        qlat = torch.randn((2, 64, 64), generator=gen).to(torch.bfloat16)
        qmask = torch.arange(24)[None, :] < torch.tensor([[24], [9]])
        for label, load, path, call, count in (
                ("FLUX nvfp4 file at w4a8 (nvfp4-a8)", load_flux_transformer, fpath,
                 lambda m, d: FluxPipeline(m)(prompt_embeds=pe.to(d), pooled_prompt_embeds=pooled.to(d),
                                              latents=lat.to(d), height=256, width=256, num_inference_steps=2),
                 ("dequant_w4a8_e2m1_stacked", 2 * 12)),  # steps x linears
                ("Qwen-Image int4 rank-128 file at w4a8", load_qwenimage_transformer, qpath,
                 lambda m, d: QwenImagePipeline(m)(qpe.to(d), qneg.to(d), qmask.to(d),
                                                   torch.ones((2, 6), dtype=torch.bool, device=d), height=128,
                                                   width=128, num_inference_steps=2, true_cfg_scale=4.0,
                                                   latents=qlat.to(d)),
                 ("dequant_w4a8_stacked", 2 * 2 * 2 * 8))):  # steps x CFG branches x blocks x linears
            cpu_model, gpu_model = load(path, "w4a8", device="cpu"), load(path, "w4a8", device=dev)
            exact = same(gpu_model, cpu_model)
            ref = call(cpu_model, "cpu").latents.float()
            reset_launch_counts()
            out = call(gpu_model, dev).latents.float().cpu()
            launched = launch_counts()[count[0]]
            rel = ((out - ref).abs().max() / ref.abs().max()).item()
            ok = exact and rel <= 2e-2 and bool(torch.isfinite(out).all()) and launched == count[1]
            log(f"[reference] checkpoint: {label}: buffers equal card vs CPU {exact}; 2-step latents rel max error "
                f"{rel:.3e} (tolerance 2e-2); {count[0]} launches {launched} (expected {count[1]}): "
                f"{'PASS' if ok else 'FAIL'}")
            all_ok = all_ok and ok
    return all_ok


def sana_kernel_rows(dev, record, failed):
    """14. The online flash kernel at head dim 112 (flash_online_d112) on
    SANA 1.6B's cross-attention at 1024px under CFG: B 2, H 20, Sq 1024
    image tokens against Skv 300 text tokens (the row; ten kv tiles, the
    last with 12 valid columns); the PAG batch (B 3) checked and timed too;
    the plain twin on the card, SDPA as yardstick. Then the W4A4 GEMM at
    SANA's padded shapes: qkv (M 2048, K 2240 padded to 2304, N 6720 padded
    to 6784) and the point linear (M 2048, K 5600 padded to 5632, N 2240
    padded to 2304), the padded K holding zero codes and zero activation
    scales, as the quantize and the padded linear leave them; logged beside
    torch.matmul on the logical block."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import flash_attention_online, flash_attention_online_plain
    from nunchaku_tpu_torch.ops.gemm import gemm_w4a4, gemm_w4a4_plain

    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for b in (2, 3):
        q, k, v = checks.flash_online_case(b, SANA_HEADS, SANA_S, SANA_TXT, SANA_D, device=dev)
        err, ok, detail = checks.check_flash_online(q, k, v)
        ms = time_ms(lambda: flash_attention_online(q, k, v, out_bshd=True), 50)
        plain = time_ms(lambda: flash_attention_online_plain(q, k, v, out_bshd=True), 3)
        lib = time_ms(lambda: sdpa(q, k, v, scale=1 / math.sqrt(SANA_D)), 50)
        bnd = online_bound(b, SANA_HEADS, SANA_S, SANA_TXT, SANA_D)
        res[b] = (err, ok, detail, ms, plain, bnd, lib)
        log(f"[kernel] flash_online_d112 @ B={b} H={SANA_HEADS} Sq={SANA_S} Skv={SANA_TXT} D={SANA_D} (SANA cross, "
            f"{'CFG' if b == 2 else 'CFG + PAG'}): {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms (plain "
            f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
        del q, k, v
    err, ok, detail, ms, plain, bnd, lib = res[2]
    record("flash_online_d112", "nunchaku_tpu_torch/csrc/flash_online.cu", "nunchaku_tpu/ops/attention.py:607",
           f"B=2 H={SANA_HEADS} Sq={SANA_S} Skv={SANA_TXT} D={SANA_D} (SANA cross-attention, CFG)",
           ok and res[3][1], max(err, res[3][0]), detail + "; B 3 (PAG) logged above", ms, plain, bnd, lib)

    m = 2 * SANA_S
    for label, k_log, n_log in (("qkv", SANA_DIM, 3 * SANA_DIM), ("point", SANA_HID, SANA_DIM)):
        k, n = k_log + (-k_log) % 256, n_log + (-n_log) % 128
        args, kw = checks.w4a4_case(m, k, n, "int4", device=dev)
        qa, asc, qw, wsc = args[:4]
        qa[:, k_log // 2:] = 0
        qw[k_log // 2:] = 0
        asc[k_log // 64:] = 0
        _, ok, detail = checks.check_w4a4(args, kw)
        ms = time_ms(lambda: gemm_w4a4(*args, **kw), 20)
        plain = time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3)
        a16, w16 = decoded(args, kw)
        lib = time_ms(lambda: torch.matmul(a16[:, :k_log], w16[:k_log, :n_log]), 20)
        kbf = k_bf_ms(a16, w16)  # on the padded operands, as the kernel runs
        bnd = w4a4_bound(m, k, n_log, 64, k_ops=k_log)
        log(f"[kernel] gemm_w4a4_int4 @ M={m} K={k_log} (padded {k}) N={n_log} (padded {n}) R={RANK} (SANA {label}): "
            f"{'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms (plain {plain:.4f} ms, library {lib:.4f} ms, k_bf "
            f"{'n/a' if kbf is None else f'{kbf:.4f} ms'}, bound {bnd[0]:.4f} ms by {bnd[1]}, "
            f"{100 * bnd[0] / ms:.1f}% of bound)")
        if not ok:
            failed.append(f"gemm_w4a4_int4@SANA {label}")
        del args, qa, asc, qw, wsc, a16, w16
    torch.cuda.empty_cache()


def zimage_kernel_rows(dev, record, failed):
    """15. The stacked (layer-index) modes on Z-Image-Turbo's main-layer qkv
    (M 4608 joint tokens, K 3840, N 11520): the W4A4 GEMM at int4 and
    nvfp4, the dequant of that weight, the packed w4a8 GEMM (rank 1, R 32
    and 256, each a row, beside the dequant route at the shape; R 128
    logged, the rank of request C's file). Each reads the last layer
    of a 3-layer stack by a device-resident index; checked bit for bit
    against the non-stacked kernel on every layer and against the plain twin
    on the row's tolerance; timed beside the non-stacked kernel on the same
    weight (logged), the plain twin and the non-stacked row's yardstick."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.gemm import (dequant_w4a8, dequant_w4a8_plain, gemm_w4a4, gemm_w4a4_plain, gemm_w4a8,
                                             gemm_w4a8_plain, gemm_w8a8)
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    m, k, n = ZI_TXT + S_IMG, ZI_DIM, 3 * ZI_DIM
    shape = f"M={m} K={k} N={n}"
    for name, precision in (("gemm_w4a4_int4_stacked", "int4"), ("gemm_w4a4_nvfp4_stacked", "nvfp4")):
        args, kw = checks.w4a4_case(m, k, n, precision, device=dev)
        err, ok, detail = checks.check_w4a4_stacked(args, kw)
        g = 16 if precision == "nvfp4" else 64
        qa, asc, qw, wsc = args[:4]
        stack, ids = checks.stack_case(qw)
        ms = time_ms(lambda: gemm_w4a4(qa, asc, stack, wsc, *args[4:], **kw, layer_idx=ids[-1]), 20)
        flat = time_ms(lambda: gemm_w4a4(*args, **kw), 20)
        a16, w16 = decoded(args, kw)
        log(f"[kernel] {name} @ {shape}: stacked {ms:.4f} ms, non-stacked on the same weight {flat:.4f} ms")
        record(name, "nunchaku_tpu_torch/csrc/gemm_w4a4.cu", "nunchaku_tpu/ops/gemm.py:125",
               f"{shape} R={RANK} {precision}, layer 3 of 3 (Z-Image qkv)", ok, err, detail, ms,
               time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3), w4a4_bound(m, k, n, g),
               time_ms(lambda: torch.matmul(a16, w16), 20), k_bf_ms(a16, w16))
        del args, qa, asc, qw, wsc, stack, a16, w16
    qw, rs = checks.dequant_case(k, n, device=dev)
    err, ok, detail = checks.check_dequant_stacked(qw, rs)
    stack, ids = checks.stack_case(qw)
    ms = time_ms(lambda: dequant_w4a8(stack, rs, layer_idx=ids[-1]), 50)
    log(f"[kernel] dequant_w4a8_stacked @ K={k} N={n}: stacked {ms:.4f} ms, non-stacked "
        f"{time_ms(lambda: dequant_w4a8(qw, rs), 50):.4f} ms")
    record("dequant_w4a8_stacked", "nunchaku_tpu_torch/csrc/dequant_w4a8.cu", "nunchaku_tpu/ops/gemm.py:1074",
           f"K={k} N={n}, layer 3 of 3 (Z-Image qkv)", ok, err, detail, ms,
           time_ms(lambda: dequant_w4a8_plain(qw, rs), 5), bound(deq_bytes(k, n)), None)
    del qw, rs, stack
    for r in (128, RANK_HI, RANK):
        case = checks.w4a8_case(m, k, n, r, device=dev)
        err, ok, detail = checks.check_w4a8_stacked(*case)
        qa, asc, qw, rs = case[:4]
        stack, ids = checks.stack_case(qw)
        ms = time_ms(lambda: gemm_w4a8(qa, asc, stack, *case[3:], layer_idx=ids[-1]), 20)
        flat = time_ms(lambda: gemm_w4a8(*case), 20)
        bnd = bound(w4a8_bytes(m, k, n, r), 2 * m * n * k, 2 * m * n * r)
        if r == 128:
            log(f"[kernel] gemm_w4a8_stacked @ {shape} R={r}: {'PASS' if ok else 'FAIL'} {detail}; stacked {ms:.4f} ms "
                f"(non-stacked {flat:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound)")
            if not ok:
                failed.append(f"gemm_w4a8_stacked@R{r}")
        else:  # R 32, and R 256 (upstream's r256 Z-Image checkpoint on the packed route)
            w8 = dequant_w4a8(qw, rs)
            log(f"[kernel] gemm_w4a8_stacked @ {shape} R={r}: stacked {ms:.4f} ms, non-stacked {flat:.4f} ms; the "
                f"dequant route at this shape (dequant_w4a8 stacked + gemm_w8a8) "
                f"{time_ms(lambda: gemm_w8a8(qa, asc, dequant_w4a8(stack, rs, layer_idx=ids[-1]), *case[4:]), 20):.4f} ms")
            record("gemm_w4a8_stacked" + ("" if r == RANK else f"_r{r}"), "nunchaku_tpu_torch/csrc/gemm_w4a8.cu",
                   "nunchaku_tpu/ops/gemm.py:281", f"{shape} R={r}, layer 3 of 3 (Z-Image qkv)", ok, err, detail, ms,
                   time_ms(lambda: gemm_w4a8_plain(*case), 3), bnd, time_ms(lambda: int8_matmul(qa, w8), 20))
            del w8
        del case, qa, asc, qw, rs, stack
    torch.cuda.empty_cache()


# the stacked chain modes' rows, each with the line of its TPU kernel's mode
# the chain modes [rank256] reaches, each a row at rank 256 too (the chain kernels and the packed chain's two)
R256_CHAIN_MODES = ("gemm_w8a8_gelu_quant_stacked", "gemm_w8a8_grouped_res_stacked", "gemm_w4a8_gelu_quant_stacked",
                    "gemm_w4a8_grouped_stacked")
INT8_ROWS = {"gemm_w8a8_gelu_quant_stacked": 460, "gemm_w8a8_gelu_quant_ptoken_stacked": 534,
             "gemm_w8a8_grouped_stacked": 344, "gemm_w8a8_grouped_res_stacked": 395, "gemm_w8a8_rank1_stacked": 386,
             "gemm_w8a8_rank1_res_stacked": 386, "gemm_w4a8_gelu_quant_stacked": 721,
             "gemm_w4a8_grouped_stacked": 281}


def flux_int8_kernel_rows(dev, record, failed, r=RANK, modes=None, suffix=""):
    """16. The chain modes FLUX.1-dev's stacks reach (the int8 chain, grouped
    and per-token, and the packed chain), at FLUX's fc1 (producers: M 4608,
    K 3072, N 12288) and fc2 (consumers: M 4608, K 12288 in 8 scale groups,
    or 1 for the rank-1 modes, N 3072), R 32 (``modes`` of INT8_ROWS at rank
    ``r``: the rows named mode + ``suffix``). Each reads the last layer of a
    3-layer stack by a device-resident index; checked bit for bit against
    the non-stacked kernel on every layer and, through it, against the plain
    twin on the mode's tolerance (checks.chain_stacked_case); timed beside
    the non-stacked kernel (logged), the plain twin and torch._int_mm of the
    product alone."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.gemm import (dequant_w4a8, gemm_w4a8_plain, gemm_w8a8_grouped_plain,
                                             svdq_gemm_w4a8_gelu_quant_plain, svdq_gemm_w8a8_gelu_quant_plain)
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    m = S_IMG + S_TXT
    for mode in modes or INT8_ROWS:
        line = INT8_ROWS[mode]
        producer = "gelu_quant" in mode
        k, n = (DIM, HID) if producer else (HID, DIM)
        run, w, check, args = checks.chain_stacked_case(mode, m, k, n, r, device=dev)
        err, ok, detail = checks.check_stacked(run, w, check)
        stack, ids = checks.stack_case(w)
        ms = time_ms(lambda: run(stack, ids[-1]), 20)
        flat = time_ms(lambda: run(w, None), 20)
        w4 = mode.startswith("gemm_w4a8")
        groups = 1 if "rank1" in mode else k // 1536
        if producer:
            nj = 1 if "ptoken" in mode else n // 1536
            out_b = m * n + 4 * nj * m + 4 * m * r
            if w4:
                bnd = bound(w4a8_bytes(m, k, n, r, out_bytes=out_b + 4 * n + 2 * n * r), 2 * m * n * k,
                            4 * m * n * r)
                plain = time_ms(lambda: svdq_gemm_w4a8_gelu_quant_plain(*args), 3)
            else:
                bnd = bound(gemm_bytes(m, k, n, r, out_b) + 4 * n + 2 * n * r, 2 * m * n * k, 4 * m * n * r)
                plain = time_ms(lambda: svdq_gemm_w8a8_gelu_quant_plain(*args, ptoken="ptoken" in mode), 3)
        elif w4:
            bnd = bound(w4a8_bytes(m, k, n, r, groups), 2 * m * n * k, 2 * m * n * r)
            plain = time_ms(lambda: gemm_w4a8_plain(*args), 3)
        else:
            res = "_res" in mode
            bnd = bound(gemm_bytes(m, k, n, r, 2 * m * n) + 4 * groups * m + (res_bytes(m, n, 1, r) if res else 0),
                        2 * m * n * k, (4 if res else 2) * m * n * r)
            plain = time_ms(lambda: gemm_w8a8_grouped_plain(*args), 3)
        qa = args[0]
        w8 = dequant_w4a8(w, args[3]) if w4 else w
        lib = time_ms(lambda: int8_matmul(qa, w8), 20)
        shape = (f"M={m} K={k} N={n} R={r}" + (f" G={groups}" if not producer else "")
                 + (" +x,gate,extra,extra_lora" if "_res" in mode else "") + ", stacked: layer 3 of 3")
        log(f"[kernel] {mode} @ {shape}: stacked {ms:.4f} ms, non-stacked on the same weight {flat:.4f} ms")
        src = "gemm_w8a8_gelu_quant.cu" if producer else ("gemm_w4a8.cu" if w4 else "gemm_w8a8_grouped.cu")
        record(mode + suffix, f"nunchaku_tpu_torch/csrc/{src}", f"nunchaku_tpu/ops/gemm.py:{line}", shape, ok, err, detail,
               ms, plain, bnd, lib)
        del run, w, check, args, stack, qa, w8
    torch.cuda.empty_cache()


def fixed_form_kernel_rows(dev, record, failed):
    """18. The fixed-shift kernel's denominator form at FLUX's 2048px joint
    sequence (B 1, H 24, S 16896: the ring's one step at one rank), its
    two-tile and int8 forms at 1024px (S 4608), each against its plain twin
    on the card (the denominator's twin four heads at a time), SDPA as
    yardstick. Then the ring's arithmetic in one process: the denominator
    kernel on 4 contiguous kv shards of S 16896, combined by parallel.sp's
    combine, against the dense kernel (checks.check_ring_shards)."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import (flash_attention_denom, flash_attention_denom_plain,
                                                  flash_attention_i8, flash_attention_i8_plain, flash_attention_unroll2,
                                                  flash_attention_unroll2_plain)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "nunchaku_tpu_torch/csrc/flash_fixed.cu"
    s = SP_S
    q, k, v = checks.flash_case(1, HEADS, s, s, HD, device=dev)
    err, ok, detail = checks.check_flash_denom(q, k, v)
    record("flash_fixed_denom", src, "nunchaku_tpu/ops/attention.py:461", f"B=1 H={HEADS} S={s} D={HD}", ok, err,
           detail, time_ms(lambda: flash_attention_denom(q, k, v, scale=1.0), 5),
           time_ms(lambda: checks.by_heads(lambda *a: flash_attention_denom_plain(*a, scale=1.0), q, k, v), 1,
                   warmup=1),
           bound(4 * s * HEADS * HD * 2 + 4 * HEADS * s, bf16_ops=4 * s * s * HD * HEADS),
           time_ms(lambda: sdpa(q, k, v, scale=math.log(2.0)), 5))
    del q, k, v
    torch.cuda.empty_cache()
    err, ok, detail = checks.check_ring_shards(*checks.ring_case(1, HEADS, s, device=dev), SP_SHARDS)
    log(f"[kernel] flash_fixed_denom, the ring's combine in one process @ B=1 H={HEADS} S={s} in {SP_SHARDS} kv "
        f"shards of {s // SP_SHARDS}: {'PASS' if ok else 'FAIL'} {detail}")
    if not ok:
        failed.append("flash_fixed_denom ring shards")

    s = S_IMG + S_TXT
    q, k, v = checks.flash_case(1, HEADS, s, s, HD, device=dev)
    err, ok, detail = checks.check_flash_unroll2(q, k, v)
    lib = time_ms(lambda: sdpa(q, k, v, scale=math.log(2.0)), 20)
    record("flash_fixed_unroll2", src, "nunchaku_tpu/ops/attention.py:508", f"B=1 H={HEADS} S={s} D={HD}", ok, err,
           detail, time_ms(lambda: flash_attention_unroll2(q, k, v, scale=1.0, out_bshd=True), 20),
           time_ms(lambda: flash_attention_unroll2_plain(q, k, v, 1.0, out_bshd=True), 3),
           bound(4 * s * HEADS * HD * 2, bf16_ops=4 * s * s * HD * HEADS), lib)
    i8 = checks.flash_i8_case(1, HEADS, s, s, HD, device=dev)  # flash_case's q, k (seed 0) quantized
    err, ok, detail = checks.check_flash_i8(*i8)
    record("flash_fixed_i8", "nunchaku_tpu_torch/csrc/flash_fixed_i8.cu", "nunchaku_tpu/ops/attention.py:563",
           f"B=1 H={HEADS} S={s} D={HD}, int8 q, k", ok, err, detail,
           time_ms(lambda: flash_attention_i8(*i8, out_bshd=True), 20),
           time_ms(lambda: flash_attention_i8_plain(*i8, out_bshd=True), 3),
           bound(s * HEADS * HD * (1 + 1 + 2 + 2) + 8 * s * HEADS, int8_ops=2 * s * s * HD * HEADS,
                 bf16_ops=2 * s * s * HD * HEADS), lib)
    del q, k, v, i8
    torch.cuda.empty_cache()


def dual_bytes(m, k, r1, r2):
    # x bf16 once, mod scale + shift f32, two smooths and proj_downs -> two (q int8, ascale, lora_act)
    return 2 * m * k + 8 * k + 4 * k + 2 * k * (r1 + r2) + 2 * (m * k + 4 * m) + 4 * m * (r1 + r2)


def last_op_kernel_rows(dev, record, failed):
    """21-24. The four op-level entry points no model path calls (nor does
    JAX's): the dual LN producer at FLUX.1-dev's single block (B 1, S 4608,
    K 3072, the qkv and fc1 heads at R 32), each head bit for bit a row-6
    launch, beside the two row-6 launches' summed time; qkv_prepare at S
    4608, H 24, bit for bit row 7 without low-rank operands, beside row 7's
    time; token-major flash at B 1, S 4608, H 24, D 128, bit for bit row 5's
    kernel on the transposed tensors, beside that kernel plus the two
    transposes' copies, SDPA on the transposed views as yardstick; the
    pipelined chain producer at fc1 (M 4608, K 3072, N 12288, R 32; R 128
    logged), bit for bit row 2's kernel, beside row 2's time, torch._int_mm
    of the product as yardstick."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import (ONLINE_BKV, flash_attention_bshd, flash_attention_bshd_plain,
                                                  flash_attention_online, qkv_prepare, qkv_prepare_plain,
                                                  qkv_rope_producer)
    from nunchaku_tpu_torch.ops.gemm import svdq_gemm_w8a8_gelu_quant, svdq_gemm_w8a8_gelu_quant_plain
    from nunchaku_tpu_torch.ops.quantize import (ln_mod_quant_int8, ln_mod_quant_int8_dual,
                                                 ln_mod_quant_int8_dual_plain)
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    s = m = S_IMG + S_TXT
    args = checks.ln_dual_case(1, m, DIM, RANK, RANK, device=dev)
    err, ok, detail = checks.check_ln_dual(*args)
    x, sc, sh, sma, pda, smb, pdb = args
    ms = time_ms(lambda: ln_mod_quant_int8_dual(*args), 50)
    two = time_ms(lambda: (ln_mod_quant_int8(x, sc, sh, sma, pda), ln_mod_quant_int8(x, sc, sh, smb, pdb)), 50)
    log(f"[kernel] ln_mod_quant_dual: {ms:.4f} ms against two row-6 launches {two:.4f} ms")
    record("ln_mod_quant_dual", "nunchaku_tpu_torch/csrc/ln_mod_quant.cu", "nunchaku_tpu/ops/quantize.py:265",
           f"B=1 S={m} K={DIM} R={RANK}+{RANK}", ok, err, detail, ms,
           time_ms(lambda: ln_mod_quant_int8_dual_plain(*args), 5),
           bound(dual_bytes(m, DIM, RANK, RANK), bf16_ops=2 * m * DIM * 2 * RANK),
           time_ms(lambda: torch.nn.functional.layer_norm(x, (DIM,), eps=1e-6), 50))
    del args, x, sc, sh, sma, pda, smb, pdb

    streams, cos, sin = checks.qkv_rope_case(1, (s,), HEADS, HD, 0, device=dev)
    qkv, nq, nk = streams[0][:3]
    q_scale = 1.4426950408889634 / math.sqrt(HD)
    err, ok, detail = checks.check_qkv_prepare(qkv, cos, sin, nq, nk, HEADS, q_scale)
    ms = time_ms(lambda: qkv_prepare(qkv, cos, sin, nq, nk, heads=HEADS, head_dim=HD, q_scale=q_scale), 50)
    row7 = time_ms(lambda: qkv_rope_producer(qkv, cos, sin, nq, nk, q_scale=q_scale), 50)
    log(f"[kernel] qkv_prepare: {ms:.4f} ms against row 7's kernel without low-rank operands {row7:.4f} ms")
    record("qkv_prepare", "nunchaku_tpu_torch/csrc/qkv_rope_producer.cu", "nunchaku_tpu/ops/attention.py:51",
           f"B=1 S={s} H={HEADS} D={HD}", ok, err, detail, ms,
           time_ms(lambda: qkv_prepare_plain(qkv, cos, sin, nq, nk, heads=HEADS, head_dim=HD, q_scale=q_scale), 5),
           bound(rope_bytes(s, r=0)), None)
    del streams, cos, sin, qkv, nq, nk

    q, k, v = checks.flash_bshd_case(1, HEADS, s, s, HD, device=dev)
    err, ok, detail = checks.check_flash_bshd(q, k, v)
    ms = time_ms(lambda: flash_attention_bshd(q, k, v), 20)
    relayout = time_ms(lambda: flash_attention_online(*(t.transpose(1, 2).contiguous() for t in (q, k, v)),
                                                      out_bshd=True), 20)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    log(f"[kernel] flash_online_bshd: {ms:.4f} ms against row 5's kernel plus the transposed copies of q, k, v "
        f"{relayout:.4f} ms")
    record("flash_online_bshd", "nunchaku_tpu_torch/csrc/flash_online.cu", "nunchaku_tpu/ops/attention.py:927",
           f"B=1 S={s} H={HEADS} D={HD}, token-major", ok, err, detail, ms,
           time_ms(lambda: flash_attention_bshd_plain(q, k, v, bkv=ONLINE_BKV), 1, warmup=1),
           bound(4 * s * HEADS * HD * 2, bf16_ops=4 * s * s * HD * HEADS),
           time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*views), 20))
    del q, k, v, views
    torch.cuda.empty_cache()

    n = HID
    for r in (RANK, 128, RANK_HI):
        args = checks.gelu_quant_case(m, DIM, n, r, device=dev)
        err, ok, detail = checks.check_gelu_quant_pipe(*args)
        ms = time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*args, pipelined=True), 20)
        row2 = time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*args), 20)
        bnd = bound(gemm_bytes(m, DIM, n, r, m * n + 4 * (n // 1536) * m + 4 * m * r) + 4 * n + 2 * n * r,
                    2 * m * n * DIM, 4 * m * n * r)
        shape = f"M={m} K={DIM} N={n} R={r}"
        log(f"[kernel] gemm_w8a8_gelu_quant_pipe @ {shape}: {ms:.4f} ms against row 2's kernel {row2:.4f} ms")
        if r != 128:
            qa, w = args[0], args[2]
            record("gemm_w8a8_gelu_quant_pipe" + ("" if r == RANK else f"_r{r}"),
                   "nunchaku_tpu_torch/csrc/gemm_w8a8_gelu_quant_pipe.cu",
                   "nunchaku_tpu/ops/gemm.py:790", shape + ", pipelined=True", ok, err, detail, ms,
                   time_ms(lambda: svdq_gemm_w8a8_gelu_quant_plain(*args), 3), bnd,
                   time_ms(lambda: int8_matmul(qa, w), 20))
            del qa, w
        else:
            log(f"[kernel] gemm_w8a8_gelu_quant_pipe @ {shape}: {'PASS' if ok else 'FAIL'} {detail}; bound "
                f"{bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound")
            if not ok:
                failed.append("gemm_w8a8_gelu_quant_pipe@R128")
        del args
    torch.cuda.empty_cache()


def sp_phase(dev, steps: int):
    """[sp] Sequence parallelism on one rank of an NCCL process group
    (init_method file://, world size 1: the script needs one card;
    the ring over more ranks runs in the CPU tests over gloo): FLUX.1-dev
    w4a8 at full width and depth (default configuration) at 2048x2048
    (examples/flux_multichip_sp.py), the parallelize_sequence forward
    against the plain forward of the same model on the same inputs, then a
    2-step request to latents through the SP forward (flux_sigmas and
    euler_step, as the example), timed; Qwen-Image int4 and Z-Image int4 at
    full size, 1024px, B 1, global txt_ids: one SP forward each against the
    plain forward. Every SP forward's attention is the ring's one step, the
    denominator kernel: flash_fixed_denom 57 / 60 / 34 a forward, no
    flash_fixed. The group is destroyed at the end. -> (ok, counts of the SP
    runs, per-forward counts)."""
    import tempfile

    import torch.distributed as dist

    from nunchaku_tpu_torch import QwenImageConfig, QwenImageTransformer2DModel, ZImageConfig, ZImageTransformer2DModel
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.parallel import (parallelize_sequence, parallelize_sequence_qwenimage,
                                             parallelize_sequence_zimage)
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids
    from nunchaku_tpu_torch.pipeline.scheduler import euler_step, flux_sigmas

    tmp = tempfile.mkdtemp(prefix="sp_group_")
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'group')}", world_size=1, rank=0)
    log(f"[sp] NCCL process group: world size {dist.get_world_size()}, rank {dist.get_rank()}, init "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(9)
    ok, total, paths = True, {}, {}

    def compare(label, model, parallelize, args, per):
        """The plain forward, then the SP forward of the same model: bit for
        bit at one rank (as measured on the H100: the ring's one step is the
        dense loop, and (o * l) / l in f32 rounds back to the bf16 o); counts
        of the SP forward exact."""
        nonlocal ok, total
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            ref = model(*args).float()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t
            model, forward = parallelize(model)
            reset_launch_counts()
            t = time.perf_counter()
            out = forward(model, *args).float()
            torch.cuda.synchronize()
            sp_s = time.perf_counter() - t
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        paths[label] = per
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        good = bool(torch.isfinite(out).all()) and torch.equal(out, ref)
        log(f"[sp] {label}: plain forward {plain_s:.4f} s, SP forward (1 rank) {sp_s:.4f} s; output "
            f"{tuple(out.shape)}; SP vs plain rel max error {rel:.3e} (bit for bit): {'PASS' if good else 'FAIL'}")
        ok = check_counts(label, counts, per, 1, tag="sp") and good and ok
        return model, forward

    try:
        cfg = FluxConfig(precision="w4a8")
        L, Ls = cfg.num_layers, cfg.num_single_layers
        model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
        side = SP_SIZE // 16
        s_img = side * side
        args = (torch.randn((1, s_img, 64), generator=gen, device=dev).to(torch.bfloat16),
                torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
                torch.tensor([1.0], device=dev), make_img_ids(side, side, dev),
                torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))
        per = {"dequant_w4a8_stacked": 4 * (2 * L + Ls), "gemm_w8a8_gelu_quant": 2 * L + Ls,
               "gemm_w8a8_grouped": 2 * L + Ls, "flash_fixed_denom": L + Ls}
        torch.cuda.reset_peak_memory_stats()
        model, forward = compare(f"FLUX.1-dev w4a8 {SP_SIZE}px", model, parallelize_sequence, args, per)
        n = min(SP_STEPS, steps)
        sigmas = flux_sigmas(n, s_img)
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            lat = torch.randn((1, s_img, 64), generator=gen, device=dev)
            for i in range(n):
                vel = forward(model, lat.to(torch.bfloat16), *args[1:3], torch.full((1,), float(sigmas[i]), device=dev),
                              *args[4:])
                lat = euler_step(lat, vel.float(), sigmas[i], sigmas[i + 1])
        torch.cuda.synchronize()
        req_s = time.perf_counter() - t
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        finite = tuple(lat.shape) == (1, s_img, 64) and bool(torch.isfinite(lat).all())
        log(f"[sp] FLUX.1-dev w4a8 {SP_SIZE}px request through the SP forward, {n} steps to latents: {req_s:.3f} s "
            f"({req_s / n:.4f} s/step); latents {tuple(lat.shape)} finite={finite}, |lat| mean "
            f"{lat.abs().mean().item():.4f}; peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        ok = check_counts(f"{SP_SIZE}px request", counts, per, n, tag="sp") and finite and ok
        del model, forward, args, lat
        torch.cuda.empty_cache()

        qcfg = QwenImageConfig()
        model = QwenImageTransformer2DModel.random_init(qcfg, seed=0, device=dev)
        side = 64
        args = (torch.randn((1, side * side, 64), generator=gen, device=dev).to(torch.bfloat16),
                torch.randn((1, QWEN_S_TXT, qcfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
                torch.tensor([0.7], device=dev), make_img_ids(side, side, dev),
                torch.arange(QWEN_S_TXT, dtype=torch.int32, device=dev)[:, None].repeat(1, 3))
        Lq = qcfg.num_layers
        compare("Qwen-Image int4 1024px", model, parallelize_sequence_qwenimage, args,
                {"gemm_w4a4_int4_stacked": 6 * Lq, "gemm_w4a4_int4_unsigned_stacked": 2 * Lq, "gemv_awq": 2 * Lq,
                 "flash_fixed_denom": Lq})
        del model, args
        torch.cuda.empty_cache()

        zcfg = ZImageConfig(**ZIMAGE, precision="int4", rank=RANK)
        model = ZImageTransformer2DModel.random_init(zcfg, seed=0, device=dev)
        ti = torch.zeros((ZI_TXT, 3), dtype=torch.int32, device=dev)
        ti[:, 0] = torch.arange(ZI_TXT, device=dev)
        side = 64
        args = (torch.randn((1, side * side, 64), generator=gen, device=dev).to(torch.bfloat16),
                torch.randn((1, ZI_TXT, ZI_CAP), generator=gen, device=dev).to(torch.bfloat16),
                torch.tensor([0.3], device=dev), make_img_ids(side, side, dev), ti)
        compare("Z-Image-Turbo int4 1024px", model, parallelize_sequence_zimage, args,
                zimage_per_forward(ZI_MODES["int4"]) | {"flash_fixed": 0, "flash_fixed_denom": ZI_BLOCKS})
        del model, args
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return ok, total, paths


def flux_attn_phase(dev):
    """[flux-attn] FLUX.1-dev at int8 on its stacks, bf16 stream with the
    unfused prologue (tools/ablate_kv_unroll.py's setup: no
    enable_fused_qkv_prep), one 1024px forward each with the default
    attention, attn_kv_unroll = 2 and attn_int8 = True, set through
    set_on_stacks; each after an untimed one, counts exact (57 launches of
    the form's kernel), the output's relative max distance from the default
    forward's within ATTN_TOL. -> (ok, counts of the timed forwards,
    per-forward counts)."""
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    cfg = FluxConfig(precision="int8")
    L, Ls = cfg.num_layers, cfg.num_single_layers
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev).set_stream_dtype(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(6)
    args = (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.tensor([1.0], device=dev), make_img_ids(math.isqrt(S_IMG), math.isqrt(S_IMG), dev),
            torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))
    base = {k: v for k, v in int8_per_forward(L, Ls, True, False).items() if k not in ("qkv_rope_producer", "flash_fixed")}
    ok, total, paths, outs, step_s = True, {}, {}, {}, {}
    for name, (setting, kernel) in ATTN_FORMS.items():
        model.set_on_stacks("attn", **{"attn_kv_unroll": 1, "attn_int8": False, **setting})
        with torch.no_grad():
            model(*args)  # first use, untimed
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            outs[name] = model(*args).float()
            torch.cuda.synchronize()
            step_s[name] = time.perf_counter() - t
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        paths[f"int8 bf16 stream, {name} attention"] = per = base | {kernel: L + Ls}
        finite = tuple(outs[name].shape) == (1, S_IMG, 64) and bool(torch.isfinite(outs[name]).all())
        good = finite
        what = ""
        if name != "default":
            ref = outs["default"]
            rel = ((outs[name] - ref).abs().max() / ref.abs().max()).item()
            good = good and rel <= ATTN_TOL[name]
            what = f"; rel max distance from the default forward {rel:.3e} (tolerance {ATTN_TOL[name]:g})"
        log(f"[flux-attn] {name} ({setting or 'attn_kv_unroll 1, attn_int8 False'}): one 1024px forward "
            f"{step_s[name]:.4f} s, output finite={finite}{what}: {'PASS' if good else 'FAIL'}")
        ok = check_counts(name, counts, per, 1, tag="flux-attn") and good and ok
    model.set_on_stacks("attn", attn_kv_unroll=1, attn_int8=False)
    log(f"[flux-attn] forward seconds: default {step_s['default']:.4f}, kv_unroll2 {step_s['kv_unroll2']:.4f}, "
        f"int8 {step_s['int8']:.4f}")
    del model, outs
    torch.cuda.empty_cache()
    return ok, total, paths


def int8_linear(k, n, r, seed, dev):
    """A random int8 SVDQ linear (K, N) of rank r as the chain and the
    standalone int8 GEMM take it: the (K, N) weight K-contiguous, (1, N)
    scales that bring int8 products of O(1) activations to O(1), bf16 smooth,
    low-rank factors and bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(qweight=torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=g).t(),
                wscales=(torch.rand((1, n), device=dev, generator=g) + 0.5) / (73.0 * math.sqrt(k)),
                smooth=(torch.rand((k,), device=dev, generator=g) * 1.5 + 0.5).to(torch.bfloat16),
                proj_down=(torch.randn((k, r), device=dev, generator=g) * 0.02).to(torch.bfloat16),
                proj_up=(torch.randn((r, n), device=dev, generator=g) * 0.02).to(torch.bfloat16),
                bias=(torch.randn((n,), device=dev, generator=g) * 0.02).to(torch.bfloat16))


def last_ops_chain(lin, x, sc, sh, cos, sin, nq, nk, plain=False):
    """The four entry points chained as a FLUX.1-dev single block's pieces
    meet (tests/test_torch_last_ops.py's chain at full width): the dual
    producer gives the qkv and fc1 activations; fc1 through the pipelined
    chain producer into the grouped int8 consumer (fc2); the qkv product
    through qkv_prepare, token-major, into flash_attention_bshd. ``plain``:
    the four twins instead. -> (mlp (M, DIM), attention (1, S, H, D))."""
    from nunchaku_tpu_torch.ops import attention, gemm, quantize

    to_qkv, fc1, fc2 = lin
    b, s, _ = x.shape
    dual = quantize.ln_mod_quant_int8_dual_plain if plain else quantize.ln_mod_quant_int8_dual
    (qa, sa, laa), (qb, sb, lab) = dual(x, sc, sh, to_qkv["smooth"], to_qkv["proj_down"], fc1["smooth"],
                                        fc1["proj_down"])
    rsm = 1.0 / fc2["smooth"].float()
    chain = (gemm.svdq_gemm_w8a8_gelu_quant_plain if plain
             else lambda *a: gemm.svdq_gemm_w8a8_gelu_quant(*a, pipelined=True))
    qout, qs, la2 = chain(qb, sb, fc1["qweight"], fc1["wscales"], lab, fc1["proj_up"], fc1["bias"], rsm,
                          fc2["proj_down"])
    mlp = gemm.svdq_gemm_w4a4(qout, qs, fc2["qweight"], fc2["wscales"], la2, fc2["proj_up"], fc2["bias"],
                              precision="int8")
    qkv = gemm.svdq_gemm_w4a4(qa, sa, to_qkv["qweight"], to_qkv["wscales"], laa, to_qkv["proj_up"], to_qkv["bias"],
                              precision="int8").reshape(b, s, -1)
    prep = attention.qkv_prepare_plain if plain else attention.qkv_prepare
    q, k, v = (t.transpose(1, 2).contiguous() for t in prep(qkv, cos, sin, nq, nk, heads=HEADS, head_dim=HD))
    if plain:
        return mlp, attention.flash_attention_bshd_plain(q, k, v, bkv=attention.ONLINE_BKV)
    return mlp, attention.flash_attention_bshd(q, k, v)


def last_ops_phase(dev):
    """[last-ops] The path that reaches the four op-level kernels no model
    path calls (nor does the JAX package's): their public entry points,
    chained at FLUX.1-dev's single block at full width (B 1, S 4608, dim
    3072, 24 heads of 128, fc1 12288, random int8 linears), at R 32 and
    again at R 256 (the kernels' ranks above 128, in chunks), counts set to
    0 just before each chain and read just after: one launch each of
    ln_mod_quant_dual, gemm_w8a8_gelu_quant_pipe, qkv_prepare and
    flash_online_bshd, besides the grouped consumer's (the standalone qkv
    product is torch._int_mm). Both ends finite, of their shapes, and within
    2e-2 relative of the same chain through the plain twins on the card.
    -> (ok, counts at R 32, counts at R 256)."""
    from nunchaku_tpu_torch.ops import checks, launch_counts, reset_launch_counts

    s = S_IMG + S_TXT
    streams, cos, sin = checks.qkv_rope_case(1, (s,), HEADS, HD, 0, device=dev)
    nq, nk = streams[0][1:3]
    del streams
    ok, by_rank = True, {}
    for r in (RANK, RANK_HI):
        lin = (int8_linear(DIM, 3 * DIM, r, 1, dev), int8_linear(DIM, HID, r, 2, dev),
               int8_linear(HID, DIM, r, 3, dev))
        x, sc, sh, *_ = checks.ln_mod_quant_case(1, s, DIM, r, device=dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            reset_launch_counts()
            t = time.perf_counter()
            mlp, att = last_ops_chain(lin, x, sc, sh, cos, sin, nq, nk)
            torch.cuda.synchronize()
            took = time.perf_counter() - t
            by_rank[r] = launch_counts()
            mlp_p, att_p = last_ops_chain(lin, x, sc, sh, cos, sin, nq, nk, plain=True)
        want = {"ln_mod_quant_dual": 1, "gemm_w8a8_gelu_quant_pipe": 1, "gemm_w8a8_grouped": 1, "qkv_prepare": 1,
                "flash_online_bshd": 1}
        ok = check_counts(f"entry-point chain R {r}", by_rank[r], want, 1, tag="last-ops") and ok
        for name, out, ref, shape in (("mlp", mlp, mlp_p, (s, DIM)), ("attention", att, att_p, (1, s, HEADS, HD))):
            rel = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            good = tuple(out.shape) == shape and bool(torch.isfinite(out.float()).all()) and rel <= 2e-2
            log(f"[last-ops] R {r} {name} {tuple(out.shape)}: rel max distance from the twins' chain {rel:.3e} "
                f"(tolerance 2e-2), finite: {'PASS' if good else 'FAIL'}")
            ok = ok and good
        log(f"[last-ops] the chain at S {s}, R {r}: {took:.4f} s (first use)")
        del lin, x, sc, sh, mlp, att, mlp_p, att_p
        torch.cuda.empty_cache()
    return ok, by_rank[RANK], by_rank[RANK_HI]


# the GEMM probes' rows: (mode, tools file:line of the TPU kernel body it replaces)
PROBE_I8_ROWS = (("i32", False, "tools/probe_int8_mxu.py:48"), ("f32", False, "tools/bench_gemm_variants.py:107"),
                 ("f32", True, "tools/bench_gemm_variants.py:159"))
PROBE_BF16_ROWS = {("bf16", "bf16", False): "tools/bench_gemm_variants.py:55",
                   ("i8", "i8", False): "tools/probe_m512.py:47",
                   ("p4", "p4", False): "tools/bench_gemm_variants.py:70",
                   ("i8", "i8", True): "tools/bench_gemm_variants.py:81",
                   ("p4", "i8", True): "tools/bench_gemm_variants.py:96",
                   ("p4", "p4", True): "tools/bench_gemm_variants.py:118"}
PROBE_M, PROBE_K, PROBE_N = 4608, 3072, 12288  # bench_gemm_variants.py's shape (row 22a)
# the bf16-operand forms' order factor is also read at probe_m512's shape and a K 12288 tune shape, two seeds
PROBE_ORDER_CASES = (((PROBE_M, PROBE_K, PROBE_N), 1), ((512, 3072, 9216), 0), ((512, 3072, 9216), 1),
                     ((5120, 12288, 3072), 0), ((5120, 12288, 3072), 1))


def probe_bytes(form_a, form_w, m, k, n, scaled=False):
    # a and w in their stored forms (bf16 2 bytes, int8 1, packed int4 half), group scales -> bf16 (M, N)
    size = {"bf16": 2.0, "i8": 1.0, "p4": 0.5}
    return size[form_a] * m * k + size[form_w] * k * n + (2 * (k // 64) * (m + n) if scaled else 0) + 2 * m * n


def probe_kernel_rows(dev, record, failed):
    """22a-22e. The two GEMM probe kernels of the ported tools at row 22a's
    shape (bench_gemm_variants.py: M 4608, K 3072, N 12288), one row per
    mode, each against its plain version: gemm_probe_i8 with int32 or f32
    accumulation and the cast epilogue, and f32 with the rank-1 epilogue, at
    tile "chain" (the int8 chain kernels' own s8 instantiation; bit for bit;
    the mode's other tiles checked and logged with their share of the bound
    and their ratio to the yardstick), torch._int_mm of the product as
    yardstick; gemm_probe_bf16 in its six operand forms (within one bf16 step
    up to the f32 sums' order, checks.check_probe_bf16; the detail gives the
    order factor and that of the product summed in bf16; the factor also
    logged at PROBE_ORDER_CASES), torch.matmul of the decoded bf16 operands
    as yardstick (for bf16 x bf16 the same function)."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.gemm_probe import (I8_BUILT, decode_operand, gemm_probe_bf16, gemm_probe_bf16_plain,
                                                   gemm_probe_i8, gemm_probe_i8_plain, i8_mode)
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    m, k, n = PROBE_M, PROBE_K, PROBE_N
    a, w, sa, sw = checks.probe_i8_case(m, k, n, device=dev)
    lib = time_ms(lambda: int8_matmul(a, w), 20)
    for acc, rank1, replaces in PROBE_I8_ROWS:
        sc = (sa, sw) if rank1 else ()
        bnd = bound(m * k + k * n + 2 * m * n + (4 * (m + n) if rank1 else 0), int8_ops=2 * m * n * k)
        for tile in I8_BUILT[(acc, rank1)]:
            err, ok, detail = checks.check_probe_i8(a, w, *sc, acc=acc, tile=tile)
            ms = time_ms(lambda: gemm_probe_i8(a, w, *sc, acc=acc, tile=tile), 20)
            name = i8_mode(acc, rank1)
            if tile == "chain":
                record(name, "nunchaku_tpu_torch/csrc/gemm_probe_i8.cu", replaces,
                       f"M={m} K={k} N={n} tile {tile}", ok, err, detail, ms,
                       time_ms(lambda: gemm_probe_i8_plain(a, w, *sc, acc=acc), 3), bnd, lib)
            else:
                log(f"[kernel] {name}@{tile} @ M={m} K={k} N={n}: {'PASS' if ok else 'FAIL'} {detail}; {ms:.4f} ms "
                    f"(bound {bnd[0]:.4f} ms by {bnd[1]}, {100 * bnd[0] / ms:.1f}% of bound; torch._int_mm "
                    f"{lib:.4f} ms, {ms / lib:.3f}x it)")
                if not ok:
                    failed.append(f"{name}@{tile}")
    del a, w, sa, sw
    for (af, wf, scaled), replaces in PROBE_BF16_ROWS.items():
        args = checks.probe_bf16_case(m, k, n, af, wf, scaled, device=dev)
        kw = dict(a_form=af, w_form=wf)
        err, ok, detail = checks.check_probe_bf16(*args, **kw)
        dec = (decode_operand(args[0], af, args[2], dim=1), decode_operand(args[1], wf, args[3], dim=0))
        record(f"gemm_probe_bf16_{af}_{wf}{'_scaled' if scaled else ''}", "nunchaku_tpu_torch/csrc/gemm_probe_bf16.cu",
               replaces, f"M={m} K={k} N={n} a {af}, w {wf}{', group-64 scales' if scaled else ''}", ok, err, detail,
               time_ms(lambda: gemm_probe_bf16(*args, **kw), 20),
               time_ms(lambda: gemm_probe_bf16_plain(*args, **kw), 3),
               bound(probe_bytes(af, wf, m, k, n, scaled), bf16_ops=2 * m * n * k),
               time_ms(lambda: torch.matmul(*dec), 20))
        del args, dec
    for (m2, k2, n2), seed in PROBE_ORDER_CASES:
        for af, wf, scaled in PROBE_BF16_ROWS:
            name = f"gemm_probe_bf16_{af}_{wf}{'_scaled' if scaled else ''}"
            args = checks.probe_bf16_case(m2, k2, n2, af, wf, scaled, seed=seed, device=dev)
            _, ok, detail = checks.check_probe_bf16(*args, a_form=af, w_form=wf)
            log(f"[kernel] {name} @ M={m2} K={k2} N={n2} seed {seed}: {'PASS' if ok else 'FAIL'} {detail}")
            if not ok:
                failed.append(f"{name} M={m2} seed {seed}")
            del args
    torch.cuda.empty_cache()


def gemm_probes_phase(dev):
    """[gemm-probes] The path to the two GEMM probe kernels: the four ported
    tools' entry points (nunchaku_tpu_torch/tools: bench_gemm_variants,
    probe_int8_mxu, probe_m512, tune_gemm_impl), each once at its JAX
    script's sizes and iteration counts, every line logged; counts set to 0
    just before and read just after. Every built instantiation of both
    kernels launches, no other kernel but V3's W4A4 GEMM (31 launches of
    gemm_w4a4_int4); every line has a finite time but probe_int8_mxu's D,
    which says why it is not expressible on this card. -> (ok, counts)."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.ops.gemm_probe import COUNTS
    from nunchaku_tpu_torch.tools import bench_gemm_variants, probe_int8_mxu, probe_m512, tune_gemm_impl

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = []
    for mod in (bench_gemm_variants, probe_int8_mxu, probe_m512, tune_gemm_impl):
        tool = mod.__name__.rsplit(".", 1)[1]
        t = time.perf_counter()
        rows += mod.run(dev, log=lambda line, tool=tool: log(f"[gemm-probes] {tool}: {line}"))
        log(f"[gemm-probes] {tool}: {time.perf_counter() - t:.1f} s")
    counts = launch_counts()
    took = time.perf_counter() - t0
    idle = [name for name in COUNTS if counts[name] == 0]
    others = {k: v for k, v in counts.items() if v and k not in COUNTS}
    timed = all(r["ms"] is not None and math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows if not r["note"])
    notes = [r["name"] for r in rows if r["note"]]
    ok = not idle and others == {"gemm_w4a4_int4": 31} and timed and notes == ["D. int8 full-K (bk=3072)"]
    log(f"[gemm-probes] {len(rows)} lines in {took:.1f} s; probe launches "
        f"{ {k: counts[k] for k in COUNTS} }; other kernels {others} (expected {{'gemm_w4a4_int4': 31}}); not "
        f"launched: {idle or 'none'}; every line timed: {timed}; not expressible: {notes}: {'PASS' if ok else 'FAIL'}")
    torch.cuda.empty_cache()
    return ok, counts



def zimage_per_forward(mode: str | None, fused: bool = False, blocks: int = ZI_BLOCKS) -> dict:
    """Launches per Z-Image forward: four 4-bit linears a block in the
    stacked ``mode`` (none at int8), one fixed-shift flash a block, and one
    qkv/RoPE producer a block after the fused prep."""
    per = {"flash_fixed": blocks}
    if mode:
        per[mode] = 4 * blocks
    if fused:
        per["qkv_rope_producer"] = blocks
    return per


def zimage_bounds() -> dict:
    """Least time per Z-Image-Turbo 1024px forward (B 1) for each kernel its
    paths run (the 4-bit GEMMs at rank 32, the packed w4a8 GEMM at request
    C's rank 128): the noise refiner over 4096 image tokens, the
    context refiner over 512 caption tokens and the 30 main layers over the
    4608 joint ones; each block's four linears (qkv, out, w13, w2) and its
    attention over its stream (30 heads of 128); the producer's low-rank
    term is empty (the projections add their own)."""
    d, f = ZI_DIM, ZI_FFN
    streams = ((S_IMG, 2), (ZI_TXT, 2), (ZI_TXT + S_IMG, 30))  # (tokens, blocks)
    shapes = ((d, 3 * d), (d, d), (d, 2 * f), (f, d))

    def per_block(fn):
        return sum(blocks * fn(s) for s, blocks in streams)

    return {
        "gemm_w4a4_int4_stacked": per_block(lambda s: sum(w4a4_bound(s, k, n, 64)[0] for k, n in shapes)),
        "gemm_w4a4_nvfp4_stacked": per_block(lambda s: sum(w4a4_bound(s, k, n, 16)[0] for k, n in shapes)),
        "dequant_w4a8_stacked": ZI_BLOCKS * sum(bound(deq_bytes(k, n))[0] for k, n in shapes),
        "gemm_w4a8_stacked": per_block(lambda s: sum(bound(w4a8_bytes(s, k, n, 128), 2 * s * n * k, 2 * s * n * 128)[0]
                                                     for k, n in shapes)),
        "flash_fixed": per_block(lambda s: bound(4 * s * ZI_HEADS * HD * 2, bf16_ops=4 * s * s * HD * ZI_HEADS)[0]),
        "qkv_rope_producer": per_block(lambda s: bound(2 * s * 3 * d + 8 * s * HD + 4 * HD + 2 * s * 3 * d)[0]),
    }


def sdxl_per_forward(unet) -> dict:
    """Launches per UNet forward: two D-64 attentions and six SVDQ linears
    (qkv, out; to_q, out; the GEGLU's two) per transformer block, the
    linears on the W4A4 kernel at int4."""
    from nunchaku_tpu_torch.models.unet_sdxl import SDXLTransformerBlock

    blocks = sum(isinstance(m, SDXLTransformerBlock) for m in unet.modules())
    return {"flash_online_d64": 2 * blocks} | ({"gemm_w4a4_int4": 6 * blocks} if unet.cfg.precision == "int4" else {})


def sdxl_bounds(size=1024) -> dict:
    """Least time per SDXL UNet forward at ``size`` px for each kernel it
    runs: every block's self- and cross-attention (77 text keys) and its six
    W4A4 GEMMs, per level: the products at the logical K, the bytes of the
    launched buffers (K padded to 256: level 1's 640 -> 768)."""
    out = {"flash_online_d64": 0.0, "gemm_w4a4_int4": 0.0}
    side = size // 16  # level 1's token grid (VAE stride 8, one 2x downsample)
    for lvl, (width, heads, blocks) in enumerate(SDXL_LEVELS):
        m = (side >> lvl) ** 2
        out["flash_online_d64"] += blocks * sum(online_bound(1, heads, m, skv, SDXL_D)[0] for skv in (m, SDXL_CTX))
        shapes = ((width, 3 * width), (width, width), (width, width), (width, width), (width, 8 * width),
                  (4 * width, width))
        out["gemm_w4a4_int4"] += blocks * sum(w4a4_bound(m, k + (-k) % 256, n, 64, k_ops=k)[0] for k, n in shapes)
    return out


def sdxl_phase(dev, steps: int):
    """[sdxl] Full-width, full-depth SDXL (SDXLConfig(): int4, 70 transformer
    blocks) from random weights with the SDXL VAE (latent 4, scaling
    0.13025, shift 0, tiled decode) through SDXLPipeline: request A at
    1024x1024, CFG 5.0 with negative embeddings, min(4, steps) of the
    default 30 steps (a step-count cut), to an image; request B, the
    SDXL-Turbo preset of examples/sdxl.py (512x512, 4 steps, guidance 0), to
    an image. Embeddings (1, 77, 2048) and pooled (1, 1280) random from
    seeds. Each request runs once untimed first (first-use work), then twice
    timed; launches exact per forward (two forwards a CFG step), plus the
    decode's flash_online. -> (ok, counts, per-forward counts by request)."""
    from nunchaku_tpu_torch import AutoencoderKL, SDXLConfig, SDXLPipeline, SDXLUNet2DConditionModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = SDXLConfig()
    t0 = time.perf_counter()
    unet = SDXLUNet2DConditionModel.random_init(cfg, seed=0, device=dev)
    vae = AutoencoderKL.random_init(seed=1, latent_channels=4, scaling_factor=0.13025, shift_factor=0.0, device=dev)
    vae.enable_tiling()
    torch.cuda.synchronize()
    per = sdxl_per_forward(unet)
    log(f"[sdxl] SDXL {cfg.precision}: channels {cfg.block_out_channels}, transformer layers "
        f"{cfg.transformer_layers} ({per['flash_online_d64'] // 2} blocks), head dim {cfg.head_dim}, cross "
        f"{cfg.cross_attention_dim}, rank {cfg.rank}; UNet weights {_gib(unet):.2f} GiB, VAE {_gib(vae):.2f} GiB, "
        f"random init {time.perf_counter() - t0:.1f} s")
    pipe = SDXLPipeline(unet, vae=vae)

    def embeds(seed, negative):
        gen = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        kw = dict(prompt_embeds=rnd(1, SDXL_CTX, cfg.cross_attention_dim), pooled_prompt_embeds=rnd(1, 1280))
        if negative:
            kw |= dict(negative_prompt_embeds=rnd(1, SDXL_CTX, cfg.cross_attention_dim),
                       negative_pooled_prompt_embeds=rnd(1, 1280))
        return kw

    ok, total, paths = True, {}, {}
    for label, size, n, guidance in (("A: 1024px, CFG 5.0", 1024, min(4, steps), 5.0),
                                     ("B: SDXL-Turbo preset, 512px, guidance 0", SDXL_TURBO, min(4, steps), 0.0)):
        cfg_on = guidance > 1.0
        call = dict(height=size, width=size, guidance_scale=guidance)
        with torch.no_grad():
            pipe(**embeds(99, cfg_on), num_inference_steps=1, **call)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        req_s = []
        for seed in range(2):
            prompt = embeds(seed, cfg_on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(**prompt, num_inference_steps=n, seed=seed, **call)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t0)
            lat, img = out.latents, out.images
            good = (tuple(lat.shape) == (1, 4, size // 8, size // 8) and bool(torch.isfinite(lat).all())
                    and tuple(img.shape) == (1, size, size, 3) and img.dtype == torch.float32
                    and bool(torch.isfinite(img).all()) and img.min().item() >= 0.0 and img.max().item() <= 1.0)
            ok = ok and good
            log(f"[sdxl] {label} request seed={seed}: {req_s[-1]:.3f} s ({req_s[-1] / n:.4f} s/step, "
                f"{n * (2 if cfg_on else 1)} UNet forwards), latents {tuple(lat.shape)} |lat| mean "
                f"{lat.abs().mean().item():.4f}, images {tuple(img.shape)} min {img.min().item():.4f} max "
                f"{img.max().item():.4f} mean {img.mean().item():.4f}: finite and in [0, 1] {good}")
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[sdxl] {label}: 2 requests x {n} steps; s/request {[round(x, 3) for x in req_s]}, s/step (last) "
            f"{req_s[-1] / n:.4f}; peak allocated {peak:.2f} GiB")
        paths[f"sdxl {size}px"] = per
        ok = check_counts(f"sdxl {label}", counts, per, 2 * n * (2 if cfg_on else 1),
                          {"flash_online": 2 * SDXL_VAE_TILES[size]}, tag="sdxl") and ok
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del pipe, unet, vae
    torch.cuda.empty_cache()
    return ok, total, paths


SANA_SMALL = dict(num_layers=2, num_attention_heads=7, num_cross_attention_heads=2, caption_channels=96,
                  pag_layers=(1,))  # tests/test_torch_sana.py's TINY: dim 224, cross head dim 112, odd widths


def reference_sana(dev):
    """The small SANA of the CPU tests (2 blocks, dim 224, 2 cross heads of
    112, every quantized width odd, PAG on block 1), card against CPU with
    the same weights and inputs, at the bounds the CPU tests hold the port
    to against JAX (twice the spread of the JAX package's own two GEMM
    routes): int4, one forward at B 2 without and with PAG on batch row 1
    (4e-2); int8, 2 steps of SanaPipeline with CFG 4.5 (4.5e-2). Every
    cross-attention on the D-112 kernel (2 a forward), every int4 SVDQ
    linear on the W4A4 kernel (12 a forward, 14 under PAG)."""
    from nunchaku_tpu_torch import SanaConfig, SanaPipeline, SanaTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    gen = torch.Generator().manual_seed(15)
    x = torch.randn((2, 256, 32), generator=gen).to(torch.bfloat16)
    c = torch.randn((2, 40, 96), generator=gen).to(torch.bfloat16)
    t = torch.tensor([0.7, 0.3])
    rows = torch.tensor([False, True])
    all_ok = True
    cpu_model = SanaTransformer2DModel.random_init(SanaConfig(**SANA_SMALL), seed=16, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    for pag in (False, True):
        kw = dict(pag=True, pag_layers=(1,), pag_rows=rows) if pag else {}
        with torch.no_grad():
            ref = cpu_model(x, c, t, **kw).float()
            reset_launch_counts()
            out = gpu_model(x.to(dev), c.to(dev), t.to(dev), **{k: (v.to(dev) if k == "pag_rows" else v)
                                                               for k, v in kw.items()}).float().cpu()
            cnt = launch_counts()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        want = (2, 14 if pag else 12)
        ok = (bool(torch.isfinite(out).all()) and rel <= 4e-2
              and (cnt["flash_online_d112"], cnt["gemm_w4a4_int4"]) == want)
        log(f"[reference] SANA small (2 blocks, dim 224, cross head dim 112) int4 forward B 2{' with PAG on row 1' if pag else ''}: "
            f"card vs CPU rel max error {rel:.3e} (tolerance 4e-2); launches flash_online_d112 "
            f"{cnt['flash_online_d112']}, gemm_w4a4_int4 {cnt['gemm_w4a4_int4']} (expected {want}): "
            f"{'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
    cpu8 = SanaTransformer2DModel.random_init(SanaConfig(**SANA_SMALL, precision="int8"), seed=17, device="cpu")
    gpu8 = copy.deepcopy(cpu8).to(dev)
    pe = torch.randn((1, 40, 96), generator=gen).to(torch.bfloat16)
    lat = torch.randn((1, 256, 32), generator=gen)
    kw = dict(height=512, width=512, num_inference_steps=2, guidance_scale=4.5)
    ref = SanaPipeline(cpu8)(prompt_embeds=pe, latents=lat, **kw).latents
    reset_launch_counts()
    out = SanaPipeline(gpu8)(prompt_embeds=pe.to(dev), latents=lat.to(dev), **kw).latents.cpu()
    cnt = launch_counts()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    ok = bool(torch.isfinite(out).all()) and rel <= 4.5e-2 and cnt["flash_online_d112"] == 4
    log(f"[reference] SANA small int8, 2 steps of SanaPipeline at 512x512 with CFG 4.5 (B 2): card vs CPU latents rel "
        f"max error {rel:.3e} (tolerance 4.5e-2); flash_online_d112 {cnt['flash_online_d112']} (expected 4): "
        f"{'PASS' if ok else 'FAIL'}")
    return all_ok and ok


def sana_per_forward(model, pag: bool = False) -> dict:
    """Launches per SANA forward: the D-112 flash once a block (the
    cross-attention), six SVDQ linears a block on the W4A4 kernel at int4
    (qkv, out; q, out; inverted, point), two more on each PAG layer under
    PAG (the perturbed branch's pag_to_v and out_proj)."""
    L = model.cfg.num_layers
    extra = 2 * len(model.cfg.pag_layers or ()) if pag else 0
    return {"flash_online_d112": L, "gemm_w4a4_int4": 6 * L + extra}


def sana_bounds(b=2, pag_layers=0) -> dict:
    """Least time per SANA 1.6B 1024px forward at batch ``b`` for each kernel
    it runs: every block's cross-attention (300 text keys) and its six W4A4
    GEMMs (M = b * 1024), the products at the logical widths, the bytes of
    the padded buffers (K 2240 -> 2304, 5600 -> 5632)."""
    m, d, h = b * SANA_S, SANA_DIM, SANA_HID
    shapes = ((d, 3 * d), (d, d), (d, d), (d, d), (d, 2 * h), (h, d))
    gemm = sum(w4a4_bound(m, k + (-k) % 256, n, 64, k_ops=k)[0] for k, n in shapes)
    return {"flash_online_d112": 20 * online_bound(b, SANA_HEADS, SANA_S, SANA_TXT, SANA_D)[0],
            "gemm_w4a4_int4": 20 * gemm + 2 * pag_layers * w4a4_bound(m, d + (-d) % 256, d, 64, k_ops=d)[0]}


def sana_phase(dev, steps: int):
    """[sana] SANA 1.6B (SanaConfig(): int4, 20 blocks, dim 2240, cross
    head dim 112, PAG projections on block 8) from random weights made from
    seeds, with Gemma-2-2B at full size (26 layers, d 2304, vocab 256000)
    from random weights and the stand-in tokenizer, and the DC-AE f32c32
    from synthesize_dcae_state_dict(DCAEConfig()), through SanaPipeline from
    prompts at 1024x1024: request A, CFG 4.5 (B 2), min(4, steps) of the
    default 20 steps (a step-count cut), to an image; B, PAG 2.0 with CFG
    4.5 (B 3), 2 steps; C, cache="fb" at guidance 1, min(8, steps) steps
    (hits from the counts: a hit runs block 0 only); D, a synthesized
    svdq-int4_r32-sana1.6b file (nunchaku's v1 schema, the odd widths
    padded) through load_sana_transformer, one step. Each request runs once
    untimed first; then 2 timed requests (D: 1); launches exact per forward
    (no port kernel in Gemma-2 or the DC-AE). -> (ok, counts, per-forward
    counts by request)."""
    import tempfile

    from nunchaku_tpu_torch import (DCAE, DCAEConfig, Gemma2Encoder, SanaConfig, SanaPipeline, SanaTransformer2DModel,
                                    load_sana_transformer)
    from nunchaku_tpu_torch.models.text_encoders.gemma2 import GEMMA2_2B
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    t_phase = t0 = time.perf_counter()
    cfg = SanaConfig(pag_layers=SANA_PAG_LAYERS)
    model = SanaTransformer2DModel.random_init(cfg, seed=0, device=dev)
    gemma = Gemma2Encoder.random_init(**GEMMA2_2B, seed=1, device=dev)
    t1 = time.perf_counter()
    vae = DCAE.random_init(DCAEConfig(), seed=2, device=dev)
    torch.cuda.synchronize()
    log(f"[sana] SANA 1.6B {cfg.precision}: {cfg.num_layers} blocks, dim {cfg.dim}, cross {cfg.num_cross_attention_heads} "
        f"heads of {cfg.dim // cfg.num_cross_attention_heads}, FF {cfg.ff_hidden}, rank {cfg.rank}, PAG layers "
        f"{cfg.pag_layers}; weights {_gib(model):.2f} GiB, Gemma-2-2B {_gib(gemma):.2f} GiB, DC-AE {_gib(vae):.2f} GiB; "
        f"random init {t1 - t0:.1f} s (transformer + Gemma-2), {time.perf_counter() - t1:.1f} s (DC-AE, numpy state dict)")
    tok = stand_in_tokenizer(GEMMA_VOCAB, GEMMA_EOS)
    ok, total, paths = True, {}, {}

    def run(label, pipe, n, requests, per, **call):
        """One untimed request, then ``requests`` timed ones; -> counts."""
        nonlocal ok
        size = 1024
        with torch.no_grad():
            pipe(prompt=PROMPTS[-1], num_inference_steps=1, seed=99, **call)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        req_s = []
        for seed in range(requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(prompt=PROMPTS[seed % len(PROMPTS)], num_inference_steps=n, seed=seed, **call)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t0)
            lat, img = out.latents, out.images
            good = (tuple(lat.shape) == (1, 32, size // 32, size // 32) and bool(torch.isfinite(lat).all())
                    and tuple(img.shape) == (1, size, size, 3) and img.dtype == torch.float32
                    and bool(torch.isfinite(img).all()) and img.min().item() >= 0.0 and img.max().item() <= 1.0)
            ok = ok and good
            log(f"[sana] {label} request seed={seed}: {req_s[-1]:.3f} s ({req_s[-1] / n:.4f} s/step), latents "
                f"{tuple(lat.shape)} |lat| mean {lat.abs().mean().item():.4f}, images {tuple(img.shape)} min "
                f"{img.min().item():.4f} max {img.max().item():.4f} mean {img.mean().item():.4f}: finite and in "
                f"[0, 1] {good}")
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[sana] {label}: {requests} request(s) x {n} steps; s/request {[round(x, 3) for x in req_s]}, s/step "
            f"(last) {req_s[-1] / n:.4f}; peak allocated {peak:.2f} GiB")
        paths[f"sana {label.split(':')[0]}"] = per
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return counts

    pipe = SanaPipeline(model, vae=vae, text_encoder=gemma, tokenizer=tok)
    na, nc = min(4, steps), min(8, steps)
    per = sana_per_forward(model)
    counts = run("A: 1024px, CFG 4.5 (B 2)", pipe, na, 2, per, guidance_scale=4.5)
    ok = check_counts("sana A", counts, per, 2 * na, tag="sana") and ok
    per_pag = sana_per_forward(model, pag=True)
    counts = run("B: PAG 2.0 + CFG 4.5 (B 3)", pipe, 2, 2, per_pag, guidance_scale=4.5, pag_scale=2.0)
    ok = check_counts("sana B", counts, per_pag, 2 * 2, tag="sana") and ok
    counts = run('C: cache="fb", guidance 1', pipe, nc, 2, per, guidance_scale=1.0, cache="fb")
    fwd, L = 2 * nc, cfg.num_layers
    hits = (L * fwd - counts["flash_online_d112"]) // (L - 1)
    want = {k: per[k] * (fwd - hits) for k in per}
    want["flash_online_d112"] += hits
    want["gemm_w4a4_int4"] += 6 * hits
    c_ok = all(counts[k] == want.get(k, 0) for k in counts) and 0 <= hits < fwd
    log(f"[sana] C: cache hits {hits} of {fwd} steps (a hit runs block 0 only: 1 flash_online_d112, 6 "
        f"gemm_w4a4_int4); launches {counts}; expected {want}: {'PASS' if c_ok else 'FAIL'}")
    ok = ok and c_ok
    del pipe, model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="nunchaku_sana_") as tmp:
        path = f"{tmp}/svdq-int4_r32-sana1.6b.safetensors"
        _write(synth, path, lambda: synth.sana_state(seed=3, device=dev), "SANA 1.6B int4 rank 32 (v1 schema)",
               tag="sana")
        loaded, _ = _load("SANA 1.6B int4 from the file", lambda: load_sana_transformer(path, device=dev), tag="sana")
        per = sana_per_forward(loaded)
        counts = run("D: synthesized svdq-int4_r32-sana1.6b file, CFG 4.5", SanaPipeline(
            loaded, vae=vae, text_encoder=gemma, tokenizer=tok), 1, 1, per, guidance_scale=4.5)
        ok = check_counts("sana D", counts, per, 1, tag="sana") and ok
        del loaded
    del vae, gemma
    torch.cuda.empty_cache()
    log(f"[sana] phase {time.perf_counter() - t_phase:.1f} s (models, four requests with their untimed runs, the file)")
    return ok, total, paths


ZIMAGE_SMALL = dict(dim=512, num_layers=2, num_refiner_layers=1, num_attention_heads=4, cap_feat_dim=512,
                    ffn_inner=1024)  # tests/test_torch_zimage.py's tiny config: 4 blocks
# the CPU tests' bounds against JAX (twice the JAX package's own route spread): the forward by precision, the int8
# 2-step CFG pipeline
ZIMAGE_SMALL_TOL = {"int4": 3.7e-2, "nvfp4": 2.6e-2, "w4a8": 7.8e-3, "int8": 6.4e-3}
ZIMAGE_SMALL_PIPE_TOL = 3.2e-2


def reference_zimage(dev):
    """The small Z-Image of the CPU tests (dim 512, 4 heads of 128, 2 layers,
    1 + 1 refiners; its adaLN damped, checks.damp_zimage_modulation) card
    against CPU with the same weights and inputs, at the bounds the CPU
    tests hold the port to against JAX: one forward at int4, int4 after the
    fused prep, nvfp4, w4a8 on the dequant route and on the packed route
    (NUNCHAKU_TPU_W4A8_XLA=0), each with its launches exact (four stacked
    launches a block of the active mode, one flash_fixed a block, one
    producer a block when fused); then 2 steps of ZImagePipeline at int8
    with CFG 4.0."""
    from nunchaku_tpu_torch import ZImageConfig, ZImagePipeline, ZImageTransformer2DModel
    from nunchaku_tpu_torch.ops import checks, launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    gen = torch.Generator().manual_seed(23)
    x = torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16)
    c = torch.randn((1, 64, 512), generator=gen).to(torch.bfloat16)
    t = torch.tensor([0.5])
    ii, ti = make_img_ids(16, 16), torch.zeros((64, 3), dtype=torch.int32)
    blocks = ZIMAGE_SMALL["num_layers"] + 2 * ZIMAGE_SMALL["num_refiner_layers"]
    all_ok = True
    for precision, variant in (("int4", "plain"), ("int4", "fused"), ("nvfp4", "plain"), ("w4a8", "plain"),
                               ("w4a8", "packed")):
        cpu_model = ZImageTransformer2DModel.random_init(ZImageConfig(**ZIMAGE_SMALL, precision=precision), seed=24,
                                                         device="cpu")
        checks.damp_zimage_modulation(cpu_model)
        if variant == "fused":
            cpu_model.enable_fused_qkv_prep()
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        with contextlib.ExitStack() as stack:
            if variant == "packed":
                stack.enter_context(packed_route())
            with torch.no_grad():
                ref = cpu_model(x, c, t, ii, ti).float()
                reset_launch_counts()
                out = gpu_model(x.to(dev), c.to(dev), t.to(dev), ii, ti).float().cpu()
            cnt = {k: v for k, v in launch_counts().items() if v}
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        mode = ZI_MODES["w4a8 packed" if variant == "packed" else precision]
        want = zimage_per_forward(mode, variant == "fused", blocks)
        ok = bool(torch.isfinite(out).all()) and rel <= ZIMAGE_SMALL_TOL[precision] and cnt == want
        log(f"[reference] Z-Image small (dim 512, {blocks} blocks, stacked) {precision} {variant} forward: card vs "
            f"CPU rel max error {rel:.3e} (tolerance {ZIMAGE_SMALL_TOL[precision]:g}); launches {cnt} (expected "
            f"{want}): {'PASS' if ok else 'FAIL'}")
        all_ok = all_ok and ok
    cpu8 = ZImageTransformer2DModel.random_init(ZImageConfig(**ZIMAGE_SMALL, precision="int8"), seed=25, device="cpu")
    checks.damp_zimage_modulation(cpu8)
    gpu8 = copy.deepcopy(cpu8).to(dev)
    pe, ne = (torch.randn((1, 64, 512), generator=gen).to(torch.bfloat16) for _ in range(2))
    lat = torch.randn((1, 256, 64), generator=gen)
    kw = dict(height=256, width=256, num_inference_steps=2, guidance_scale=4.0)
    ref = ZImagePipeline(cpu8)(pe, negative_prompt_embeds=ne, latents=lat, **kw).latents.float()
    reset_launch_counts()
    out = ZImagePipeline(gpu8)(pe.to(dev), negative_prompt_embeds=ne.to(dev), latents=lat.to(dev),
                               **kw).latents.float().cpu()
    cnt = launch_counts()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    ok = bool(torch.isfinite(out).all()) and rel <= ZIMAGE_SMALL_PIPE_TOL and cnt["flash_fixed"] == 4 * blocks
    log(f"[reference] Z-Image small int8, 2 steps of ZImagePipeline with CFG 4.0 (two forwards a step): card vs CPU "
        f"latents rel max error {rel:.3e} (tolerance {ZIMAGE_SMALL_PIPE_TOL:g}); flash_fixed {cnt['flash_fixed']} "
        f"(expected {4 * blocks}): {'PASS' if ok else 'FAIL'}")
    return all_ok and ok


def zimage_phase(dev, steps: int):
    """[zimage] Z-Image-Turbo's transformer at full width and depth (ZIMAGE:
    34 blocks, dim 3840) through ZImagePipeline at 1024x1024 from prompt
    embeddings (1, 512, 2560), every 4-bit linear reading its layer out of
    its stack by a device-resident index: request A, int4 rank 32 from random
    weights made from seeds, the Turbo preset (min(8, steps) steps, guidance
    0, shift 3.0) to images through the tiled FLUX VAE, 2 timed requests;
    B, the same model after enable_fused_qkv_prep(), CFG 4.0 with negative
    embeddings (two forwards a step), 2 steps to latents, 2 requests; C, a
    synthesized svdq-int4_r128-z-image-turbo file (v2 schema) loaded at
    int4, at w4a8 (the stacked dequant) and the w4a8 load again under
    NUNCHAKU_TPU_W4A8_XLA=0 (the packed GEMM's stacked mode), one 1-step
    request each; D, a synthesized svdq-fp4_r32 file at nvfp4 and at w4a8
    (which loads int8: no stacked kernel), one 1-step request each. Every
    request runs once untimed first; files live in a temporary directory,
    deleted after; launches exact per forward. -> (ok, counts, per-forward
    counts by request)."""
    import tempfile

    from nunchaku_tpu_torch import (AutoencoderKL, ZImageConfig, ZImagePipeline, ZImageTransformer2DModel,
                                    load_zimage_transformer)
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    t_phase = t0 = time.perf_counter()
    cfg = ZImageConfig(**ZIMAGE, precision="int4", rank=RANK)
    model = ZImageTransformer2DModel.random_init(cfg, seed=0, device=dev)
    vae = AutoencoderKL.random_init(seed=4, device=dev)
    vae.enable_tiling()
    torch.cuda.synchronize()
    log(f"[zimage] Z-Image-Turbo {cfg.precision} r{cfg.rank}: {cfg.num_layers} + {cfg.num_refiner_layers} + "
        f"{cfg.num_refiner_layers} blocks, dim {cfg.dim}, {cfg.num_attention_heads} heads of {cfg.head_dim}, FFN "
        f"{cfg.inner_ffn}, caption {cfg.cap_feat_dim}, t_dim {cfg.t_dim}; weights {_gib(model):.2f} GiB; random init "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(7)
    pe = [torch.randn((1, ZI_TXT, ZI_CAP), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
    neg = (torch.randn((1, ZI_TXT, ZI_CAP), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    ok, total, paths = True, {}, {}

    def run(label, pipe, n, requests, per, forwards_per_step=1, key=None, **call):
        """One untimed 1-step request, then ``requests`` timed ones with the
        counts reset just before them; checks outputs and launches. ``key``:
        the path's name in the per-forward table (default: the label's
        letter)."""
        nonlocal ok
        with torch.no_grad():
            pipe(pe[-1], num_inference_steps=1, seed=99, **call)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        req_s = []
        for seed in range(requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(pe[seed % 2], num_inference_steps=n, seed=seed, **call)
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t0)
            lat = out.latents
            good = tuple(lat.shape) == (1, S_IMG, 64) and bool(torch.isfinite(lat.float()).all())
            what = f"latents {tuple(lat.shape)} |lat| mean {lat.float().abs().mean().item():.4f}"
            if pipe.vae is not None:
                img = out.images
                good = good and (tuple(img.shape) == (1, 1024, 1024, 3) and img.dtype == torch.float32
                                 and bool(torch.isfinite(img).all()) and img.min().item() >= 0.0
                                 and img.max().item() <= 1.0)
                what += (f", images {tuple(img.shape)} min {img.min().item():.4f} max {img.max().item():.4f} mean "
                         f"{img.mean().item():.4f}")
            ok = ok and good
            log(f"[zimage] {label} request seed={seed}: {req_s[-1]:.3f} s ({req_s[-1] / n:.4f} s/step), {what}: "
                f"finite{' and in [0, 1]' if pipe.vae is not None else ''} {good}")
        counts = launch_counts()
        log(f"[zimage] {label}: {requests} request(s) x {n} steps; s/request {[round(x, 3) for x in req_s]}, s/step "
            f"(last) {req_s[-1] / n:.4f}; peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        extra = {"flash_online": VAE_TILES * requests} if pipe.vae is not None else None
        key = key or f"zimage {label.split(':')[0]}"
        ok = check_counts(key, counts, per, forwards_per_step * n * requests, extra, tag="zimage") and ok
        paths[key] = per
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    na = min(8, steps)
    run("A: 1024px Turbo preset (guidance 0), int4 r32, tiled FLUX VAE", ZImagePipeline(model, vae=vae), na, 2,
        zimage_per_forward(ZI_MODES["int4"]), guidance_scale=0.0)
    model.enable_fused_qkv_prep()
    run("B: fused qkv prep, CFG 4.0 with negative embeddings (2 forwards a step), to latents", ZImagePipeline(model),
        2, 2, zimage_per_forward(ZI_MODES["int4"], fused=True), 2, guidance_scale=4.0, negative_prompt_embeds=neg)
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="nunchaku_zimage_") as tmp:
        for label, file_precision, rank, loads in (
                ("C", "int4", 128, (("int4", "int4", False), ("w4a8", "w4a8", False), ("w4a8", "w4a8 packed", True))),
                ("D", "nvfp4", RANK, (("nvfp4", "nvfp4", False), ("w4a8", "int8", False)))):
            name = f"svdq-{'fp4' if file_precision == 'nvfp4' else 'int4'}_r{rank}-z-image-turbo"
            path = f"{tmp}/{name}.safetensors"
            _write(synth, path, lambda: synth.zimage_state(rank=rank, precision=file_precision, seed=5, device=dev),
                   f"{name} (v2 schema)", tag="zimage")
            loaded = None
            for precision, served, packed in loads:
                if loaded is None or not packed:
                    del loaded
                    torch.cuda.empty_cache()
                    loaded, _ = _load(f"{name} at precision={precision!r}",
                                      lambda: load_zimage_transformer(path, precision=precision, device=dev),
                                      tag="zimage")
                    if loaded.cfg.precision != served.split()[0]:
                        ok = False
                        log(f"[zimage] {name} at {precision!r} loaded as {loaded.cfg.precision}, expected "
                            f"{served}: FAIL")
                with packed_route() if packed else contextlib.nullcontext():
                    run(f"{label}: {name} served at {served}, 1 step", ZImagePipeline(loaded), 1, 1,
                        zimage_per_forward(ZI_MODES[served]), key=f"zimage {label} {served}")
            del loaded
            torch.cuda.empty_cache()
    del vae
    torch.cuda.empty_cache()
    log(f"[zimage] phase {time.perf_counter() - t_phase:.1f} s (model, requests A-D with their untimed runs, the "
        f"files)")
    return ok, total, paths


# ---------------------------------------------------------------------------
# image-conditioned requests: [kontext] (FLUX.1 Kontext / TeaCache / Fill / Canny-Depth) and [qwen-edit]
# ---------------------------------------------------------------------------


def reference_image(size, seed, dev, b=1):
    """(b, size, size, 3) in [0, 1], drawn on the card from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((b, size, size, 3), generator=gen, device=dev)


def cond_merge(res, key, ok, counts):
    """Add one request's verdict and launch counts to the phase record ``res[key]``."""
    old_ok, old = res.get(key, (True, {}))
    res[key] = (old_ok and ok, {k: old.get(k, 0) + counts.get(k, 0) for k in set(old) | set(counts)})


def kontext_request(enc, ref, make):
    """A request whose Kontext tokens are prepared inside it (``enc``: a
    pipeline holding the VAE), for a pipeline without a VAE (to latents)."""
    def args():
        tok, ids = enc.prepare_kontext(ref)
        return dict(make(), cond_tokens=tok, cond_ids=ids)
    return args


def encode_alone(vae, dev, res):
    """[kontext] One 1024px encode timed alone (after one untimed): s, peak,
    the mid block's flash_online launch."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    img = reference_image(KONTEXT_REF, 40, dev)
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        z = vae.encode(img)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = launch_counts()
    n = counts["flash_online"]
    good = (tuple(z.shape) == (1, 16, KONTEXT_REF // 8, KONTEXT_REF // 8) and z.dtype == torch.bfloat16
            and bool(torch.isfinite(z.float()).all()) and n == 1 and sum(counts.values()) == 1)
    log(f"[kontext] encode alone of a {KONTEXT_REF}px image (the FLUX VAE's encoder, mid block over "
        f"{(KONTEXT_REF // 8) ** 2} tokens of {VAE_D}): {sec:.4f} s, latents {tuple(z.shape)} |z| mean "
        f"{z.float().abs().mean().item():.4f}, flash_online launches {n} (expected 1, no other kernel), peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (transformer resident): "
        f"{'PASS' if good else 'FAIL'}")
    cond_merge(res, "kontext", good, counts)


def kontext_turbo(dev, steps, model, vae, t5, cfg, paths, res):
    """[kontext] on the slice's w4a8 turbo model: the encode alone; the
    Kontext request as bench.py serves its image path (T5-XXL encode inside,
    double_fb at 0.5, tiled decode) with a 1024px reference encoded inside
    the request, guidance 2.5, min(4, steps) steps; a 1008px reference (3969
    tokens, no multiple of the tiles) 1 step to latents."""
    from nunchaku_tpu_torch.caching.fbcache import make_hit_schedule
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    encode_alone(vae, dev, res)
    dual, single = W4A8_TURBO_DUAL, W4A8_TURBO_SINGLE
    n = min(4, steps)
    hits = int(make_hit_schedule(n, 0.5).sum())
    ref = reference_image(KONTEXT_REF, 41, dev)
    finite, _, counts, peak, req_hits, _ = serve(
        FluxPipeline(model, vae=vae), dev, n, 1,
        f"Kontext w4a8 turbo ({KONTEXT_REF}px reference encoded inside, S_img {S_IMG} + S_cond {KONTEXT_S_COND}, "
        f"T5-XXL encode, guidance 2.5, double_fb 0.5, tiled VAE)", t5_request(cfg, dev, t5), tag="kontext",
        image=ref, guidance_scale=2.5, cache="double_fb", cache_hit_ratio=0.5)
    hit_runs = {k: (dual[k] + single[k]) * hits for k in dual}
    ok = finite and req_hits == [hits] and check_counts(
        "kontext turbo", counts, paths["turbo"], n - hits, hit_runs | {"flash_online": 1 + VAE_TILES}, tag="kontext")
    cond_merge(res, "kontext", ok, counts)
    enc = FluxPipeline(None, vae=vae)
    odd = reference_image(ODD_REF, 42, dev)
    embeds = embeds_request(cfg, dev)
    finite, _, counts, *_ = serve(
        FluxPipeline(model), dev, 1, 1, f"Kontext w4a8 turbo, {ODD_REF}px reference (S_cond {ODD_S_COND}), to latents",
        lambda seed: kontext_request(enc, odd, embeds(seed)), tag="kontext", guidance_scale=2.5)
    # an MLP whose rows the chain pads to 128 takes the plain consumer and adds its gated residual after the
    # slice (models/attention.py gelu_mlp, as JAX): the dual image stream (4096 + 3969 rows) and the single
    # stream (512 + 8065), not the dual text stream (512)
    L, Ls = cfg.num_layers, cfg.num_single_layers
    fused = (L * sum(rows % 128 == 0 for rows in (S_IMG + ODD_S_COND, S_TXT))
             + Ls * ((S_TXT + S_IMG + ODD_S_COND) % 128 == 0))
    odd_path = dict(paths["turbo"], gemm_w8a8_grouped_res=fused, gemm_w8a8_grouped=2 * L + Ls - fused)
    log(f"[kontext] odd reference: {2 * L + Ls - fused} of {2 * L + Ls} MLP consumers on padded rows (plain "
        f"consumer, residual add after the slice)")
    ok = finite and check_counts("kontext turbo odd reference", counts, odd_path, 1, {"flash_online": 1},
                                 tag="kontext")
    cond_merge(res, "kontext", ok, counts)


def kontext_int4(dev, steps, model, vae, cfg, paths, res):
    """[kontext] on the slice's int4 model (default configuration):
    FLUX.1-Kontext with TeaCache (the "flux-kontext" coefficients, threshold
    0.6), a 1024px reference encoded inside, min(8, steps) steps to an image
    (a hit runs block 0's norm1 alone: one gemv_awq); a 1008px reference 1
    step to latents."""
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline

    n = min(8, steps)
    ref = reference_image(KONTEXT_REF, 43, dev)
    embeds = embeds_request(cfg, dev)
    finite, _, counts, _, req_hits, _ = serve(
        FluxPipeline(model, vae=vae), dev, n, 1,
        f"Kontext int4 + TeaCache (flux-kontext, 0.6; {KONTEXT_REF}px reference encoded inside, tiled VAE)", embeds,
        tag="kontext", image=ref, guidance_scale=2.5, cache="teacache", teacache_model_name="flux-kontext")
    hits = req_hits[0] if req_hits else -1
    log(f"[kontext] TeaCache hits {hits} of {n} steps (the first and last always compute)")
    ok = finite and 0 <= hits <= n - 2 and check_counts(
        "kontext teacache", counts, paths["int4"], n - hits, {"gemv_awq": n, "flash_online": 1 + VAE_TILES},
        tag="kontext")
    cond_merge(res, "kontext", ok, counts)
    enc = FluxPipeline(None, vae=vae)
    odd = reference_image(ODD_REF, 44, dev)
    finite, _, counts, *_ = serve(
        FluxPipeline(model), dev, 1, 1, f"Kontext int4, {ODD_REF}px reference (S_cond {ODD_S_COND}), to latents",
        lambda seed: kontext_request(enc, odd, embeds(seed)), tag="kontext", guidance_scale=2.5)
    ok = finite and check_counts("kontext int4 odd reference", counts, paths["int4"], 1, {"flash_online": 1},
                                 tag="kontext")
    cond_merge(res, "kontext", ok, counts)


def fill_control(dev, steps, vae, paths, res):
    """[kontext] FLUX.1-Fill from a synthesized Fill-layout file
    (``flux_state(in_channels=384)``, int4 rank 32, written to a temporary
    directory and removed): ``prepare_fill`` of a 1024px image and mask
    inside the request, guidance 30, min(2, steps) steps to an image; then
    FLUX.1 Canny / Depth (``in_channels`` 128): the Fill model's blocks under
    a random 128-channel ``x_embedder``, ``prepare_control`` of a 1024px
    control image inside the request, min(2, steps) steps to latents."""
    import dataclasses
    import tempfile

    from nunchaku_tpu_torch import load_flux_transformer
    from nunchaku_tpu_torch.models.linear import Linear
    from nunchaku_tpu_torch.models.transformer_flux import FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline
    from nunchaku_tpu_torch.tools import synth_checkpoint as synth

    with tempfile.TemporaryDirectory(prefix="nunchaku_fill_") as tmp:
        path = f"{tmp}/svdq-int4_r32-flux.1-fill-dev.safetensors"
        _write(synth, path, lambda: synth.flux_state(precision="int4", in_channels=384, seed=45, device=dev),
               "FLUX.1-Fill int4 rank 32 (v1 schema, in_channels 384)", tag="kontext")
        model, _ = _load("FLUX.1-Fill at int4", lambda: load_flux_transformer(path, device=dev), tag="kontext")
    cfg = model.cfg
    n = min(2, steps)
    img = reference_image(1024, 46, dev)
    rows = torch.arange(1024, device=dev)
    mask = ((rows[:, None] >= 256) & (rows[:, None] < 768) & (rows[None, :] >= 384) & (rows[None, :] < 896))
    mask = mask[None].float()  # (1, H, W), 1 = inpaint: a 512 x 512 window
    pipe = FluxPipeline(model, vae=vae)
    embeds = embeds_request(cfg, dev)

    def fill_request(seed):
        make = embeds(seed)
        return lambda: dict(make(), control_latents=pipe.prepare_fill(img, mask))

    good_cfg = cfg.in_channels == 384 and tuple(model.x_embedder.weight.shape) == (384, cfg.dim)
    finite, _, counts, *_ = serve(pipe, dev, n, 1, "Fill int4 (in_channels 384, prepare_fill inside, guidance 30, "
                                  "tiled VAE)", fill_request, tag="kontext", guidance_scale=30.0)
    ok = good_cfg and finite and check_counts("fill", counts, paths["int4"], n, {"flash_online": 1 + VAE_TILES},
                                              tag="kontext")
    cond_merge(res, "kontext", ok, counts)
    gen = torch.Generator(device=dev).manual_seed(47)
    canny = FluxTransformer2DModel(dataclasses.replace(cfg, in_channels=128),
                                   Linear.random_init(gen, 128, cfg.dim, device=dev), model.context_embedder,
                                   model.time_text_embed, model.transformer_blocks, model.single_transformer_blocks,
                                   model.norm_out, model.proj_out)
    ctrl = reference_image(1024, 48, dev)
    enc = FluxPipeline(None, vae=vae)

    def control_request(seed):
        make = embeds(seed)
        return lambda: dict(make(), control_latents=enc.prepare_control(ctrl))

    finite, _, counts, *_ = serve(FluxPipeline(canny), dev, n, 1, "Canny / Depth int4 (in_channels 128, "
                                  "prepare_control inside, guidance 30), to latents", control_request, tag="kontext",
                                  guidance_scale=30.0)
    ok = finite and check_counts("canny / depth", counts, paths["int4"], n, {"flash_online": 1}, tag="kontext")
    cond_merge(res, "kontext", ok, counts)
    del pipe, model, canny
    torch.cuda.empty_cache()


def conditioning_kernel_checks(dev, failed):
    """The kernels of the image-conditioned paths at the shapes those paths
    give them, each against its plain twin (the rows' own checks and
    tolerances): Kontext at 1024px with a 1024px reference (512 + 4096 +
    4096 tokens; the linears pad rows to 256, so the 1008px reference's 8577
    tokens reach the GEMMs as 8704) and with the 1008px one (attention and
    the producers see 8577), the encoder's mid block (row 5 at S 16384)."""
    from nunchaku_tpu_torch.ops import checks

    s_full, s_odd = S_TXT + S_IMG + KONTEXT_S_COND, S_TXT + S_IMG + ODD_S_COND
    cases = []
    for s in (s_full, s_odd):
        cases.append((f"flash_fixed @ B=1 H={HEADS} S={s} D={HD}",
                      lambda s=s: checks.check_flash(*checks.flash_case(1, HEADS, s, s, HD, seed=3, device=dev))))
        cases.append((f"qkv_rope_producer @ B=1 S={s} H={HEADS} R={RANK}",
                      lambda s=s: checks.check_qkv_rope(*checks.qkv_rope_case(1, (s,), HEADS, HD, RANK, seed=3,
                                                                               device=dev))))
        cases.append((f"ln_mod_quant_int8 @ M={s} K={DIM} R={RANK}",
                      lambda s=s: checks.check_ln_mod_quant(*checks.ln_mod_quant_case(1, s, DIM, RANK, seed=3,
                                                                                       device=dev))))
    cases.append((f"ln_mod_quant_int8 @ M={S_IMG + KONTEXT_S_COND} K={DIM} R={RANK} (dual image stream)",
                  lambda: checks.check_ln_mod_quant(*checks.ln_mod_quant_case(1, S_IMG + KONTEXT_S_COND, DIM, RANK,
                                                                             seed=4, device=dev))))
    cases.append((f"gemm_w8a8_gelu_quant @ M={s_full} K={DIM} N={HID} R={RANK}",
                  lambda: checks.check_gelu_quant(*checks.gelu_quant_case(s_full, DIM, HID, RANK, seed=3, device=dev))))
    cases.append((f"gemm_w8a8_grouped_res @ M={s_full} K={HID} N={DIM} R={RANK}",
                  lambda: checks.check_grouped_res(*checks.grouped_res_case(s_full, HID, DIM, HID // 1536, RANK,
                                                                            seed=3, device=dev))))
    cases.append((f"gemm_w4a4_int4 @ M={s_full} K={DIM} N={3 * DIM} R={RANK}",
                  lambda: checks.check_w4a4(*checks.w4a4_case(s_full, DIM, 3 * DIM, "int4", seed=3, device=dev))))
    for label, run in cases:
        err, ok, detail = run()
        log(f"[kernel] conditioning path {label}: {'PASS' if ok else 'FAIL'} {detail}")
        if not ok:
            failed.append(f"conditioning {label.split(' @')[0]}")
        torch.cuda.empty_cache()


def reference_conditioning(dev):
    """Image-conditioned requests on small models, card against CPU (same
    weights, images and noise): a small VAE (blocks 32, 32, 32, 512, resnet
    branches damped as tests/test_torch_vae.py does) encoding a 512px image
    (its 512-wide mid block takes flash_online at 4096 tokens: the encoder's
    bound, max 2e-2 and mean 5e-3 of max |ref|); the small FLUX turbo w4a8
    model with a 240px Kontext reference (225 tokens: S 128 + 256 + 225, no
    multiple of the tiles) and the double FB cache, 2 steps to images; the
    small model at in_channels 384 with prepare_fill (mask channels equal,
    image channels within the encoder's bound), 2 steps; the small
    Qwen-Image w4a8 model with two references (Edit-2509: 128px and 64 x
    96px, frames 1 and 2), true CFG 4.0 over padded prompts at B 2, 2 steps.
    Latents within 2e-2 of max |ref|, images within 2e-2."""
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline
    from nunchaku_tpu_torch.pipeline.pipeline_qwenimage import QwenImagePipeline

    def rel(out, ref):
        return ((out.float().cpu() - ref.float()).abs().max() / ref.float().abs().max()).item()

    def close(out, ref):
        err, scale = (out.float().cpu() - ref.float()).abs(), ref.float().abs().max()
        return (err.max() / scale).item(), (err.mean() / scale).item()

    cpu_vae = AutoencoderKL.random_init(seed=7, block_out_channels=(32, 32, 32, 512), layers_per_block=1,
                                        device="cpu")
    for name, buf in cpu_vae.named_buffers():
        if name.endswith("conv2.weight"):
            buf.mul_(0.25)
    gpu_vae = copy.deepcopy(cpu_vae).to(dev)
    gen = torch.Generator().manual_seed(8)
    img = torch.rand((1, 512, 512, 3), generator=gen)
    ref = cpu_vae.encode(img)
    reset_launch_counts()
    out = gpu_vae.encode(img.to(dev))
    n = launch_counts()["flash_online"]
    mx, mean = close(out, ref)
    all_ok = mx <= 2e-2 and mean <= 5e-3 and n == 1 and tuple(out.shape) == (1, 16, 64, 64)
    log(f"[reference] VAE encoder (32, 32, 32, 512) at 512px: card vs CPU latents max error {mx:.3e}, mean "
        f"{mean:.3e} of max |ref| (tol 2e-2, 5e-3); flash_online launches {n} (expected 1): "
        f"{'PASS' if all_ok else 'FAIL'}")

    base = dict(num_layers=1, num_single_layers=1, num_attention_heads=6, joint_attention_dim=512,
                pooled_projection_dim=256, precision="w4a8")
    pe = torch.randn((1, 128, 512), generator=gen).to(torch.bfloat16)
    pooled = torch.randn((1, 256), generator=gen).to(torch.bfloat16)
    lat = torch.randn((1, 256, 64), generator=gen).to(torch.bfloat16)

    def both(cpu_pipe, gpu_pipe, **kw):
        ref = cpu_pipe(prompt_embeds=pe, pooled_prompt_embeds=pooled, latents=lat, height=256, width=256,
                       num_inference_steps=2, **kw)
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        out = gpu_pipe(prompt_embeds=pe.to(dev), pooled_prompt_embeds=pooled.to(dev), latents=lat.to(dev),
                       height=256, width=256, num_inference_steps=2, **kw)
        return out, ref

    cpu_model = FluxTransformer2DModel.random_init(FluxConfig(**base), seed=9, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    for mdl in (cpu_model, gpu_model):
        mdl.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
    kontext = torch.rand((1, 240, 240, 3), generator=gen)
    out, ref = both(FluxPipeline(cpu_model, vae=cpu_vae), FluxPipeline(gpu_model, vae=gpu_vae), image=kontext,
                    cache="double_fb", cache_hit_ratio=0.5)
    r, img_err = rel(out.latents, ref.latents), (out.images.cpu() - ref.images).abs().max().item()
    ok = out.cache_hits == ref.cache_hits == 1 and r <= 2e-2 and img_err <= 2e-2 and bool(
        torch.isfinite(out.images).all())
    log(f"[reference] Kontext, turbo + double_fb, a 240px reference (S 128 + 256 + 225): card vs CPU latents rel "
        f"max error {r:.3e} (tol 2e-2), images max abs error {img_err:.3e} (tol 2e-2), hits {out.cache_hits} / "
        f"{ref.cache_hits}: {'PASS' if ok else 'FAIL'}")
    all_ok = all_ok and ok

    cpu_fill = FluxTransformer2DModel.random_init(FluxConfig(**base, in_channels=384), seed=10, device="cpu")
    gpu_fill = copy.deepcopy(cpu_fill).to(dev)
    img = torch.rand((1, 256, 256, 3), generator=gen)
    mask = (torch.rand((1, 256, 256), generator=gen) < 0.3).float()
    cond_ref = FluxPipeline(None, vae=cpu_vae).prepare_fill(img, mask)
    cond = FluxPipeline(None, vae=gpu_vae).prepare_fill(img.to(dev), mask.to(dev))
    mask_same = torch.equal(cond[..., 64:].cpu(), cond_ref[..., 64:])
    mx, mean = close(cond[..., :64], cond_ref[..., :64])
    out, ref = both(FluxPipeline(cpu_fill), FluxPipeline(gpu_fill), control_latents=cond_ref)
    r = rel(out.latents, ref.latents)
    ok = mask_same and mx <= 2e-2 and mean <= 5e-3 and r <= 2e-2
    log(f"[reference] Fill (in_channels 384): prepare_fill card vs CPU mask channels equal={mask_same}, image "
        f"channels max {mx:.3e} / mean {mean:.3e} of max |ref| (tol 2e-2 / 5e-3); 2 steps latents rel max error "
        f"{r:.3e} (tol 2e-2): {'PASS' if ok else 'FAIL'}")
    all_ok = all_ok and ok

    gen = torch.Generator().manual_seed(11)
    pe = torch.randn((2, 24, 320), generator=gen).to(torch.bfloat16)
    neg = torch.randn((2, 6, 320), generator=gen).to(torch.bfloat16)
    qlat = torch.randn((2, 64, 64), generator=gen).to(torch.bfloat16)
    pmask = torch.arange(24)[None, :] < torch.tensor([[24], [9]])
    nmask = torch.ones((2, 6), dtype=torch.bool)
    refs = [torch.rand((1, 128, 128, 3), generator=gen), torch.rand((1, 64, 96, 3), generator=gen)]
    cpu_q = QwenImageTransformer2DModel.random_init(QwenImageConfig(num_layers=2, num_attention_heads=2,
                                                                    joint_attention_dim=320, precision="w4a8"),
                                                    seed=12, device="cpu")
    gpu_q = copy.deepcopy(cpu_q).to(dev)
    kw = dict(height=128, width=128, num_inference_steps=2, true_cfg_scale=4.0)
    ref = QwenImagePipeline(cpu_q, vae=cpu_vae)(pe, neg, pmask, nmask, latents=qlat, image=refs, **kw)
    out = QwenImagePipeline(gpu_q, vae=gpu_vae)(pe.to(dev), neg.to(dev), pmask.to(dev), nmask.to(dev),
                                                latents=qlat.to(dev), image=[r_.to(dev) for r_ in refs], **kw)
    r = max(rel(out.latents[i], ref.latents[i]) for i in range(2))
    ok = r <= 2e-2 and bool(torch.isfinite(out.latents.float()).all())
    log(f"[reference] Qwen-Image edit (Edit-2509: 128px + 64 x 96px references, frames 1 and 2), true CFG 4.0, "
        f"padded prompts at B 2: card vs CPU latents rel max error {r:.3e} per batch row (tol 2e-2): "
        f"{'PASS' if ok else 'FAIL'}")
    return all_ok and ok


def qwen_bounds(cfg, b=1) -> dict:
    """Least time per Qwen-Image 1024px forward at batch ``b`` for each
    kernel it runs (S_txt 211, padded to the 256-row quantum in the GEMMs)."""
    L, D = cfg.num_layers, cfg.dim
    s = QWEN_S_TXT + S_IMG
    ms = [b * S_IMG, b * 256]
    return {
        "gemm_w4a4_int4_stacked": L * sum(w4a4_bound(m, D, n, 64)[0] for m in ms for n in (3 * D, D, 4 * D)),
        "gemm_w4a4_int4_unsigned_stacked": L * sum(w4a4_bound(m, 4 * D, D, 64)[0] for m in ms),
        "gemv_awq": 2 * L * gemv_bound(b, D, 6 * D)[0],
        "flash_fixed_masked": L * bound(4 * b * s * HEADS * HD * 2 + 4 * b * s,
                                        bf16_ops=4 * b * HEADS * s * s * HD)[0],
    }


def highres_bounds() -> dict:
    """Least time per 2048px forward of the int4 model for each kernel it
    runs: the W4A4 GEMMs and the GEMV at 16384 image and 512 text rows, the
    attention of each block with every query block taking 5 full kv blocks
    of 1536 (S 16896 is 11 blocks exactly, so the selection does not move
    the bound; dense: all 11)."""
    L, Ls = 19, 38
    img, txt = HR_S - S_TXT, S_TXT

    def signed(m):
        return sum(w4a4_bound(m, DIM, n, 64)[0] for n in (3 * DIM, DIM, HID))

    kk_cols = max(1, int(11 * (1 - HR_SPARSITY))) * 1536
    att = bound(4 * HR_S * HEADS * HD * 2, bf16_ops=4 * HR_S * kk_cols * HD * HEADS)[0]
    return {
        "gemm_w4a4_int4_stacked": L * (signed(img) + signed(txt)) + Ls * signed(HR_S),
        "gemm_w4a4_int4_unsigned_stacked": L * sum(w4a4_bound(m, HID, DIM, 64)[0] for m in (img, txt))
        + Ls * w4a4_bound(HR_S, HID, DIM, 64)[0],
        "gemv_awq": 2 * L * gemv_bound(1, DIM, 6 * DIM)[0] + Ls * gemv_bound(1, DIM, 3 * DIM)[0],
        "bs_fixed": (L + Ls) * att,
        "bs_online": (L + Ls) * att,
        "flash_fixed": (L + Ls) * bound(4 * HR_S * HEADS * HD * 2, bf16_ops=4 * HR_S * HR_S * HD * HEADS)[0],
    }

# LoRA on the quantized FLUX model (the [lora] phase): a rank-16 kohya LoRA on every leaf makes every low-rank
# branch R 32 + 16; the composed pair (that LoRA and a rank-32 one) R 32 + 48. The kernels those ranks reach, as
# rows *_lora48 / *_lora80 (launches: the [lora] forwards of that model)
LORA_MODELS = {"lora48": 48, "lora80": 80}
LORA_ROW_KERNELS = ("ln_mod_quant_int8", "qkv_rope_producer", "gemm_w8a8_gelu_quant", "gemm_w8a8_grouped_res",
                    "gemm_w4a4_int4", "gemm_w4a4_int4_unsigned")


def lora_kernel_rows(dev, record):
    """Rows *_lora48 / *_lora80: the kernels a LoRA'd FLUX.1-dev runs at its
    ranks, at FLUX's shapes (M 4608; the LN producer and the qkv producer at
    K 3072 / H 24, the chain pair at fc1 / fc2, the W4A4 GEMM int4 at fc1
    and with unsigned activations at fc2), each against its twin with its
    rank-32 row's tolerance (the producers also bit for bit their rank-32
    launch on the shared columns), timed beside it."""
    from nunchaku_tpu_torch.ops import checks
    from nunchaku_tpu_torch.ops.attention import qkv_rope_producer, qkv_rope_producer_plain
    from nunchaku_tpu_torch.ops.gemm import (gemm_w4a4, gemm_w4a4_plain, gemm_w8a8_grouped_plain,
                                             gemm_w8a8_grouped_res, svdq_gemm_w8a8_gelu_quant,
                                             svdq_gemm_w8a8_gelu_quant_plain)
    from nunchaku_tpu_torch.ops.quantize import ln_mod_quant_int8, ln_mod_quant_int8_plain
    from nunchaku_tpu_torch.ops.reference import int8_matmul

    m = S_IMG + S_TXT
    ln_norm = torch.nn.functional.layer_norm
    for suffix, r in ((f"_{k}", v) for k, v in LORA_MODELS.items()):
        args = checks.ln_mod_quant_case(1, m, DIM, r, device=dev)
        err, ok, detail = checks.check_ln_rank(*args)
        x = args[0]
        record("ln_mod_quant_int8" + suffix, "nunchaku_tpu_torch/csrc/ln_mod_quant.cu",
               "nunchaku_tpu/ops/quantize.py:149", f"M={m} K={DIM} R={r}", ok, err, detail,
               time_ms(lambda: ln_mod_quant_int8(*args), 50), time_ms(lambda: ln_mod_quant_int8_plain(*args), 5),
               bound(ln_bytes(m, DIM, r), bf16_ops=2 * m * DIM * r), time_ms(lambda: ln_norm(x, (DIM,), eps=1e-6), 50))
        del args, x

        streams, cos, sin = checks.qkv_rope_case(1, (m,), HEADS, HD, r, device=dev)
        err, ok, detail = checks.check_qkv_rank(streams, cos, sin)
        la16, pu = streams[0][3].to(torch.bfloat16), streams[0][4]
        record("qkv_rope_producer" + suffix, "nunchaku_tpu_torch/csrc/qkv_rope_producer.cu",
               "nunchaku_tpu/ops/attention.py:158", f"B=1 S={m} H={HEADS} D={HD} R={r}", ok, err, detail,
               time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer, streams, cos, sin), 50),
               time_ms(lambda: checks.run_qkv_rope(qkv_rope_producer_plain, streams, cos, sin), 5),
               bound(rope_bytes(m, r), bf16_ops=2 * m * 3 * HEADS * HD * r), None,
               lowrank=time_ms(lambda: torch.matmul(la16, pu), 50))
        del streams, cos, sin, la16, pu

        k, n = DIM, HID
        args = checks.gelu_quant_case(m, k, n, r, device=dev)
        err, ok, detail = checks.check_gelu_quant(*args)
        qa, w = args[0], args[2]
        record("gemm_w8a8_gelu_quant" + suffix, "nunchaku_tpu_torch/csrc/gemm_w8a8_gelu_quant.cu",
               "nunchaku_tpu/ops/gemm.py:460", f"M={m} K={k} N={n} R={r}", ok, err, detail,
               time_ms(lambda: svdq_gemm_w8a8_gelu_quant(*args), 20),
               time_ms(lambda: svdq_gemm_w8a8_gelu_quant_plain(*args), 3),
               bound(gemm_bytes(m, k, n, r, m * n + 4 * (n // 1536) * m + 4 * m * r) + 4 * n + 2 * n * r,
                     2 * m * n * k, 4 * m * n * r),
               time_ms(lambda: int8_matmul(qa, w), 20))
        del args, qa, w

        k, n, g = HID, DIM, HID // 1536
        args = checks.grouped_res_case(m, k, n, g, r, device=dev)
        err, ok, detail = checks.check_grouped_res(*args)
        qa, w = args[0], args[2]
        record("gemm_w8a8_grouped_res" + suffix, "nunchaku_tpu_torch/csrc/gemm_w8a8_grouped.cu",
               "nunchaku_tpu/ops/gemm.py:395", f"M={m} K={k} N={n} G={g} R={r} +x,gate,extra,extra_lora",
               ok, err, detail, time_ms(lambda: gemm_w8a8_grouped_res(*args), 20),
               time_ms(lambda: gemm_w8a8_grouped_plain(*args), 3),
               bound(gemm_bytes(m, k, n, r, 2 * m * n) + 4 * g * m + res_bytes(m, n, 1, r), 2 * m * n * k,
                     4 * m * n * r),
               time_ms(lambda: int8_matmul(qa, w), 20))
        del args, qa, w

        for name, (k, n), unsigned in (("gemm_w4a4_int4", (DIM, HID), False),
                                       ("gemm_w4a4_int4_unsigned", (HID, DIM), True)):
            args, kw = checks.w4a4_case(m, k, n, "int4", unsigned, r=r, device=dev)
            err, ok, detail = checks.check_w4a4(args, kw)
            a16, w16 = decoded(args, kw)
            record(name + suffix, "nunchaku_tpu_torch/csrc/gemm_w4a4.cu", "nunchaku_tpu/ops/gemm.py:125",
                   f"M={m} K={k} N={n} R={r} int4{' unsigned' if unsigned else ''}", ok, err, detail,
                   time_ms(lambda: gemm_w4a4(*args, **kw), 20), time_ms(lambda: gemm_w4a4_plain(*args, **kw), 3),
                   w4a4_bound(m, k, n, 64, r=r), time_ms(lambda: torch.matmul(a16, w16), 20), k_bf_ms(a16, w16))
            del args, a16, w16
    torch.cuda.empty_cache()


def flux_forward_args(cfg, dev, seed=0):
    """A 1024px FLUX transformer call's inputs (B 1, 4096 image + 512 text
    tokens), drawn on the card from ``seed``."""
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, S_TXT, cfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.randn((1, cfg.pooled_projection_dim), generator=gen, device=dev).to(torch.bfloat16),
            torch.tensor([0.5], device=dev), make_img_ids(math.isqrt(S_IMG), math.isqrt(S_IMG), dev),
            torch.zeros((S_TXT, 3), dtype=torch.int32, device=dev), torch.tensor([3.5], device=dev))


def interleaved_forwards(fns: dict, rounds=3) -> dict:
    """Each of ``fns`` once untimed, then ``rounds`` rounds calling each in
    turn, each call timed alone (a shared host's drift falls on all alike):
    -> {label: (median s a call, launch counts of its timed calls, peak
    allocated GiB over them, last output, every time)}."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    secs, counts, peaks, outs = ({k: [] for k in fns}, {k: {} for k in fns}, dict.fromkeys(fns, 0.0),
                                 dict.fromkeys(fns))
    with torch.no_grad():
        for fn in fns.values():
            fn()
        for _ in range(rounds):
            for label, fn in fns.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                t0 = time.perf_counter()
                outs[label] = fn()
                torch.cuda.synchronize()
                secs[label].append(time.perf_counter() - t0)
                counts[label] = {k: counts[label].get(k, 0) + v for k, v in launch_counts().items()}
                peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated() / 2**30)
    return {k: (sorted(secs[k])[len(secs[k]) // 2], counts[k], peaks[k], outs[k], secs[k]) for k in fns}


def rel_err(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def lora_phase(dev, steps: int):
    """[lora] LoRA on FLUX.1-dev at full width and depth (19 + 38 blocks),
    int4 (default configuration) and w4a8 turbo: a synthesized rank-16 kohya
    LoRA on every leaf of every block (every low-rank branch R 48, the AWQ
    modulation linears a rank-16 side branch) and the composed pair of it
    and a rank-32 one at strength 0.5 (R 80). Each model 3 timed 1024px
    forwards after an untimed one, in rounds with the base model's (the
    median reported): launch counts
    equal to the base's, output finite and moved by the LoRA; the strength-0
    model's distance from the base; the times of update_lora_params and
    set_lora_strength; last, one LoRA'd Kontext request (int4, a 1024px
    reference encoded inside, min(2, steps) steps to latents). -> (ok,
    launch counts of each model's forwards by label, all launch counts)."""
    from nunchaku_tpu_torch import compose_lora, set_lora_strength, update_lora_params
    from nunchaku_tpu_torch.models.autoencoder import AutoencoderKL
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import FluxPipeline
    from nunchaku_tpu_torch.tools.synth_checkpoint import lora_state

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sd16 = lora_state(FluxConfig(), 16, "kohya", seed=1, device=dev)[0]
    sd32 = lora_state(FluxConfig(), 32, "kohya", seed=2, device=dev)[0]
    pair = compose_lora([(sd16, 1.0), (sd32, 0.5)])
    lora_mib = sum(t.numel() * t.element_size() for t in sd16.values()) / 2**20
    log(f"[lora] synthesized kohya LoRAs (rank 16: {len(sd16)} tensors, {lora_mib:.1f} MiB bf16; rank 32) and "
        f"composed the pair in {time.perf_counter() - t0:.2f} s")
    ok, by_label, total = True, {k: {} for k in LORA_MODELS}, {}
    for precision in ("int4", "w4a8"):
        cfg = FluxConfig(precision=precision)
        L, Ls = cfg.num_layers, cfg.num_single_layers
        base = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
        models, apply_s = {"base": base}, {}
        for label, sd in (("lora48", sd16), ("lora80", pair)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models[label] = update_lora_params(base, sd)
            torch.cuda.synchronize()
            apply_s[label] = time.perf_counter() - t0
        t0 = time.perf_counter()
        models["strength 0"] = set_lora_strength(models["lora48"], 0.0)
        torch.cuda.synchronize()
        set_s = time.perf_counter() - t0
        qkv = {k: m.transformer_blocks.attn.to_qkv.proj_up.shape[-2] for k, m in models.items()}
        new_mib = sum(t.numel() * t.element_size() for t in models["lora48"].buffers()
                      if all(t.data_ptr() != b.data_ptr() for b in base.buffers())) / 2**20
        log(f"[lora] FLUX.1-dev {precision}: update_lora_params {apply_s['lora48']:.3f} s (rank 16) / "
            f"{apply_s['lora80']:.3f} s (the pair), set_lora_strength {1e3 * set_s:.1f} ms; qkv ranks {qkv}; the "
            f"rank-16 model's new buffers {new_mib:.1f} MiB, the rest shared with the base")
        if precision == "w4a8":
            for m in models.values():
                m.set_stream_dtype(torch.bfloat16).enable_fused_qkv_prep()
        args = flux_forward_args(cfg, dev)
        res = interleaved_forwards({label: (lambda m=m: m(*args)) for label, m in models.items()})
        config = "int4" if precision == "int4" else "w4a8 turbo"
        per = ({"gemm_w4a4_int4_stacked": 6 * L + 3 * Ls, "gemm_w4a4_int4_unsigned_stacked": 2 * L + Ls,
                "gemv_awq": 2 * L + Ls, "flash_fixed": L + Ls} if precision == "int4"
               else {k: L * W4A8_TURBO_DUAL[k] + Ls * W4A8_TURBO_SINGLE[k] for k in W4A8_TURBO_DUAL})
        base_s, base_counts, _, base_out, _ = res["base"]
        for label, (sec, counts, peak, out, secs) in res.items():
            finite = bool(torch.isfinite(out.float()).all()) and tuple(out.shape) == (1, S_IMG, 64)
            moved = rel_err(out, base_out)
            good = finite and counts == base_counts and check_counts(f"{config} {label}", counts, per, 3, tag="lora")
            good = good and (label in ("base", "strength 0") or moved > 1e-3)
            log(f"[lora] {config} {label}: {sec:.4f} s a 1024px forward, the median of {[round(t, 4) for t in secs]} "
                f"interleaved with the other models' ({sec / base_s:.3f} of the base's), "
                f"peak allocated {peak:.2f} GiB, finite {finite}, launch counts equal to the base's "
                f"{counts == base_counts}, rel max distance from the base {moved:.3e}: {'PASS' if good else 'FAIL'}")
            ok = ok and good
            if label in by_label:
                by_label[label] = {k: by_label[label].get(k, 0) + v for k, v in counts.items()}
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
        if precision == "int4":
            vae = AutoencoderKL.random_init(seed=0, device=dev)
            enc = FluxPipeline(None, vae=vae)
            ref = reference_image(KONTEXT_REF, 45, dev)
            n = min(2, steps)
            finite, _, counts, *_ = serve(
                FluxPipeline(models["lora48"]), dev, n, 1,
                f"Kontext int4 + the rank-16 LoRA ({KONTEXT_REF}px reference encoded inside), to latents",
                lambda seed: kontext_request(enc, ref, embeds_request(cfg, dev)(seed)), tag="lora",
                guidance_scale=2.5)
            good = finite and check_counts("kontext int4 LoRA", counts, per, n, {"flash_online": 1}, tag="lora")
            ok = ok and good
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            del vae, enc, ref
        del models, base, res, base_out, out
        torch.cuda.empty_cache()
    log(f"[lora] phase {time.perf_counter() - t_phase:.1f} s")
    return ok, by_label, total


def unstacked(counts: dict) -> dict:
    """Non-zero launch counts with each stacked mode's count under its
    non-stacked name (an offloaded block runs the non-stacked modes)."""
    out = {}
    for k, v in counts.items():
        if v:
            out[k.removesuffix("_stacked")] = out.get(k.removesuffix("_stacked"), 0) + v
    return out


def cached_steps(step, n=3):
    """``n`` calls of a cached forward's ``step`` (one input repeated: a
    miss, then hits), each timed alone: -> (outputs, seconds, launch counts,
    peak allocated GiB over them)."""
    from nunchaku_tpu_torch.ops import launch_counts, reset_launch_counts

    outs, secs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for _ in range(n):
        t0 = time.perf_counter()
        with torch.no_grad():
            outs.append(step())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return outs, secs, launch_counts(), torch.cuda.max_memory_allocated() / 2**30


def compare_cached(label, resident, offloaded, hits, need):
    """The offloaded cached form's 3 steps against the resident cache's: every
    output bit for bit, hits equal (2: the input repeats), launches the
    resident's under the non-stacked names, peak allocated lower by at least
    ``need`` GiB. -> (ok, launch counts of both)."""
    (r_outs, r_secs, r_counts, r_peak), (o_outs, o_secs, o_counts, o_peak) = resident, offloaded
    same = all(torch.equal(a, b) for a, b in zip(o_outs, r_outs))
    finite = all(bool(torch.isfinite(o.float()).all()) for o in o_outs)
    counts_ok = {k: v for k, v in o_counts.items() if v} == unstacked(r_counts)
    good = same and finite and hits == (2, 2) and counts_ok and r_peak - o_peak >= need
    log(f"[offload] {label}, one input 3 times (miss, hit, hit): resident s {[round(s, 4) for s in r_secs]}, offloaded "
        f"s {[round(s, 4) for s in o_secs]}; hits offloaded / resident {hits}; outputs bit for bit {same}; peak "
        f"allocated {o_peak:.2f} GiB against {r_peak:.2f} ({r_peak - o_peak:.2f} less, at least {need:.2f} needed); "
        f"launches { {k: v for k, v in o_counts.items() if v} } (the resident's under their non-stacked names: "
        f"{counts_ok}): {'PASS' if good else 'FAIL'}")
    return good, {k: r_counts.get(k, 0) + o_counts.get(k, 0) for k in o_counts}


def offload_phase(dev):
    """[offload] Block offloading (utils/offload.py) at full width and
    depth: FLUX.1-dev int4 (default configuration), a 1024px forward
    resident against OffloadedFluxForward (built from a fork of the model)
    at lookahead 1 and 2, 3 timed rounds of the three after an untimed one
    (the median reported), each output bit for bit the resident one's,
    launch counts the resident's with each stacked mode's count under its
    non-stacked name; then, the model dropped, each offloaded forward's peak
    allocated memory alone, below the resident's by at least the block
    weights less the lookahead + 1 slots; the achieved host-to-card
    rate of a copy-only pass; then the first-block cache resident
    (fb_cached_forward) against OffloadedCachedFluxForward, and Qwen-Image
    int4 (60 blocks) resident (qwenimage_fb_cached_forward, fn_blocks 8)
    against OffloadedCachedQwenImageForward: 3 steps of one input each (a
    miss, two hits), outputs and hits equal, peak allocated lower by at least
    the streamed blocks less 2 slots. -> (ok, launch counts)."""
    from nunchaku_tpu_torch.caching.fbcache import (fb_cached_forward, init_fb_state, init_qwen_fb_state,
                                                    qwenimage_fb_cached_forward)
    from nunchaku_tpu_torch.models.linear import fork_module
    from nunchaku_tpu_torch.models.transformer_flux import FluxConfig, FluxTransformer2DModel
    from nunchaku_tpu_torch.models.transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel
    from nunchaku_tpu_torch.pipeline.pipeline_flux import make_img_ids
    from nunchaku_tpu_torch.utils.offload import (OffloadedCachedFluxForward, OffloadedCachedQwenImageForward,
                                                  OffloadedFluxForward)

    def gib(tensors):
        return sum(t.numel() * t.element_size() for t in tensors) / 2**30

    t_phase = time.perf_counter()
    cfg = FluxConfig()
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    blocks_gib = gib(t for name in model.STACKS for t in getattr(model, name).buffers())
    args = flux_forward_args(cfg, dev, seed=1)
    t0 = time.perf_counter()
    off = OffloadedFluxForward(fork_module(model), lookahead=1)  # a fork: `model` stays resident to time beside it
    build_s = time.perf_counter() - t0
    log(f"[offload] host copies (pinned): {build_s:.2f} s, {(off.dual.host_bytes + off.single.host_bytes) / 2**30:.2f} "
        f"GiB; a dual block {off.dual.nbytes / 2**20:.1f} MiB, a single block {off.single.nbytes / 2**20:.1f} MiB")

    def offloaded(la):
        def call():
            off.dual.lookahead = off.single.lookahead = la
            return off(*args)
        return call

    res = interleaved_forwards({"resident": lambda: model(*args), 1: offloaded(1), 2: offloaded(2)})
    res_s, res_counts, res_peak, ref, secs = res["resident"]
    log(f"[offload] FLUX.1-dev int4 resident: {res_s:.4f} s a 1024px forward (median of {[round(t, 4) for t in secs]}, "
        f"interleaved with the offloaded ones), peak allocated {res_peak:.2f} GiB (block weights {blocks_gib:.2f} GiB), "
        f"launches { {k: v for k, v in res_counts.items() if v} }")
    del model
    torch.cuda.empty_cache()
    log(f"[offload] the model dropped, allocated on the card {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ok, total = True, dict(res_counts)
    largest = max(off.dual.nbytes, off.single.nbytes) / 2**30
    for la in (1, 2):
        sec, counts, _, out, secs = res[la]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            offloaded(la)()  # alone on the card: its peak
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = torch.equal(out, ref)
        counts_ok = {k: v for k, v in counts.items() if v} == unstacked(res_counts)
        saved = res_peak - peak
        need = blocks_gib - (la + 1) * largest
        good = same and counts_ok and saved >= need
        log(f"[offload] OffloadedFluxForward lookahead {la}: {sec:.4f} s a forward (median of "
            f"{[round(t, 4) for t in secs]}; {sec / res_s:.3f} of resident), peak allocated {peak:.3f} GiB (resident "
            f"{res_peak:.3f}: {saved:.3f} GiB less, at least {need:.3f} needed), output bit for bit the resident's "
            f"{same}, launches { {k: v for k, v in counts.items() if v} } (the resident's under their non-stacked "
            f"names: {counts_ok}): {'PASS' if good else 'FAIL'}")
        ok = ok and good
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    # the copy engine alone: every block of a stack streamed with no compute between
    for streamer, label in ((off.dual, "dual"), (off.single, "single")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamer.run(lambda blk, c: c, None)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        log(f"[offload] copy-only pass over the {label} stack: {streamer.host_bytes / 2**30:.2f} GiB in {sec:.4f} s, "
            f"{streamer.host_bytes / sec / 1e9:.2f} GB/s host to card (pinned, its own stream)")
    del off, ref

    # the first-block cache: resident, then offloaded from the same weights (random_init is deterministic on the card)
    model = FluxTransformer2DModel.random_init(cfg, seed=0, device=dev)
    state = [init_fb_state(1, S_IMG, S_TXT, cfg.dim, device=dev)]

    def resident_fb():
        out, state[0] = fb_cached_forward(model, state[0], *args)
        return out

    resident = cached_steps(resident_fb)
    r_hits = state[0].hits
    offc = OffloadedCachedFluxForward(model, lookahead=1)
    del state  # the resident cache's: the offloaded form keeps its own
    torch.cuda.empty_cache()
    good, counts = compare_cached(
        "OffloadedCachedFluxForward (threshold 0.12) against fb_cached_forward", resident,
        cached_steps(lambda: offc(*args)), (offc.hits, r_hits), blocks_gib - gib(offc.block0.buffers()) - 2 * largest)
    ok = ok and good
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del offc, resident, args
    torch.cuda.empty_cache()

    qcfg = QwenImageConfig()
    model = QwenImageTransformer2DModel.random_init(qcfg, seed=0, device=dev)
    qblocks_gib = gib(model.blocks.buffers())
    gen = torch.Generator(device=dev).manual_seed(2)
    qargs = (torch.randn((1, S_IMG, 64), generator=gen, device=dev).to(torch.bfloat16),
             torch.randn((1, QWEN_S_TXT, qcfg.joint_attention_dim), generator=gen, device=dev).to(torch.bfloat16),
             torch.tensor([0.5], device=dev), make_img_ids(math.isqrt(S_IMG), math.isqrt(S_IMG), dev))
    qstate = [init_qwen_fb_state(1, S_IMG, qcfg.dim, device=dev)]

    def resident_qwen():
        out, qstate[0] = qwenimage_fb_cached_forward(model, qstate[0], *qargs, fn_blocks=8)
        return out

    with torch.no_grad():  # first use at Qwen's shapes, untimed
        qwenimage_fb_cached_forward(model, init_qwen_fb_state(1, S_IMG, qcfg.dim, device=dev), *qargs, fn_blocks=8)
    resident = cached_steps(resident_qwen)
    r_hits = qstate[0].hits
    t0 = time.perf_counter()
    offq = OffloadedCachedQwenImageForward(model, fn_blocks=8)
    build_s = time.perf_counter() - t0
    del qstate
    torch.cuda.empty_cache()
    head = gib(t for b in offq.head_blocks for t in b.buffers())
    good, counts = compare_cached(
        f"Qwen-Image int4 ({qcfg.num_layers} blocks, {qblocks_gib:.2f} GiB of block weights, "
        f"{offq.blocks.host_bytes / 2**30:.2f} GiB pinned, host copies {build_s:.2f} s): "
        f"OffloadedCachedQwenImageForward (fn_blocks 8) against qwenimage_fb_cached_forward",
        resident, cached_steps(lambda: offq(*qargs)), (offq.hits, r_hits),
        qblocks_gib - head - 2 * offq.blocks.nbytes / 2**30)
    ok = ok and good
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    del offq, resident
    torch.cuda.empty_cache()
    log(f"[offload] phase {time.perf_counter() - t_phase:.1f} s")
    return ok, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="denoise steps per turbo and per image request (50: the step count of "
                         "bench.py's main path); the one default-configuration request takes min(3, N)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 1
    from nunchaku_tpu_torch.ops import _build, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 (bf16-operand GEMMs)
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    lines = []
    t0 = time.perf_counter()
    path = _build.build(log=lines.append)
    _build.library()
    info = [ln.strip() for text in lines for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or ln.startswith("[nvcc")]
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s (nvcc wall "
        f"{_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")
    for ln in info:
        log(f"[build]   {ln}")
    sass_ok = core_sass(path) and ptxas_clean(lines)

    rows, failed = kernel_phase(dev)
    ref_ok = reference_phase(dev)
    reset_launch_counts()
    t5, clip = text_encoders(dev)
    cond = {}  # the [kontext] and [qwen-edit] phases: verdict and launch counts each
    slice_ok, counts, paths, cfg = slice_phase(dev, args.steps, requests=2, t5=t5, res=cond)
    i8_ok, icounts, ipaths = flux_int8_phase(dev, args.steps, t5)
    r128_ok, rcounts, rpaths = rank_phase(dev, 128)
    r256_ok, r2counts, r2paths = rank_phase(dev, RANK_HI)
    hr_ok, hcounts, hpaths = highres_phase(dev, args.steps, t5, clip)
    del t5, clip
    torch.cuda.empty_cache()
    qwen_ok, qcounts, qpaths, qcfg = qwen_phase(dev, args.steps, cond)
    kontext_ok, kcounts = cond["kontext"]
    qedit_ok, qecounts = cond["qwen-edit"]
    ckpt_ok, ccounts, cpaths = checkpoint_phase(dev, args.steps)
    ckptq_ok, cqcounts, cqpaths = checkpoint_qwen_phase(dev)
    sdxl_ok, scounts, spaths = sdxl_phase(dev, args.steps)
    sana_ok, sacounts, sapaths = sana_phase(dev, args.steps)
    zi_ok, zicounts, zipaths = zimage_phase(dev, args.steps)
    zr_ok, zrcounts, zrpaths = zimage_r256_phase(dev)
    sp_ok, spcounts, sppaths = sp_phase(dev, args.steps)
    fa_ok, facounts, fapaths = flux_attn_phase(dev)
    lo_ok, locounts, lo2counts = last_ops_phase(dev)
    gp_ok, gpcounts = gemm_probes_phase(dev)
    lora_ok, lora_by_model, lcounts = lora_phase(dev, args.steps)
    off_ok, ocounts = offload_phase(dev)
    counts = {k: counts[k] + icounts.get(k, 0) + qcounts[k] + hcounts[k] + ccounts.get(k, 0) + cqcounts.get(k, 0)
              + scounts.get(k, 0) + sacounts.get(k, 0) + zicounts.get(k, 0) + spcounts.get(k, 0) + facounts.get(k, 0)
              + locounts[k] + gpcounts[k] + kcounts.get(k, 0) + qecounts.get(k, 0) + lcounts.get(k, 0)
              + ocounts.get(k, 0) for k in counts}
    for name, row in rows.items():
        row["launches"] = row_launches(name, counts)
    # the LoRA rows count the forwards of the [lora] model at their rank (rank-16 LoRA: R 48; the pair: R 80)
    for label in LORA_MODELS:
        for name in LORA_ROW_KERNELS:
            rows[f"{name}_{label}"]["launches"] = row_launches(name, lora_by_model[label])
    # the rank-128 rows count the [rank128] forwards' launches, the other rows those of the rank-32 paths
    for name in ("ln_mod_quant_int8", "qkv_rope_producer"):
        rows[f"{name}_r128"]["launches"] = rcounts[name]
    # the rank-256 rows count the launches of the paths that run their kernels at rank 256: [rank256], the last
    # ops' rank-256 chain and [zimage-r256] (upstream's r256 Z-Image file on the packed route)
    hi = f"_r{RANK_HI}"
    for name in [n for n in rows if n.endswith(hi)]:
        base = name[:-len(hi)]
        rows[name]["launches"] = r2counts.get(base, 0) + lo2counts.get(base, 0) + zrcounts.get(base, 0)
    for name, per in (rpaths | r2paths).items():
        log(f"[bound] {name}: launches per forward of {R128_LAYERS[0]} dual + {R128_LAYERS[1]} single blocks {per}")
    for name, per in zrpaths.items():
        log(f"[bound] {name}: launches per Z-Image-Turbo 1024px forward {per}")
    for name, b in per_forward_bounds(cfg).items():
        per = {p: f[name] for p, f in (paths | ipaths | cpaths).items() if f.get(name)}
        log(f"[bound] {name}: launches per 1024px forward {per}, least time {b:.3f} ms per forward "
            f"of the path(s) it runs in")
    for name, b in qwen_bounds(qcfg).items():
        per = {p: f[name] for p, f in qpaths.items() if f.get(name)}
        log(f"[bound] {name}: launches per Qwen-Image 1024px forward {per}, least time {b:.3f} ms per B 1 forward")

    def online(s):
        return bound(4 * s * VAE_D * 2, bf16_ops=4 * s * s * VAE_D)[0]

    log(f"[bound] flash_online: launches per 1024px image tiled {VAE_TILES}, whole 1; least time "
        f"{VAE_TILES * online(VAE_TILE_S):.3f} ms per tiled image, {online(VAE_WHOLE_S):.3f} ms per whole image")
    for name, b in highres_bounds().items():
        per = {p: f[name] for p, f in hpaths.items() if f.get(name)}
        log(f"[bound] {name}: launches per 2048px forward {per}, least time {b:.3f} ms per forward")
    for size in (1024, SDXL_TURBO):
        for name, b in sdxl_bounds(size).items():
            log(f"[bound] {name}: launches per SDXL {size}px UNet forward {spaths[f'sdxl {size}px'][name]}, least "
                f"time {b:.3f} ms per forward")
    for label, b, pag in (("CFG (B 2)", 2, 0), ("CFG + PAG (B 3)", 3, len(SANA_PAG_LAYERS))):
        for name, bnd in sana_bounds(b, pag).items():
            per = {p: f[name] for p, f in sapaths.items() if f.get(name)}
            log(f"[bound] {name}: launches per SANA 1.6B 1024px forward {per}, least time {bnd:.3f} ms per "
                f"{label} forward")
    for name, b in zimage_bounds().items():
        per = {p: f[name] for p, f in zipaths.items() if f.get(name)}
        log(f"[bound] {name}: launches per Z-Image-Turbo 1024px forward {per}, least time {b:.3f} ms per forward")
    for name in ("flash_fixed_denom", "flash_fixed_unroll2", "flash_fixed_i8"):
        per = {p: f[name] for p, f in (sppaths | fapaths).items() if f.get(name)}
        log(f"[bound] {name}: launches per forward {per}")
    ran = [name for name, row in rows.items() if row["launches"] > 0]
    log(f"[kernels] ran on the main paths: {', '.join(ran)}; not: "
        f"{', '.join(name for name in rows if name not in ran) or 'none'}")
    for name, per in (cpaths | cqpaths).items():
        log(f"[bound] {name}: launches per 1024px forward {per}")
    ok = not failed and ref_ok and slice_ok and qwen_ok and len(ran) == len(rows)
    ok = ok and i8_ok and hr_ok and ckpt_ok and ckptq_ok and sdxl_ok and sana_ok and zi_ok and sp_ok and fa_ok and lo_ok
    ok = ok and gp_ok and sass_ok and r128_ok and r256_ok and zr_ok and kontext_ok and qedit_ok and lora_ok and off_ok
    per = {k: v for k, v in kcounts.items() if v}
    log(f"[kontext] launches over the phase's requests {per}; [qwen-edit] "
        f"{ {k: v for k, v in qecounts.items() if v} }")

    def verdict(good):
        return "PASS" if good else "FAIL"

    log(f"[done] {time.perf_counter() - t_start:.1f} s; kernel checks "
        f"{'PASS' if not failed else 'FAIL ' + ','.join(failed)}, reference {verdict(ref_ok)}, "
        f"core sass {verdict(sass_ok)}, slice {verdict(slice_ok)}, flux-int8 {verdict(i8_ok)}, "
        f"kontext {verdict(kontext_ok)}, rank128 {verdict(r128_ok)}, rank256 {verdict(r256_ok)}, "
        f"highres {verdict(hr_ok)}, qwen {verdict(qwen_ok)}, qwen-edit {verdict(qedit_ok)}, "
        f"checkpoint {verdict(ckpt_ok)}, checkpoint-qwen {verdict(ckptq_ok)}, sdxl {verdict(sdxl_ok)}, "
        f"sana {verdict(sana_ok)}, zimage {verdict(zi_ok)}, zimage-r256 {verdict(zr_ok)}, sp {verdict(sp_ok)}, "
        f"flux-attn {verdict(fa_ok)}, "
        f"last-ops {verdict(lo_ok)}, gemm-probes {verdict(gp_ok)}, lora {verdict(lora_ok)}, offload {verdict(off_ok)}")
    if not ok:
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"} for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
