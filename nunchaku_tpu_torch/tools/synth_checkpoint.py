"""Synthesize nunchaku-format checkpoints from a seed, at any size.

The repository holds no real checkpoint, so the loaders are driven with
files of the published layouts filled with random values:

* :func:`flux_state` -- a FLUX.1 transformer in nunchaku's v1 single-file
  schema (``svdq-int4_r32-flux.1-dev``, ``svdq-fp4_r32-flux.1-dev``; the
  Fill and Canny / Depth variants by ``in_channels``): MMA-
  packed ``qweight``, group scales (nvfp4: e4m3 micro-scales, ``wtscale``),
  MMA-packed ``lora_down`` / ``lora_up``, AWQ GEMV modulation linears;
* :func:`qwen_state` -- a Qwen-Image transformer in the v2 schema
  (``svdq-int4_r128-qwen-image``): plain ``proj_down`` / ``proj_up``,
  ``smooth_factor``, the rank in ``quantization_config``;
* :func:`sana_state` -- a SANA transformer in the v1 schema
  (``svdq-int4_r32-sana1.6b``): SANA 1.6B's odd widths stored as nunchaku
  stores them, N padded to 128 and K to 128 (2240 -> 2304, 5600 -> 5632,
  6720 -> 6784, 11200 -> 11264), the random codes of the padded rows and
  columns meeting zero activations or cut off by the logical width;
  ``pag_layers`` carry ``attn.pag_to_v``;
* :func:`zimage_state` -- a Z-Image transformer in the v2 schema
  (``svdq-int4_r32/r128/r256-z-image-turbo``, ``svdq-fp4_r32/r128-z-image-turbo``;
  Z-Image-Turbo's dims by default), int4 or nvfp4 at any rank,
  ``skip_refiners`` for 16-bit refiner linears;
* :func:`t5_state` (TinyChat W4 linears), :func:`clip_state` and
  :func:`vae_state` (bf16 HF / diffusers files; the VAE's decoder, and its
  encoder on request);
* :func:`lora_state` -- a FLUX LoRA at any width and rank, in the diffusers,
  peft or kohya key flavor (``lora.flux.convert.to_canonical`` reads all
  three), on every leaf of the chosen blocks.

Every packed byte is a valid weight code (any nibble is an int4 or e2m1
code) and the packed layouts only permute values drawn independently, so
the tensors are drawn directly in their stored shapes, with no packing
pass. Scales are the exception to "any bytes": e4m3 micro-scales are drawn
finite and positive (a random byte can be NaN or reach 448). Magnitudes
follow the JAX ``random_init``: group scales ``|N| / (7 sqrt(K))``, low-rank
factors and biases ``0.02 N``, plain weights ``N / sqrt(K)``. Tensors are
made on ``device`` and written with :func:`write`, one at a time.
"""

from __future__ import annotations

import json
import math

import torch

from ..utils.safetensors import save_safetensors


class _Draw:
    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device

    def normal(self, shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=self.gen, device=self.device) * scale).to(dtype)

    def uniform(self, shape, lo, hi, dtype=torch.bfloat16):
        return (torch.rand(shape, generator=self.gen, device=self.device) * (hi - lo) + lo).to(dtype)

    def bytes(self, shape, dtype=torch.int8):
        """Random bytes viewed as ``dtype`` (the last dim in elements)."""
        size = torch.empty((), dtype=dtype).element_size()
        raw = torch.randint(-128, 128, (*shape[:-1], shape[-1] * size), dtype=torch.int8, generator=self.gen,
                            device=self.device)
        return raw.view(dtype)


def _svdq(t, d: _Draw, key, k, n, rank, precision, v2=False):
    std = 1.0 / math.sqrt(k)
    t[f"{key}.qweight"] = d.bytes((n, k // 2))
    if precision == "nvfp4":
        t[f"{key}.wscales"] = d.uniform((k // 16, n), 0.5, 4.0, torch.float32).to(torch.float8_e4m3fn)
        t[f"{key}.wtscale"] = torch.full((1,), std / 14.0, dtype=torch.float32, device=d.device)
    else:
        t[f"{key}.wscales"] = (d.normal((k // 64, n), dtype=torch.float32).abs() * (std / 7.0)).to(torch.bfloat16)
    t[f"{key}.smooth_factor" if v2 else f"{key}.smooth"] = d.uniform((k,), 0.8, 1.25)
    if v2:
        t[f"{key}.proj_down"] = d.normal((k, rank), 0.02)
        t[f"{key}.proj_up"] = d.normal((n, rank), 0.02)
    else:
        t[f"{key}.lora_down"] = d.normal((k, rank), 0.02)
        t[f"{key}.lora_up"] = d.normal((n, rank), 0.02)
    t[f"{key}.bias"] = d.normal((n,), 0.02)


def _awq(t, d: _Draw, key, k, n):
    std = 1.0 / math.sqrt(k)
    t[f"{key}.qweight"] = d.bytes((n // 4, k // 2), torch.int32)  # (oc/4, ic/8*4), 8 nibbles a word
    t[f"{key}.wscales"] = (d.normal((k // 64, n), dtype=torch.float32).abs() * (std / 8.0)).to(torch.bfloat16)
    t[f"{key}.wzeros"] = d.normal((k // 64, n), std)  # stored negated; the sign of a normal draw is moot
    t[f"{key}.bias"] = d.normal((n,), 0.02)


def _linear(t, d: _Draw, key, k, n, bias=True):
    t[f"{key}.weight"] = d.normal((n, k), 1.0 / math.sqrt(k))
    if bias:
        t[f"{key}.bias"] = d.normal((n,), 0.02)


def _ones(t, d: _Draw, key, n):
    t[key] = d.uniform((n,), 0.9, 1.1)


def flux_state(*, layers=19, single=38, heads=24, head_dim=128, joint=4096, pooled=768, rank=32,
               precision="nvfp4", in_channels=64, seed=0, device="cuda"):
    """-> (tensors, metadata) of a FLUX.1 v1-schema checkpoint;
    ``in_channels`` 64 (FLUX.1-dev, Kontext), 128 (Canny / Depth: control
    latents on the channel axis) or 384 (Fill: masked image + mask), the
    width of ``x_embedder`` and the config's ``in_channels``."""
    d, t = _Draw(seed, device), {}
    dim = heads * head_dim
    for i in range(layers):
        p = f"transformer_blocks.{i}"
        for name, k, n in (("qkv_proj", dim, 3 * dim), ("qkv_proj_context", dim, 3 * dim), ("out_proj", dim, dim),
                           ("out_proj_context", dim, dim), ("mlp_fc1", dim, 4 * dim), ("mlp_fc2", 4 * dim, dim),
                           ("mlp_context_fc1", dim, 4 * dim), ("mlp_context_fc2", 4 * dim, dim)):
            _svdq(t, d, f"{p}.{name}", k, n, rank, precision)
        _awq(t, d, f"{p}.norm1.linear", dim, 6 * dim)
        _awq(t, d, f"{p}.norm1_context.linear", dim, 6 * dim)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            _ones(t, d, f"{p}.{nm}.weight", head_dim)
    for i in range(single):
        p = f"single_transformer_blocks.{i}"
        for name, k, n in (("qkv_proj", dim, 3 * dim), ("mlp_fc1", dim, 4 * dim), ("mlp_fc2", 4 * dim, dim),
                           ("out_proj", dim, dim)):
            _svdq(t, d, f"{p}.{name}", k, n, rank, precision)
        _awq(t, d, f"{p}.norm.linear", dim, 3 * dim)
        for nm in ("norm_q", "norm_k"):
            _ones(t, d, f"{p}.{nm}.weight", head_dim)
    te = "time_text_embed"
    for name, k, n in (("x_embedder", in_channels, dim), ("context_embedder", joint, dim),
                       (f"{te}.timestep_embedder.linear_1", 256, dim), (f"{te}.timestep_embedder.linear_2", dim, dim),
                       (f"{te}.text_embedder.linear_1", pooled, dim), (f"{te}.text_embedder.linear_2", dim, dim),
                       (f"{te}.guidance_embedder.linear_1", 256, dim), (f"{te}.guidance_embedder.linear_2", dim, dim),
                       ("norm_out.linear", dim, 2 * dim), ("proj_out", dim, 64)):
        _linear(t, d, name, k, n)
    config = dict(num_layers=layers, num_single_layers=single, attention_head_dim=head_dim,
                  num_attention_heads=heads, joint_attention_dim=joint, pooled_projection_dim=pooled,
                  in_channels=in_channels, guidance_embeds=True, axes_dims_rope=[16, 56, 56])
    weight = {"dtype": "fp4_e2m1_all", "group_size": 16} if precision == "nvfp4" else {"dtype": "int4",
                                                                                        "group_size": 64}
    return t, _meta(config, {"method": "svdquant", "weight": weight, "rank": rank})


def qwen_state(*, layers=60, heads=24, head_dim=128, joint=3584, rank=128, precision="int4", txt_norm=True,
               seed=0, device="cuda"):
    """-> (tensors, metadata) of a Qwen-Image v2-schema checkpoint."""
    d, t = _Draw(seed, device), {}
    dim = heads * head_dim
    for i in range(layers):
        p = f"transformer_blocks.{i}"
        for name, k, n in (("attn.to_qkv", dim, 3 * dim), ("attn.add_qkv_proj", dim, 3 * dim),
                           ("attn.to_out.0", dim, dim), ("attn.to_add_out", dim, dim),
                           ("img_mlp.net.0.proj", dim, 4 * dim), ("img_mlp.net.2", 4 * dim, dim),
                           ("txt_mlp.net.0.proj", dim, 4 * dim), ("txt_mlp.net.2", 4 * dim, dim)):
            _svdq(t, d, f"{p}.{name}", k, n, rank, precision, v2=True)
        _awq(t, d, f"{p}.img_mod.1", dim, 6 * dim)
        _awq(t, d, f"{p}.txt_mod.1", dim, 6 * dim)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            _ones(t, d, f"{p}.attn.{nm}.weight", head_dim)
    te = "time_text_embed.timestep_embedder"
    for name, k, n in (("img_in", 64, dim), ("txt_in", joint, dim), (f"{te}.linear_1", 256, dim),
                       (f"{te}.linear_2", dim, dim), ("norm_out.linear", dim, 2 * dim), ("proj_out", dim, 64)):
        _linear(t, d, name, k, n)
    if txt_norm:
        _ones(t, d, "txt_norm.weight", joint)
    config = dict(num_layers=layers, attention_head_dim=head_dim, num_attention_heads=heads,
                  joint_attention_dim=joint, in_channels=64, out_channels=16, axes_dims_rope=[16, 56, 56])
    weight = {"dtype": "fp4_e2m1_all", "group_size": 16} if precision == "nvfp4" else {"dtype": "int4",
                                                                                        "group_size": 64}
    return t, _meta(config, {"method": "svdquant", "weight": weight, "rank": rank})


def sana_state(*, layers=20, heads=70, cross_heads=20, caption=2304, expand_ratio=2.5, rank=32, pag_layers=(),
               seed=0, device="cuda"):
    """-> (tensors, metadata) of an int4 SANA v1-schema checkpoint (SANA 1.6B's shapes by default)."""
    d, t = _Draw(seed, device), {}
    dim = heads * 32
    hid = int(dim * expand_ratio)
    pad = lambda x: x + (-x) % 128

    def svdq(key, k, n, bias=True):
        _svdq(t, d, key, pad(k), pad(n), rank, "int4")
        if not bias:
            del t[f"{key}.bias"]

    for i in range(layers):
        p = f"transformer_blocks.{i}"
        svdq(f"{p}.attn.qkv_proj", dim, 3 * dim, bias=False)
        svdq(f"{p}.attn.out_proj", dim, dim, bias=False)
        if i in pag_layers:
            svdq(f"{p}.attn.pag_to_v", dim, dim, bias=False)
        svdq(f"{p}.cross_attn.q_linear", dim, dim)
        _linear(t, d, f"{p}.cross_attn.kv_linear", dim, 2 * dim)
        svdq(f"{p}.cross_attn.out_proj", dim, dim)
        svdq(f"{p}.ff.inverted_conv", dim, 2 * hid)
        t[f"{p}.ff.depth_conv.weight"] = d.normal((2 * hid, 1, 3, 3), 1.0 / 3.0)
        t[f"{p}.ff.depth_conv.bias"] = d.normal((2 * hid,), 0.02)
        svdq(f"{p}.ff.point_conv", hid, dim, bias=False)
        t[f"{p}.scale_shift_table"] = d.normal((6, dim), 0.02, torch.float32)
    t["patch_embed.proj.weight"] = d.normal((dim, 32, 1, 1), 1.0 / math.sqrt(32))
    t["patch_embed.proj.bias"] = d.normal((dim,), 0.02)
    te = "adaln_single.emb.timestep_embedder"
    for name, k, n in (("caption_projection.linear_1", caption, dim), ("caption_projection.linear_2", dim, dim),
                       (f"{te}.linear_1", 256, dim), (f"{te}.linear_2", dim, dim), ("adaln_single.linear", dim, 6 * dim),
                       ("proj_out", dim, 32)):
        _linear(t, d, name, k, n)
    t["scale_shift_table"] = d.normal((2, dim), 0.02, torch.float32)
    config = dict(num_layers=layers, num_attention_heads=heads, attention_head_dim=32,
                  num_cross_attention_heads=cross_heads, cross_attention_head_dim=dim // cross_heads,
                  caption_channels=caption, in_channels=32, out_channels=32, expand_ratio=expand_ratio)
    return t, _meta(config, {"method": "svdquant", "weight": {"dtype": "int4", "group_size": 64}, "rank": rank})


def zimage_state(*, dim=3840, layers=30, refiners=2, heads=30, cap=2560, ffn_inner=10240, t_dim=None, rank=32,
                 precision="int4", skip_refiners=False, seed=0, device="cuda"):
    """-> (tensors, metadata) of a Z-Image v2-schema checkpoint: Z-Image-Turbo's
    transformer dims by default (dim 3840, 30 layers, 2 + 2 refiner layers,
    30 heads of 128, caption features 2560, FFN 10240, axes (32, 48, 48), 16
    latent channels, patch 2). The timestep embedder and adaLN linears are
    ``t_dim`` wide (default min(dim, 1024), the JAX ``random_init``'s; the
    loader takes their shapes from the file). The nvfp4 per-channel
    ``wcscales`` are left out (the loaders take them when present)."""
    d, t = _Draw(seed, device), {}
    td = min(dim, 1024) if t_dim is None else t_dim
    hd = dim // heads

    def block(p, modulated, quantized):
        for name, k, n in (("attention.to_qkv", dim, 3 * dim), ("attention.to_out.0", dim, dim),
                           ("feed_forward.net.0.proj", dim, 2 * ffn_inner), ("feed_forward.net.2", ffn_inner, dim)):
            if quantized:
                _svdq(t, d, f"{p}.{name}", k, n, rank, precision, v2=True)
            else:
                _linear(t, d, f"{p}.{name}", k, n)
        for nm in ("norm_q", "norm_k"):
            _ones(t, d, f"{p}.attention.{nm}.weight", hd)
        for nm in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            _ones(t, d, f"{p}.{nm}.weight", dim)
        if modulated:
            _linear(t, d, f"{p}.adaLN_modulation.1", td, 4 * dim)

    for i in range(layers):
        block(f"layers.{i}", True, True)
    for i in range(refiners):
        block(f"noise_refiner.{i}", True, not skip_refiners)
        block(f"context_refiner.{i}", False, not skip_refiners)
    for name, k, n in (("x_embedder", 64, dim), ("t_embedder.mlp.0", 256, td), ("t_embedder.mlp.2", td, td),
                       ("cap_embedder.1", cap, dim), ("final_layer.linear", dim, 64),
                       ("final_layer.adaLN_modulation.1", td, dim)):
        _linear(t, d, name, k, n)
    _ones(t, d, "cap_embedder.0.weight", cap)
    _ones(t, d, "norm_out.weight", dim)
    config = dict(dim=dim, num_layers=layers, num_refiner_layers=refiners, num_attention_heads=heads, in_channels=16,
                  patch_size=2, cap_feat_dim=cap, axes_dims_rope=[32, 48, 48], norm_eps=1e-5, ffn_inner=ffn_inner)
    weight = {"dtype": "fp4_e2m1_all", "group_size": 16} if precision == "nvfp4" else {"dtype": "int4",
                                                                                        "group_size": 64}
    qcfg = {"method": "svdquant", "weight": weight, "rank": rank}
    if skip_refiners:
        qcfg["skip_refiners"] = True
    return t, _meta(config, qcfg)


def t5_state(*, vocab=32128, d_model=4096, d_ff=10240, d_kv=64, heads=64, layers=24, group=128, seed=0,
             device="cuda"):
    """-> (tensors, metadata) of a T5 encoder with TinyChat W4 linears
    (``qweight`` (oc/4, ic) int16, ``wscales`` / ``wzeros`` (ic/G, oc))."""
    d, t = _Draw(seed, device), {}
    inner = heads * d_kv

    def w4(key, ic, oc):
        std = 1.0 / math.sqrt(ic)
        t[f"{key}.qweight"] = d.bytes((oc // 4, ic), torch.int16)  # 4 nibbles an element
        t[f"{key}.wscales"] = (d.normal((ic // group, oc), dtype=torch.float32).abs() * (std / 8.0)).to(torch.bfloat16)
        t[f"{key}.wzeros"] = d.normal((ic // group, oc), std)

    for i in range(layers):
        p = f"encoder.block.{i}"
        a, f = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        for nm in ("q", "k", "v"):
            w4(f"{a}.{nm}", d_model, inner)
        w4(f"{a}.o", inner, d_model)
        w4(f"{f}.wi_0", d_model, d_ff)
        w4(f"{f}.wi_1", d_model, d_ff)
        w4(f"{f}.wo", d_ff, d_model)
        if i == 0:
            t[f"{a}.relative_attention_bias.weight"] = d.normal((32, heads), 0.02, torch.float32)
        _ones(t, d, f"{p}.layer.0.layer_norm.weight", d_model)
        _ones(t, d, f"{p}.layer.1.layer_norm.weight", d_model)
    t["shared.weight"] = d.normal((vocab, d_model))
    _ones(t, d, "encoder.final_layer_norm.weight", d_model)
    return t, _meta(dict(d_model=d_model, num_heads=heads, d_kv=d_kv, num_layers=layers), None)


def clip_state(*, vocab=49408, d=768, layers=12, max_pos=77, seed=0, device="cuda"):
    """-> (tensors, metadata) of an HF CLIPTextModel (``text_model.*``), bf16."""
    dr, t = _Draw(seed, device), {}
    m = "text_model"
    t[f"{m}.embeddings.token_embedding.weight"] = dr.normal((vocab, d), 0.02)
    t[f"{m}.embeddings.position_embedding.weight"] = dr.normal((max_pos, d), 0.02)
    for i in range(layers):
        p = f"{m}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            _ones(t, dr, f"{p}.{ln}.weight", d)
            t[f"{p}.{ln}.bias"] = dr.normal((d,), 0.02)
        for nm in ("q", "k", "v", "out"):
            _linear(t, dr, f"{p}.self_attn.{nm}_proj", d, d)
        _linear(t, dr, f"{p}.mlp.fc1", d, 4 * d)
        _linear(t, dr, f"{p}.mlp.fc2", 4 * d, d)
    _ones(t, dr, f"{m}.final_layer_norm.weight", d)
    t[f"{m}.final_layer_norm.bias"] = dr.normal((d,), 0.02)
    return t, _meta(None, None)


def vae_state(*, latent_channels=16, block_out_channels=(128, 256, 512, 512), layers_per_block=2, encoder=False,
              seed=0, device="cuda"):
    """-> (tensors, metadata) of a diffusers AutoencoderKL's decoder, and
    with ``encoder`` its encoder too (``encoder.*`` keys: down blocks with
    downsamplers, mid block, ``conv_out`` to 2 x ``latent_channels``
    moments), bf16 (norms ones and zeros, convolutions ``N / sqrt(fan_in)``
    with zero biases, as the JAX ``random_init`` draws them)."""
    dr, t = _Draw(seed, device), {}

    def conv(key, cin, cout, k=3):
        t[f"{key}.weight"] = dr.normal((cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))
        t[f"{key}.bias"] = torch.zeros((cout,), dtype=torch.bfloat16, device=device)

    def norm(key, c):
        t[f"{key}.weight"] = torch.ones((c,), dtype=torch.bfloat16, device=device)
        t[f"{key}.bias"] = torch.zeros((c,), dtype=torch.bfloat16, device=device)

    def resnet(key, cin, cout):
        norm(f"{key}.norm1", cin)
        conv(f"{key}.conv1", cin, cout)
        norm(f"{key}.norm2", cout)
        conv(f"{key}.conv2", cout, cout)
        if cin != cout:
            conv(f"{key}.conv_shortcut", cin, cout, k=1)

    def mid(key, c):
        resnet(f"{key}.mid_block.resnets.0", c, c)
        a = f"{key}.mid_block.attentions.0"
        norm(f"{a}.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):  # diffusers keeps these as Linear layers
            t[f"{a}.{nm}.weight"] = dr.normal((c, c), 1.0 / math.sqrt(c))
            t[f"{a}.{nm}.bias"] = torch.zeros((c,), dtype=torch.bfloat16, device=device)
        resnet(f"{key}.mid_block.resnets.1", c, c)

    dd = "decoder"
    rev = list(reversed(block_out_channels))
    ch = rev[0]
    conv(f"{dd}.conv_in", latent_channels, ch)
    mid(dd, ch)
    prev = ch
    for i, c in enumerate(rev):
        for j in range(layers_per_block + 1):
            resnet(f"{dd}.up_blocks.{i}.resnets.{j}", prev, c)
            prev = c
        if i < len(rev) - 1:
            conv(f"{dd}.up_blocks.{i}.upsamplers.0.conv", c, c)
    norm(f"{dd}.conv_norm_out", block_out_channels[0])
    conv(f"{dd}.conv_out", block_out_channels[0], 3)
    if encoder:
        ee = "encoder"
        prev = block_out_channels[0]
        conv(f"{ee}.conv_in", 3, prev)
        for i, c in enumerate(block_out_channels):
            for j in range(layers_per_block):
                resnet(f"{ee}.down_blocks.{i}.resnets.{j}", prev, c)
                prev = c
            if i < len(block_out_channels) - 1:
                conv(f"{ee}.down_blocks.{i}.downsamplers.0.conv", c, c)
        mid(ee, ch)
        norm(f"{ee}.conv_norm_out", ch)
        conv(f"{ee}.conv_out", ch, 2 * latent_channels)
    return t, _meta(None, None)


def _lora_leaves(flavor: str, dim: int):
    """(name, K, N) of every LoRA leaf of a dual and of a single block."""
    if flavor == "kohya":
        dual = [("img_attn_qkv", dim, 3 * dim), ("txt_attn_qkv", dim, 3 * dim), ("img_attn_proj", dim, dim),
                ("txt_attn_proj", dim, dim), ("img_mlp_0", dim, 4 * dim), ("img_mlp_2", 4 * dim, dim),
                ("txt_mlp_0", dim, 4 * dim), ("txt_mlp_2", 4 * dim, dim), ("img_mod_lin", dim, 6 * dim),
                ("txt_mod_lin", dim, 6 * dim)]
        single = [("linear1", dim, 7 * dim), ("linear2", 5 * dim, dim), ("modulation_lin", dim, 3 * dim)]
        return dual, single
    qkv = [(f"attn.to_{c}", dim, dim) for c in "qkv"] + [(f"attn.add_{c}_proj", dim, dim) for c in "qkv"]
    dual = qkv + [("attn.to_out.0", dim, dim), ("attn.to_add_out", dim, dim), ("ff.net.0.proj", dim, 4 * dim),
                  ("ff.net.2", 4 * dim, dim), ("ff_context.net.0.proj", dim, 4 * dim), ("ff_context.net.2", 4 * dim, dim),
                  ("norm1.linear", dim, 6 * dim), ("norm1_context.linear", dim, 6 * dim)]
    single = qkv[:3] + [("proj_mlp", dim, 4 * dim), ("proj_out", 5 * dim, dim), ("norm.linear", dim, 3 * dim)]
    return dual, single


def lora_state(cfg, rank: int, flavor: str = "diffusers", layers=None, alpha: float | None = None, seed=0,
               device="cuda"):
    """-> (tensors, metadata) of a FLUX LoRA of ``rank`` for the widths of
    ``cfg`` (a ``FluxConfig``): every leaf of dual blocks ``layers[0]`` and
    single blocks ``layers[1]`` (default: all of ``cfg``'s). ``flavor``:
    ``"diffusers"`` (``transformer.<block>.<leaf>.lora_A.weight``, q / k / v
    apart), ``"peft"`` (``<block>.<leaf>.lora_A.default.weight``) or
    ``"kohya"`` (``lora_unet_double_blocks_<i>_<leaf>.lora_down.weight``,
    fused qkv and ``linear1`` / ``linear2``, and ``.alpha``, default the
    rank). A (r, K) and B (N, r) are ``0.02 N`` in bf16."""
    if flavor not in ("diffusers", "peft", "kohya"):
        raise ValueError(f"unknown LoRA flavor {flavor!r}")
    d, t = _Draw(seed, device), {}
    dual, single = _lora_leaves(flavor, cfg.dim)
    if layers is None:
        layers = (range(cfg.num_layers), range(cfg.num_single_layers))
    for blocks, leaves, idx in (("transformer_blocks", dual, layers[0]),
                                ("single_transformer_blocks", single, layers[1])):
        for i in idx:
            for leaf, k, n in leaves:
                if flavor == "kohya":
                    key = f"lora_unet_{'double' if blocks == 'transformer_blocks' else 'single'}_blocks_{i}_{leaf}"
                    t[f"{key}.lora_down.weight"] = d.normal((rank, k), 0.02)
                    t[f"{key}.lora_up.weight"] = d.normal((n, rank), 0.02)
                    t[f"{key}.alpha"] = torch.tensor(float(rank if alpha is None else alpha), device=device)
                else:
                    key = f"{'transformer.' if flavor == 'diffusers' else ''}{blocks}.{i}.{leaf}"
                    tail = ".default.weight" if flavor == "peft" else ".weight"
                    t[f"{key}.lora_A{tail}"] = d.normal((rank, k), 0.02)
                    t[f"{key}.lora_B{tail}"] = d.normal((n, rank), 0.02)
    return t, _meta(None, None)


def _meta(config, qcfg):
    meta = {}
    if config is not None:
        meta["config"] = json.dumps(config)
    if qcfg is not None:
        meta["quantization_config"] = json.dumps(qcfg)
    return meta


def write(path, state) -> int:
    """Write ``(tensors, metadata)`` to ``path``; returns the file's bytes."""
    tensors, meta = state
    save_safetensors(path, tensors, meta)
    return sum(x.numel() * x.element_size() for x in tensors.values())
