"""Small nunchaku-format checkpoints for the port's CPU parity tests, and
the comparison of a port model with the JAX model loaded from the same file.

Values are drawn with numpy from a seed and packed with the JAX package's
``nunchaku_format`` packers, then written with its safetensors writer, so
the port's decoders are checked against files they had no part in making.
FLUX in the v1 schema (MMA-packed low-rank factors), Qwen-Image in the v2
schema (plain ``proj_down`` / ``proj_up``, ``smooth_factor``), SANA in the v1
schema (odd widths zero-padded, as nunchaku stores them), Z-Image in the v2
schema (int4 or nvfp4, optionally with 16-bit refiners), a TinyChat W4 T5,
and HF CLIP / diffusers VAE state dicts.

e2m1 codes are drawn in [-7, 7], the codes a quantizer emits: the JAX
loader's table decode turns the stray code -8 into NaN at int8, the port
into -8 (the dequant kernel's value), so files with -8 are no common ground.
The AdaLN modulation is drawn small (scales ~0.001, gates and scales up to
~0.1-0.5), as the small 4-bit models' checks damp it
(``checks.damp_modulation``: a 4-bit activation code is a seventh of its
group's range, and large random gates amplify code flips between two
correct implementations beyond 2e-2).
"""

import functools
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from nunchaku_tpu.utils import nunchaku_format as NF
from nunchaku_tpu.utils.safetensors import save_safetensors
from nunchaku_tpu_torch.models.linear import SVDQW4A4Linear
from nunchaku_tpu_torch.models.normalization import AdaLayerNormZero, AdaLayerNormZeroSingle

BF16, E4M3 = ml_dtypes.bfloat16, ml_dtypes.float8_e4m3fn
HEAD_DIM = 128


def _svdq(t, rng, key, k, n, rank, precision, v2=False):
    std = 1.0 / np.sqrt(k)
    if precision == "nvfp4":
        vals = rng.integers(-7, 8, (n, k)).astype(np.int8)
        micro = rng.uniform(0.5, 4.0, (k // 16, n)).astype(E4M3)
        t[f"{key}.wscales"] = NF.pack_micro_scale_ref(micro.view(np.uint8)).view(E4M3)
        t[f"{key}.wtscale"] = np.array([std / 14.0], np.float32)
        wcs = rng.uniform(0.5, 2.0, (1, n)).astype(E4M3)
        t[f"{key}.wcscales"] = NF.pack_scale_ref(wcs.view(np.uint8)).reshape(n).view(E4M3)
    else:
        vals = rng.integers(-8, 8, (n, k)).astype(np.int8)
        ws = (np.abs(rng.standard_normal((k // 64, n))) * std / 7.0).astype(np.float32)
        t[f"{key}.wscales"] = NF.pack_scale_ref(ws).astype(BF16)
    t[f"{key}.qweight"] = NF.pack_weight_int4(vals)
    t[f"{key}.smooth_factor" if v2 else f"{key}.smooth"] = rng.uniform(0.5, 2.0, k).astype(BF16)
    pd = (rng.standard_normal((rank, k)) * 0.02).astype(np.float32)  # (R, K) torch layout
    pu = (rng.standard_normal((n, rank)) * 0.02).astype(np.float32)  # (N, R)
    if v2:
        t[f"{key}.proj_down"] = pd.T.astype(BF16)
        t[f"{key}.proj_up"] = pu.astype(BF16)
    else:
        t[f"{key}.lora_down"] = NF.pack_lowrank_weight_ref(pd, down=True).astype(BF16)
        t[f"{key}.lora_up"] = NF.pack_lowrank_weight_ref(pu, down=False).astype(BF16)
    t[f"{key}.bias"] = (rng.standard_normal(n) * 0.02).astype(BF16)


def _awq(t, rng, key, k, n):
    codes = rng.integers(0, 16, (n, k)).astype(np.int8)
    t[f"{key}.qweight"] = NF.pack_awq_gemv(codes)
    t[f"{key}.wscales"] = (rng.random((k // 64, n)) * 0.002).astype(BF16)
    t[f"{key}.wzeros"] = (rng.standard_normal((k // 64, n)) * 0.002).astype(BF16)
    t[f"{key}.bias"] = (rng.standard_normal(n) * 0.01).astype(BF16)


def _linear(t, rng, key, k, n, bias=True):
    t[f"{key}.weight"] = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(BF16)
    if bias:
        t[f"{key}.bias"] = (rng.standard_normal(n) * 0.02).astype(BF16)


def _norm(t, rng, key, n):
    t[key] = rng.uniform(0.5, 1.5, n).astype(BF16)


def _meta(config, precision, rank):
    weight = {"dtype": "fp4_e2m1_all", "group_size": 16} if precision == "nvfp4" else {"dtype": "int4",
                                                                                        "group_size": 64}
    qcfg = {"method": "svdquant", "weight": weight, "rank": rank}
    return {"config": json.dumps(config), "quantization_config": json.dumps(qcfg)}


FLUX = dict(layers=1, single=1, heads=2, joint=320, pooled=128)


def flux_checkpoint(path, precision, rank=32, seed=0):
    """A 1 + 1-block FLUX.1 checkpoint (dim 256) in the v1 schema."""
    rng = np.random.default_rng(seed)
    dim, t = FLUX["heads"] * HEAD_DIM, {}
    for i in range(FLUX["layers"]):
        p = f"transformer_blocks.{i}"
        for name, k, n in (("qkv_proj", dim, 3 * dim), ("qkv_proj_context", dim, 3 * dim), ("out_proj", dim, dim),
                           ("out_proj_context", dim, dim), ("mlp_fc1", dim, 4 * dim), ("mlp_fc2", 4 * dim, dim),
                           ("mlp_context_fc1", dim, 4 * dim), ("mlp_context_fc2", 4 * dim, dim)):
            _svdq(t, rng, f"{p}.{name}", k, n, rank, precision)
        _awq(t, rng, f"{p}.norm1.linear", dim, 6 * dim)
        _awq(t, rng, f"{p}.norm1_context.linear", dim, 6 * dim)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            _norm(t, rng, f"{p}.{nm}.weight", HEAD_DIM)
    for i in range(FLUX["single"]):
        p = f"single_transformer_blocks.{i}"
        for name, k, n in (("qkv_proj", dim, 3 * dim), ("mlp_fc1", dim, 4 * dim), ("mlp_fc2", 4 * dim, dim),
                           ("out_proj", dim, dim)):
            _svdq(t, rng, f"{p}.{name}", k, n, rank, precision)
        _awq(t, rng, f"{p}.norm.linear", dim, 3 * dim)
        for nm in ("norm_q", "norm_k"):
            _norm(t, rng, f"{p}.{nm}.weight", HEAD_DIM)
    te = "time_text_embed"
    for name, k, n in (("x_embedder", 64, dim), ("context_embedder", FLUX["joint"], dim),
                       (f"{te}.timestep_embedder.linear_1", 256, dim), (f"{te}.timestep_embedder.linear_2", dim, dim),
                       (f"{te}.text_embedder.linear_1", FLUX["pooled"], dim), (f"{te}.text_embedder.linear_2", dim, dim),
                       (f"{te}.guidance_embedder.linear_1", 256, dim), (f"{te}.guidance_embedder.linear_2", dim, dim),
                       ("norm_out.linear", dim, 2 * dim), ("proj_out", dim, 64)):
        _linear(t, rng, name, k, n)
    config = dict(num_layers=FLUX["layers"], num_single_layers=FLUX["single"], attention_head_dim=HEAD_DIM,
                  num_attention_heads=FLUX["heads"], joint_attention_dim=FLUX["joint"],
                  pooled_projection_dim=FLUX["pooled"], in_channels=64, guidance_embeds=True,
                  axes_dims_rope=[16, 56, 56])
    save_safetensors(path, t, _meta(config, precision, rank))
    return path


QWEN = dict(layers=2, heads=2, joint=320)


def qwen_checkpoint(path, precision="int4", rank=128, seed=0):
    """A 2-block Qwen-Image checkpoint (dim 256, joint 320) in the v2 schema,
    with ``txt_norm``."""
    rng = np.random.default_rng(seed)
    dim, t = QWEN["heads"] * HEAD_DIM, {}
    for i in range(QWEN["layers"]):
        p = f"transformer_blocks.{i}"
        for name, k, n in (("attn.to_qkv", dim, 3 * dim), ("attn.add_qkv_proj", dim, 3 * dim),
                           ("attn.to_out.0", dim, dim), ("attn.to_add_out", dim, dim),
                           ("img_mlp.net.0.proj", dim, 4 * dim), ("img_mlp.net.2", 4 * dim, dim),
                           ("txt_mlp.net.0.proj", dim, 4 * dim), ("txt_mlp.net.2", 4 * dim, dim)):
            _svdq(t, rng, f"{p}.{name}", k, n, rank, precision, v2=True)
        _awq(t, rng, f"{p}.img_mod.1", dim, 6 * dim)
        _awq(t, rng, f"{p}.txt_mod.1", dim, 6 * dim)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            _norm(t, rng, f"{p}.attn.{nm}.weight", HEAD_DIM)
    te = "time_text_embed.timestep_embedder"
    for name, k, n in (("img_in", 64, dim), ("txt_in", QWEN["joint"], dim), (f"{te}.linear_1", 256, dim),
                       (f"{te}.linear_2", dim, dim), ("norm_out.linear", dim, 2 * dim), ("proj_out", dim, 64)):
        _linear(t, rng, name, k, n)
    _norm(t, rng, "txt_norm.weight", QWEN["joint"])
    config = dict(num_layers=QWEN["layers"], attention_head_dim=HEAD_DIM, num_attention_heads=QWEN["heads"],
                  joint_attention_dim=QWEN["joint"], in_channels=64, out_channels=16, axes_dims_rope=[16, 56, 56])
    save_safetensors(path, t, _meta(config, precision, rank))
    return path


T5 = dict(vocab=100, d_model=256, d_ff=512, d_kv=64, heads=4, layers=2)


def t5_state(quantized: bool, group=128, seed=0):
    """A small T5 encoder's HF state dict: TinyChat W4 linears (group 128)
    or bf16 ones -> (dict, config)."""
    rng = np.random.default_rng(seed)
    t, c = {}, T5
    inner = c["heads"] * c["d_kv"]

    def lin(key, ic, oc):
        if quantized:
            t[f"{key}.qweight"] = NF.pack_tinychat_w4(rng.integers(0, 16, (oc, ic)).astype(np.int8))
            t[f"{key}.wscales"] = (rng.random((ic // group, oc)) * 0.01).astype(BF16)
            t[f"{key}.wzeros"] = (rng.standard_normal((ic // group, oc)) * 0.02).astype(BF16)
        else:
            _linear(t, rng, key, ic, oc, bias=False)

    for i in range(c["layers"]):
        p = f"encoder.block.{i}"
        a, f = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        for nm in ("q", "k", "v"):
            lin(f"{a}.{nm}", c["d_model"], inner)
        lin(f"{a}.o", inner, c["d_model"])
        lin(f"{f}.wi_0", c["d_model"], c["d_ff"])
        lin(f"{f}.wi_1", c["d_model"], c["d_ff"])
        lin(f"{f}.wo", c["d_ff"], c["d_model"])
        if i == 0:
            t[f"{a}.relative_attention_bias.weight"] = (rng.standard_normal((32, c["heads"])) * 0.1).astype(np.float32)
        _norm(t, rng, f"{p}.layer.0.layer_norm.weight", c["d_model"])
        _norm(t, rng, f"{p}.layer.1.layer_norm.weight", c["d_model"])
    t["shared.weight"] = rng.standard_normal((c["vocab"], c["d_model"])).astype(BF16)
    _norm(t, rng, "encoder.final_layer_norm.weight", c["d_model"])
    return t, dict(d_model=c["d_model"], num_heads=c["heads"], d_kv=c["d_kv"], num_layers=c["layers"])


CLIP = dict(vocab=100, d=128, heads=2, layers=2, max_pos=77)


def clip_state(seed=0):
    rng = np.random.default_rng(seed)
    t, d, m = {}, CLIP["d"], "text_model"
    t[f"{m}.embeddings.token_embedding.weight"] = (rng.standard_normal((CLIP["vocab"], d)) * 0.5).astype(BF16)
    t[f"{m}.embeddings.position_embedding.weight"] = (rng.standard_normal((CLIP["max_pos"], d)) * 0.1).astype(BF16)
    for i in range(CLIP["layers"]):
        p = f"{m}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            _norm(t, rng, f"{p}.{ln}.weight", d)
            t[f"{p}.{ln}.bias"] = (rng.standard_normal(d) * 0.02).astype(BF16)
        for nm in ("q", "k", "v", "out"):
            _linear(t, rng, f"{p}.self_attn.{nm}_proj", d, d)
        _linear(t, rng, f"{p}.mlp.fc1", d, 4 * d)
        _linear(t, rng, f"{p}.mlp.fc2", 4 * d, d)
    _norm(t, rng, f"{m}.final_layer_norm.weight", d)
    t[f"{m}.final_layer_norm.bias"] = (rng.standard_normal(d) * 0.02).astype(BF16)
    return t


VAE = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1)


def vae_state(seed=0):
    """A small diffusers AutoencoderKL decoder state dict (attention
    projections stored as Linear weights, as diffusers keeps them)."""
    rng = np.random.default_rng(seed)
    t = {}

    def conv(key, cin, cout, k=3, damp=1.0):
        t[f"{key}.weight"] = (rng.standard_normal((cout, cin, k, k)) * damp / np.sqrt(cin * k * k)).astype(BF16)
        t[f"{key}.bias"] = (rng.standard_normal(cout) * 0.02).astype(BF16)

    def norm(key, c):
        _norm(t, rng, f"{key}.weight", c)
        t[f"{key}.bias"] = (rng.standard_normal(c) * 0.02).astype(BF16)

    def resnet(key, cin, cout):
        norm(f"{key}.norm1", cin)
        conv(f"{key}.conv1", cin, cout)
        norm(f"{key}.norm2", cout)
        conv(f"{key}.conv2", cout, cout, damp=0.25)
        if cin != cout:
            conv(f"{key}.conv_shortcut", cin, cout, k=1)

    boc = VAE["block_out_channels"]
    rev = list(reversed(boc))
    ch = rev[0]
    conv("decoder.conv_in", 16, ch)
    resnet("decoder.mid_block.resnets.0", ch, ch)
    a = "decoder.mid_block.attentions.0"
    norm(f"{a}.group_norm", ch)
    for nm in ("to_q", "to_k", "to_v", "to_out.0"):
        _linear(t, rng, f"{a}.{nm}", ch, ch)
    resnet("decoder.mid_block.resnets.1", ch, ch)
    prev = ch
    for i, c in enumerate(rev):
        for j in range(VAE["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", prev, c)
            prev = c
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c)
    norm("decoder.conv_norm_out", boc[0])
    conv("decoder.conv_out", boc[0], 3)
    return t


SANA = dict(dim=512, hidden=1280, layers=2, heads=16, cross_heads=4, caption=1152, rank=16)
SANA_ODD = dict(dim=224, hidden=560, layers=2, heads=7, cross_heads=2, caption=96, rank=16)  # head dim 112


def _pad_to(x, m):
    return x + (-x) % m


def _sana_svdq(t, rng, key, k, n, rank, bias=True):
    """A v1 GEMM_W4A4 module of logical (K, N), stored at K padded to 256
    and N to 128 (nunchaku pads to 128; at SANA 1.6B's widths the two
    agree): zero codes, low-rank factors and bias outside the logical
    block."""
    kp, np_ = _pad_to(k, 256), _pad_to(n, 128)
    vals = np.zeros((np_, kp), np.int8)
    vals[:n, :k] = rng.integers(-8, 8, (n, k))
    ws = (rng.random((kp // 64, np_)) * 0.01 + 0.001).astype(np.float32)
    smooth = np.ones(kp, np.float32)
    smooth[:k] = rng.random(k) + 0.5
    ld, lu = np.zeros((rank, kp), np.float32), np.zeros((np_, rank), np.float32)
    ld[:, :k] = rng.standard_normal((rank, k)) * 0.02
    lu[:n] = rng.standard_normal((n, rank)) * 0.02
    t[f"{key}.qweight"] = NF.pack_weight_int4(vals)
    t[f"{key}.wscales"] = NF.pack_scale_ref(ws).astype(BF16)
    t[f"{key}.smooth"] = smooth.astype(BF16)
    t[f"{key}.lora_down"] = NF.pack_lowrank_weight_ref(ld, down=True).astype(BF16)
    t[f"{key}.lora_up"] = NF.pack_lowrank_weight_ref(lu, down=False).astype(BF16)
    if bias:
        b = np.zeros(np_, np.float32)
        b[:n] = rng.standard_normal(n) * 0.01
        t[f"{key}.bias"] = b.astype(BF16)


def sana_checkpoint(path, dims=None, pag_layers=(1,), seed=0):
    """A SANA checkpoint in the v1 schema (the layout of the JAX package's
    ``tests/test_sana.py``): ``SANA`` (whole widths, as that test) by
    default, ``SANA_ODD`` for odd widths; int4, PAG on ``pag_layers``."""
    d = dict(SANA if dims is None else dims)
    dim, hid, rank = d["dim"], d["hidden"], d["rank"]
    rng = np.random.default_rng(seed)
    t = {}
    for i in range(d["layers"]):
        p = f"transformer_blocks.{i}"
        _sana_svdq(t, rng, f"{p}.attn.qkv_proj", dim, 3 * dim, rank, bias=False)
        _sana_svdq(t, rng, f"{p}.attn.out_proj", dim, dim, rank, bias=False)
        if i in pag_layers:
            _sana_svdq(t, rng, f"{p}.attn.pag_to_v", dim, dim, rank, bias=False)
        _sana_svdq(t, rng, f"{p}.cross_attn.q_linear", dim, dim, rank)
        _linear(t, rng, f"{p}.cross_attn.kv_linear", dim, 2 * dim)
        _sana_svdq(t, rng, f"{p}.cross_attn.out_proj", dim, dim, rank)
        _sana_svdq(t, rng, f"{p}.ff.inverted_conv", dim, 2 * hid, rank)
        t[f"{p}.ff.depth_conv.weight"] = (rng.standard_normal((2 * hid, 1, 3, 3)) * 0.3).astype(BF16)
        t[f"{p}.ff.depth_conv.bias"] = (rng.standard_normal(2 * hid) * 0.01).astype(BF16)
        _sana_svdq(t, rng, f"{p}.ff.point_conv", hid, dim, rank, bias=False)
        t[f"{p}.scale_shift_table"] = (rng.standard_normal((6, dim)) * 0.1).astype(np.float32)
    t["patch_embed.proj.weight"] = (rng.standard_normal((dim, 32, 1, 1)) / np.sqrt(32)).astype(BF16)
    t["patch_embed.proj.bias"] = (rng.standard_normal(dim) * 0.01).astype(BF16)
    te = "adaln_single.emb.timestep_embedder"
    for name, k, n in (("caption_projection.linear_1", d["caption"], dim), ("caption_projection.linear_2", dim, dim),
                       (f"{te}.linear_1", 256, dim), (f"{te}.linear_2", dim, dim), ("adaln_single.linear", dim, 6 * dim),
                       ("proj_out", dim, 32)):
        _linear(t, rng, name, k, n)
    t["scale_shift_table"] = (rng.standard_normal((2, dim)) * 0.1).astype(np.float32)
    config = dict(num_layers=d["layers"], num_attention_heads=d["heads"], attention_head_dim=32,
                  num_cross_attention_heads=d["cross_heads"], cross_attention_head_dim=dim // d["cross_heads"],
                  caption_channels=d["caption"], in_channels=32, out_channels=32, expand_ratio=hid / dim)
    meta = _meta(config, "int4", rank)
    save_safetensors(path, t, meta)
    return path


ZIMAGE = dict(dim=256, heads=2, layers=2, refiners=1, cap=256, ffn=512, t_dim=1024, rank=16)


def zimage_checkpoint(path, precision="int4", skip_refiners=False, seed=0):
    """A Z-Image checkpoint in the v2 schema (the layout of the JAX package's
    ``tests/test_zimage.py`` at ``ZIMAGE``'s dims: 2 heads of 128, the
    timestep embedder and the adaLN linears 1024 wide whatever the dim, as
    that file has them); int4 or nvfp4, the refiners' linears 16-bit under
    ``skip_refiners``. The adaLN weights are drawn at a quarter of the plain
    weights' scale (small modulation, as above)."""
    d = ZIMAGE
    dim, ffn, rank, td = d["dim"], d["ffn"], d["rank"], d["t_dim"]
    rng = np.random.default_rng(seed)
    t = {}

    def block(p, modulated, quantized):
        for name, k, n in (("attention.to_qkv", dim, 3 * dim), ("attention.to_out.0", dim, dim),
                           ("feed_forward.net.0.proj", dim, 2 * ffn), ("feed_forward.net.2", ffn, dim)):
            if quantized:
                _svdq(t, rng, f"{p}.{name}", k, n, rank, precision, v2=True)
            else:
                _linear(t, rng, f"{p}.{name}", k, n)
        for nm in ("norm_q", "norm_k"):
            _norm(t, rng, f"{p}.attention.{nm}.weight", HEAD_DIM)
        for nm in ("attention_norm1", "attention_norm2", "ffn_norm1", "ffn_norm2"):
            _norm(t, rng, f"{p}.{nm}.weight", dim)
        if modulated:
            t[f"{p}.adaLN_modulation.1.weight"] = (rng.standard_normal((4 * dim, td)) * 0.25 / np.sqrt(td)).astype(BF16)
            t[f"{p}.adaLN_modulation.1.bias"] = (rng.standard_normal(4 * dim) * 0.02).astype(BF16)

    for i in range(d["layers"]):
        block(f"layers.{i}", True, True)
    for i in range(d["refiners"]):
        block(f"noise_refiner.{i}", True, not skip_refiners)
        block(f"context_refiner.{i}", False, not skip_refiners)
    for name, k, n in (("x_embedder", 64, dim), ("t_embedder.mlp.0", 256, td), ("t_embedder.mlp.2", td, td),
                       ("cap_embedder.1", d["cap"], dim), ("final_layer.linear", dim, 64)):
        _linear(t, rng, name, k, n)
    t["final_layer.adaLN_modulation.1.weight"] = (rng.standard_normal((dim, td)) * 0.25 / np.sqrt(td)).astype(BF16)
    t["final_layer.adaLN_modulation.1.bias"] = (rng.standard_normal(dim) * 0.02).astype(BF16)
    _norm(t, rng, "cap_embedder.0.weight", d["cap"])
    _norm(t, rng, "norm_out.weight", dim)
    config = dict(dim=dim, num_layers=d["layers"], num_refiner_layers=d["refiners"], num_attention_heads=d["heads"],
                  in_channels=16, patch_size=2, cap_feat_dim=d["cap"], axes_dims_rope=[32, 48, 48], ffn_inner=ffn)
    meta = _meta(config, precision, rank)
    if skip_refiners:
        qcfg = json.loads(meta["quantization_config"])
        meta["quantization_config"] = json.dumps({**qcfg, "skip_refiners": True})
    save_safetensors(path, t, meta)
    return path


# ---------------------------------------------------------------------------
# comparing a port model with its JAX counterpart
# ---------------------------------------------------------------------------

STACKS = ("transformer_blocks", "single_transformer_blocks", "blocks")



def _jax_name(name):
    """Port name -> (JAX stacked name, layer): "blocks.3.attn.x" -> ("blocks.attn.x", 3)."""
    parts = name.split(".")
    if parts[0] in STACKS and len(parts) > 1 and parts[1].isdigit():
        return ".".join([parts[0]] + parts[2:]), int(parts[1])
    return name, None


def _bytes_equal(t: torch.Tensor, a: np.ndarray, name):
    a = np.asarray(a)
    assert str(t.dtype).removeprefix("torch.") == a.dtype.name and tuple(t.shape) == a.shape, (
        name, t.dtype, a.dtype, tuple(t.shape), a.shape)
    np.testing.assert_array_equal(t.contiguous().reshape(-1).view(torch.uint8).numpy(),
                                  np.ascontiguousarray(a).reshape(-1).view(np.uint8), err_msg=name)


def assert_same_as_jax(tm, jm):
    """Every buffer of the port's model equals its JAX counterpart's leaf
    (the stacked leaf's layer) bit for bit, no leaf left over; the static
    attributes of every quantized linear and AdaLN norm agree."""
    jp = {k: np.asarray(v) for k, v in jm.named_parameters()}
    seen = set()
    for name, t in tm.named_buffers():
        jn, layer = _jax_name(name)
        _bytes_equal(t, jp[jn] if layer is None else jp[jn][layer], name)
        seen.add(jn)
    assert seen == set(jp)
    for name, mod in tm.named_modules():
        jmod = functools.reduce(getattr, _jax_name(name)[0].split("."), jm) if name else jm
        if isinstance(mod, SVDQW4A4Linear):
            assert (mod.precision, mod.act_unsigned, mod.wcodes) == (jmod.precision, jmod.act_unsigned, jmod.wcodes), name
        if isinstance(mod, (AdaLayerNormZero, AdaLayerNormZeroSingle)):
            assert mod.scale_shift == jmod.scale_shift, name


def flux_inputs():
    rng = np.random.default_rng(70)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    s_img, s_txt = 256, 64
    ids = np.zeros((s_img, 3), np.int32)
    ids[:, 1] = np.arange(s_img) // 16
    ids[:, 2] = np.arange(s_img) % 16
    return (bf(rng.standard_normal((1, s_img, 64))), bf(rng.standard_normal((1, s_txt, FLUX["joint"]))),
            bf(rng.standard_normal((1, FLUX["pooled"]))), np.array([0.5], np.float32), ids,
            np.zeros((s_txt, 3), np.int32), np.array([3.5], np.float32))
