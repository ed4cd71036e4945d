"""Load nunchaku Qwen-Image checkpoints (v2 / Python-backend key schema).

Counterpart of ``nunchaku_tpu/models/transformers/loader_qwenimage.py`` and of
``decode_svdq_v2`` (``loader_zimage.py:51``). Key map, from the reference's
patching (nunchaku/models/transformers/transformer_qwenimage.py: 159-310
NunchakuQwenImageTransformerBlock, :64-95 NunchakuQwenAttention):

  transformer_blocks.{i}.attn.{to_qkv,to_out.0,add_qkv_proj,to_add_out}.*
      -> SVDQ v2 tensors: qweight / wscales in the v1 MMA layouts, plain
         ``proj_down`` (K, R) and ``proj_up`` (N, R), ``smooth_factor``
  transformer_blocks.{i}.attn.{norm_q,norm_k,norm_added_q,norm_added_k}.weight
  transformer_blocks.{i}.{img_mod,txt_mod}.1.*   -> AWQ W4A16 modulation
      (6-way interleaved columns -> part-major, as FLUX v1; the +1 scale
      shift is NOT folded in v2 checkpoints -> scale_shift = 1)
  transformer_blocks.{i}.{img_mlp,txt_mlp}.net.{0.proj,2}.*  -> GELU MLP
  img_in / txt_in / txt_norm / time_text_embed.timestep_embedder.linear_1,2
  norm_out.linear / proj_out

The rank comes from ``quantization_config`` (nunchaku publishes rank-32 and
rank-128 checkpoints); ``precision="w4a8"`` from an nvfp4 checkpoint loads
int8, as in the JAX loader. The Qwen block is the FLUX dual-stream block;
the blocks load into one stack, as in the JAX loader.
"""

from __future__ import annotations

import json

import torch

from ..utils.safetensors import SafeTensors
from .attention import FeedForward, FluxAttention
from .embeddings import MLPEmbedder
from .linear import SVDQW4A4Linear, build_stacked
from .loader import (_check_precision, _decode_awq, _decode_linear, _Reader, checkpoint_precision, make_svdq,
                     svdq_weight_scales)
from .normalization import AdaLayerNormContinuous, AdaLayerNormZero
from .transformer_flux import FluxTransformerBlock
from .transformer_qwenimage import QwenImageConfig, QwenImageTransformer2DModel


def decode_svdq_v2(r: _Reader, *, precision: str, out_precision: str) -> SVDQW4A4Linear:
    """A v2-schema SVDQW4A4Linear (kernel-layout qweight / wscales, plain
    low-rank factors) at ``out_precision``. ``w4a8`` takes an int4 source
    (the Qwen loader sends nvfp4 to int8)."""
    if out_precision == "w4a8" and precision != "int4":
        raise ValueError("decode_svdq_v2: w4a8 from an nvfp4 source is not a v2 load mode (int8 is)")
    vals, ws = svdq_weight_scales(r, precision)
    smooth = r.f32("smooth_factor" if r.has("smooth_factor") else "smooth")
    pd = r.f32("proj_down")  # (K, R) plain
    pu = r.f32("proj_up").t()  # (N, R) -> (R, N)
    bias = r.f32("bias") if r.has("bias") else None
    return make_svdq(vals, ws, smooth, pd, pu, bias, precision=precision, out_precision=out_precision)


@torch.no_grad()
def load_qwenimage_transformer(path, precision: str | None = None, device="cuda") -> QwenImageTransformer2DModel:
    """A QwenImageTransformer2DModel from a nunchaku v2 checkpoint; rank from
    its ``quantization_config``; weights decoded and kept on ``device``."""
    _check_precision(precision)
    st = SafeTensors(path)
    config = json.loads(st.metadata.get("config", "{}"))
    qcfg = json.loads(st.metadata.get("quantization_config", "{}"))
    ckpt_precision = checkpoint_precision(qcfg)
    out_precision = precision or ckpt_precision
    if out_precision == "w4a8" and ckpt_precision != "int4":
        out_precision = "int8"
    if out_precision in ("int4", "nvfp4") and out_precision != ckpt_precision:
        raise ValueError(f"a {ckpt_precision} checkpoint loads at {ckpt_precision}, int8 or w4a8, not {out_precision}")
    cfg = QwenImageConfig(
        num_layers=config.get("num_layers", 60),
        attention_head_dim=config.get("attention_head_dim", 128),
        num_attention_heads=config.get("num_attention_heads", 24),
        joint_attention_dim=config.get("joint_attention_dim", 3584),
        in_channels=config.get("in_channels", 64),
        out_channels=config.get("out_channels", 16),
        axes_dims_rope=tuple(config.get("axes_dims_rope", (16, 56, 56))),
        rank=qcfg.get("rank", 32),
        precision=out_precision,
    )
    root = _Reader(st, "", device)
    kw = dict(precision=ckpt_precision, out_precision=out_precision)
    unsigned = ckpt_precision == "int4"  # fc2 bias carries the post-GELU shift's compensation

    def block(i):
        b = root.sub(f"transformer_blocks.{i}")

        def svdq(name, act_unsigned=False):
            lin = decode_svdq_v2(b.sub(name), **kw)
            lin.act_unsigned = act_unsigned
            return lin

        attn = FluxAttention(
            svdq("attn.to_qkv"), b.bf16("attn.norm_q.weight"), b.bf16("attn.norm_k.weight"),
            to_out=svdq("attn.to_out.0"), add_qkv_proj=svdq("attn.add_qkv_proj"),
            norm_added_q=b.bf16("attn.norm_added_q.weight"), norm_added_k=b.bf16("attn.norm_added_k.weight"),
            to_add_out=svdq("attn.to_add_out"), head_dim=cfg.attention_head_dim)
        return FluxTransformerBlock(
            AdaLayerNormZero(_decode_awq(b.sub("img_mod.1"), parts=6, out_precision=out_precision), scale_shift=1.0),
            AdaLayerNormZero(_decode_awq(b.sub("txt_mod.1"), parts=6, out_precision=out_precision), scale_shift=1.0),
            attn,
            FeedForward(svdq("img_mlp.net.0.proj"), svdq("img_mlp.net.2", unsigned)),
            FeedForward(svdq("txt_mlp.net.0.proj"), svdq("txt_mlp.net.2", unsigned)))

    blocks = build_stacked(block, cfg.num_layers)  # each block decoded and copied into the stack in turn

    te = "time_text_embed.timestep_embedder"
    return QwenImageTransformer2DModel(
        cfg, _decode_linear(root, "img_in"), _decode_linear(root, "txt_in"),
        MLPEmbedder(_decode_linear(root, f"{te}.linear_1"), _decode_linear(root, f"{te}.linear_2")),
        blocks, AdaLayerNormContinuous(_decode_linear(root, "norm_out.linear")), _decode_linear(root, "proj_out"),
        txt_norm=root.bf16("txt_norm.weight") if root.has("txt_norm.weight") else None)
