"""Load nunchaku Z-Image checkpoints (v2 / Python-backend key schema).

Counterpart of ``nunchaku_tpu/models/transformers/loader_zimage.py``
(``_decode_block`` :122, ``load_zimage_transformer`` :152; its
``decode_svdq_v2`` :51 is the port's Qwen-Image one). Key map, from the
reference's patching:

  layers.{i}.attention.{to_qkv,to_out.0}.*      -> quantized linears
  layers.{i}.attention.{norm_q,norm_k}.weight   -> per-head RMSNorm
  layers.{i}.feed_forward.net.{0.proj,2}.*      -> SwiGLU w1||w3, w2
  layers.{i}.{attention_norm1,attention_norm2,ffn_norm1,ffn_norm2}.weight
  layers.{i}.adaLN_modulation.1.{weight,bias}   -> 16-bit modulation
  noise_refiner.{i}.* / context_refiner.{i}.*   -> same schema (the context
      refiner unmodulated; 16-bit linears when quantization_config sets
      skip_refiners)
  x_embedder.* t_embedder.mlp.{0,2}.* cap_embedder.{0,1}.*
  norm_out.weight final_layer.{linear, adaLN_modulation.1}.*

Dims come from the file's ``config`` metadata (``ZImageConfig``'s defaults
are placeholders), rank and precision from ``quantization_config``; the
modulation and timestep linears take their shapes from the file.
``precision="w4a8"`` from an nvfp4 file loads **int8** (JAX :156-158),
unlike the FLUX loader's nvfp4-a8. Each stack's blocks are decoded on
``device`` (the card unless the caller asks for the CPU) and stacked into
one module with a leading layer axis (:func:`~.linear.stack_modules`), the
JAX layout.
"""

from __future__ import annotations

import json

import torch

from ..utils.safetensors import SafeTensors
from .linear import stack_modules
from .loader import _check_precision, _decode_linear, _Reader, checkpoint_precision
from .loader_qwenimage import decode_svdq_v2
from .transformer_zimage import (ZImageAttention, ZImageConfig, ZImageFeedForward, ZImageTransformer2DModel,
                                 ZImageTransformerBlock)


def _decode_block(b: _Reader, cfg: ZImageConfig, *, precision, out_precision, modulated: bool,
                  quantized: bool) -> ZImageTransformerBlock:
    def lin(name):
        if quantized:
            return decode_svdq_v2(b.sub(name), precision=precision, out_precision=out_precision)
        return _decode_linear(b, name)

    attn = ZImageAttention(lin("attention.to_qkv"), b.bf16("attention.norm_q.weight"),
                           b.bf16("attention.norm_k.weight"), lin("attention.to_out.0"),
                           heads=cfg.num_attention_heads, head_dim=cfg.head_dim)
    ff = ZImageFeedForward(lin("feed_forward.net.0.proj"), lin("feed_forward.net.2"))
    return ZImageTransformerBlock(
        attn, ff, b.bf16("attention_norm1.weight"), b.bf16("attention_norm2.weight"), b.bf16("ffn_norm1.weight"),
        b.bf16("ffn_norm2.weight"), _decode_linear(b, "adaLN_modulation.1") if modulated else None,
        eps=cfg.norm_eps)


@torch.no_grad()
def load_zimage_transformer(path, precision: str | None = None, device="cuda") -> ZImageTransformer2DModel:
    """A ZImageTransformer2DModel from a nunchaku v2 file. ``precision``: None
    keeps the file's int4 / nvfp4; ``"int8"`` and ``"w4a8"`` convert at load
    (``"w4a8"`` from an nvfp4 file loads int8). ``device``: where the weights
    are decoded and kept."""
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
    skip_refiners = bool(qcfg.get("skip_refiners", False))
    cfg = ZImageConfig(
        dim=config.get("dim", 1024),
        num_layers=config.get("num_layers", 4),
        num_refiner_layers=config.get("num_refiner_layers", 2),
        num_attention_heads=config.get("num_attention_heads", 8),
        in_channels=config.get("in_channels", 16),
        patch_size=config.get("patch_size", 2),
        cap_feat_dim=config.get("cap_feat_dim", 1024),
        norm_eps=config.get("norm_eps", 1e-5),
        axes_dims_rope=tuple(config.get("axes_dims_rope", (32, 48, 48))),
        rank=qcfg.get("rank", 32),
        precision=out_precision,
        ffn_inner=config.get("ffn_inner"),
    )
    root = _Reader(st, "", device)
    kw = dict(precision=ckpt_precision, out_precision=out_precision)

    def stack(name, n, modulated, quantized):
        return stack_modules([_decode_block(root.sub(f"{name}.{i}"), cfg, **kw, modulated=modulated,
                                            quantized=quantized) for i in range(n)])

    layers = stack("layers", cfg.num_layers, True, True)
    noise_ref = stack("noise_refiner", cfg.num_refiner_layers, True, not skip_refiners)
    ctx_ref = stack("context_refiner", cfg.num_refiner_layers, False, not skip_refiners)
    return ZImageTransformer2DModel(
        cfg, _decode_linear(root, "x_embedder"), _decode_linear(root, "t_embedder.mlp.0"),
        _decode_linear(root, "t_embedder.mlp.2"), root.bf16("cap_embedder.0.weight"),
        _decode_linear(root, "cap_embedder.1"), noise_ref, ctx_ref, layers, root.bf16("norm_out.weight"),
        _decode_linear(root, "final_layer.linear"), _decode_linear(root, "final_layer.adaLN_modulation.1"))
