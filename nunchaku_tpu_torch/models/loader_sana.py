"""Load nunchaku SANA checkpoints (v1 key schema of the C++ module registry).

Counterpart of ``nunchaku_tpu/models/transformers/loader_sana.py``. Per block
``transformer_blocks.{i}``: ``attn.qkv_proj``, ``attn.out_proj`` and, on PAG
layers, ``attn.pag_to_v``; ``cross_attn.q_linear`` and ``cross_attn.out_proj``
(GEMM_W4A4), ``cross_attn.kv_linear`` (16-bit); ``ff.inverted_conv`` and
``ff.point_conv`` (GEMM_W4A4), ``ff.depth_conv`` (16-bit depthwise);
``scale_shift_table`` (6, dim). The unquantized diffusers part:
``patch_embed.proj`` (a 1x1 convolution), ``caption_projection.linear_1/2``
(a tanh-GELU MLP), ``adaln_single.emb.timestep_embedder.linear_1/2``,
``adaln_single.linear``, the model's ``scale_shift_table`` (2, dim) and
``proj_out``.

The GLU's channel order is the half-split [value | gate] of the JAX loader
(the reference kernel's interleaved pairs would need a permutation that no
real file has pinned yet; the JAX loader's note). A PAG checkpoint gives
the blocks without ``pag_to_v`` zero clones of the first real one and sets
``cfg.pag_layers`` to the real ones (JAX :131-147).

Odd widths. The file's MMA layouts take N in multiples of 128 and K of 64,
so SANA 1.6B's 2240 / 6720 / 11200 are stored zero-padded (2304 / 6784 /
11264; K 2240 -> 2304, 5600 -> 5632). Each linear takes the config's
logical dims (the JAX loader keeps the padded ones as logical: its linear
attention would then split a 6784-wide qkv into thirds). The port's kernels
take K in multiples of 256, which SANA 1.6B's padded widths are.
"""

from __future__ import annotations

import copy
import dataclasses
import json

import torch
from torch import nn

from ..ops.reference import gelu_jax
from ..utils.safetensors import SafeTensors
from .embeddings import MLPEmbedder
from .linear import Linear, SVDQW4A4Linear, padded_dims
from .loader import _check_precision, _decode_linear, _decode_svdq, _Reader, checkpoint_precision
from .transformer_sana import (SanaConfig, SanaCrossAttention, SanaGLUMBConv, SanaLinearAttention,
                               SanaTransformer2DModel, SanaTransformerBlock)


class CaptionProjection(nn.Module):
    """PixArtAlphaTextProjection: ``fc2(gelu_tanh(fc1(x)))``."""

    def __init__(self, fc1: Linear, fc2: Linear):
        super().__init__()
        self.fc1 = fc1
        self.fc2 = fc2

    def forward(self, x):
        return self.fc2(gelu_jax(self.fc1(x).float()).to(torch.bfloat16))


def _conv1x1_as_linear(r: _Reader, name: str) -> Linear:
    w = r.f32(f"{name}.weight")  # (O, I, kh, kw)
    if w.shape[-2:] != (1, 1):
        raise ValueError(f"{name}: only a 1x1 patch embedding is supported, got {tuple(w.shape)}")
    bias = r.bf16(f"{name}.bias") if r.has(f"{name}.bias") else None
    return Linear(w[:, :, 0, 0].t().contiguous().to(torch.bfloat16), bias)


def _logical(lin: SVDQW4A4Linear, k: int, n: int) -> SVDQW4A4Linear:
    """The config's logical (K, N) on a linear whose buffers the file padded."""
    if (lin.in_features, lin.out_features) not in ((k, n), padded_dims(k, n)):
        raise ValueError(f"buffers ({lin.in_features}, {lin.out_features}) do not hold a ({k}, {n}) linear; the "
                         f"kernels take K padded to 256 and N to 128")
    lin.logical_in, lin.logical_out = k, n
    return lin


@torch.no_grad()
def load_sana_transformer(path, precision: str | None = None, device="cuda") -> SanaTransformer2DModel:
    """A SanaTransformer2DModel from a nunchaku SANA file. ``precision``:
    None keeps the checkpoint's int4 / nvfp4, ``"int8"`` and ``"w4a8"``
    convert at load (``"w4a8"`` from an nvfp4 file loads int8, as in JAX).
    ``device``: where the weights are decoded and kept."""
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
    cfg = SanaConfig(
        num_layers=config.get("num_layers", 20),
        num_attention_heads=config.get("num_attention_heads", 70),
        attention_head_dim=config.get("attention_head_dim", 32),
        num_cross_attention_heads=config.get("num_cross_attention_heads", 20),
        cross_attention_head_dim=config.get("cross_attention_head_dim", 112),
        caption_channels=config.get("caption_channels", 2304),
        in_channels=config.get("in_channels", 32),
        out_channels=config.get("out_channels", 32),
        expand_ratio=config.get("expand_ratio", 2.5),
        rank=qcfg.get("rank", 32),
        precision=out_precision,
    )
    dim, hid = cfg.dim, cfg.ff_hidden
    root = _Reader(st, "", device)

    blocks = []
    for i in range(cfg.num_layers):
        b = root.sub(f"transformer_blocks.{i}")

        def svdq(name, k, n):
            return _logical(_decode_svdq(b.sub(name), precision=ckpt_precision, out_precision=out_precision), k, n)

        attn = SanaLinearAttention(svdq("attn.qkv_proj", dim, 3 * dim), svdq("attn.out_proj", dim, dim),
                                   svdq("attn.pag_to_v", dim, dim) if b.has("attn.pag_to_v.qweight") else None)
        cross = SanaCrossAttention(svdq("cross_attn.q_linear", dim, dim), _decode_linear(b, "cross_attn.kv_linear"),
                                   svdq("cross_attn.out_proj", dim, dim), heads=cfg.num_cross_attention_heads,
                                   head_dim=dim // cfg.num_cross_attention_heads)
        dw = b.bf16("ff.depth_conv.weight")  # (2 * hidden, 1, 3, 3)
        db = (b.bf16("ff.depth_conv.bias") if b.has("ff.depth_conv.bias")
              else torch.zeros((dw.shape[0],), dtype=torch.bfloat16, device=dw.device))
        ff = SanaGLUMBConv(svdq("ff.inverted_conv", dim, 2 * hid), dw, db, svdq("ff.point_conv", hid, dim))
        blocks.append(SanaTransformerBlock(b.f32("scale_shift_table"), attn, cross, ff))

    pag = [i for i, blk in enumerate(blocks) if blk.attn.pag_to_v is not None]
    if pag:
        cfg = dataclasses.replace(cfg, pag_layers=tuple(pag))
        template = blocks[pag[0]].attn.pag_to_v
        for blk in blocks:
            if blk.attn.pag_to_v is None:
                blk.attn.pag_to_v = copy.deepcopy(template)
                for buf in blk.attn.pag_to_v.buffers():
                    buf.zero_()

    if root.has("caption_projection.linear_1.weight"):
        caption = CaptionProjection(_decode_linear(root, "caption_projection.linear_1"),
                                    _decode_linear(root, "caption_projection.linear_2"))
    else:
        caption = _decode_linear(root, "caption_projection")
    patch = (_conv1x1_as_linear(root, "patch_embed.proj") if root.has("patch_embed.proj.weight")
             else _decode_linear(root, "patch_embed"))
    te = "adaln_single.emb.timestep_embedder"
    return SanaTransformer2DModel(
        cfg, patch, caption,
        MLPEmbedder(_decode_linear(root, f"{te}.linear_1"), _decode_linear(root, f"{te}.linear_2")),
        _decode_linear(root, "adaln_single.linear"), blocks, root.f32("scale_shift_table"),
        _decode_linear(root, "proj_out"))
